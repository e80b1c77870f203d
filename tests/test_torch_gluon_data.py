"""Port parity: `mxnet_tpu_torch.gluon.data` (datasets, samplers,
batchify, the `DataLoader`, `vision`) against ``mxnet_tpu.gluon.data`` on
the CPU, the port under ``with tm.cpu():``.

Data is compared exactly: the samplers' permutations, batchify outputs,
every `DataLoader` batch for shuffle on and off and each ``last_batch``,
the MNIST fixture against its golden file, the seeded synthetic MNIST /
CIFAR stand-ins.  A 2-worker process pool and a thread pool give the
serial loader's batches; a worker's error reaches the caller and a stuck
worker times out.  Only the float transforms (`ToTensor`, `Normalize`,
`Rotate`) carry a tolerance, 1e-6 in float32.  The image codec's parts
raise naming ROADMAP.md A11.
"""
import gc
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jgd
from mxnet_tpu.test_utils import environment
import mxnet_tpu_torch as tm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tgd

import torch_data_common as common

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_ROOT = os.path.join(REPO, "tests", "fixtures", "mnist")


def _np(x):
    """A batch (arrays, tuples, lists) as NumPy, for either package."""
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def _equal(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# -- samplers and batchify ---------------------------------------------------

@pytest.mark.parametrize("n,seed", [(1, 0), (23, 0), (100, 7)])
def test_random_sampler_draws_jax_permutations(n, seed):
    t, j = tgd.RandomSampler(n, seed=seed), jgd.RandomSampler(n, seed=seed)
    for _ in range(3):                      # the epoch advances each pass
        assert list(t) == list(j)
    t.set_epoch(1)
    j.set_epoch(1)
    assert list(t) == list(j)
    assert sorted(t) == list(range(n))


def test_random_sampler_seed_reads_the_environment(monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_SEED", "11")
    assert list(tgd.RandomSampler(9)) == list(jgd.RandomSampler(9))


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_and_index_samplers_match_jax(last_batch):
    out = []
    for pkg in (tgd, jgd):
        bs = pkg.BatchSampler(pkg.SequentialSampler(11, start=2), 4,
                              last_batch)
        got = [list(bs), list(bs), len(bs)]
        got.append(list(pkg.IntervalSampler(10, 3)))
        got.append(list(pkg.IntervalSampler(10, 3, rollover=False)))
        got.append(list(pkg.FilterSampler(lambda x: x % 3 == 1,
                                          list(range(12)))))
        out.append(got)
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        list(tgd.BatchSampler(tgd.SequentialSampler(5), 2, "bogus"))


def test_batchify_functions_match_jax():
    rng = np.random.RandomState(0)
    ragged = [rng.randn(k, 3).astype(np.float32) for k in (2, 5, 1)]
    labels = [np.int32(i) for i in range(3)]
    with tm.cpu():
        t = [tgd.batchify.Stack()([r[:1] for r in ragged]),
             tgd.batchify.Pad(axis=0, val=-1)(ragged),
             tgd.batchify.Pad(axis=0, val=0, dtype="int32")(ragged),
             tgd.batchify.Group(tgd.batchify.Pad(), tgd.batchify.Stack())(
                 list(zip(ragged, labels))),
             tgd.default_batchify_fn([(r[:1], i) for r, i in
                                      zip(ragged, labels)]),
             tgd.default_batchify_fn([tm.np.array(r[:1]) for r in ragged])]
    j = [jgd.batchify.Stack()([r[:1] for r in ragged]),
         jgd.batchify.Pad(axis=0, val=-1)(ragged),
         jgd.batchify.Pad(axis=0, val=0, dtype="int32")(ragged),
         jgd.batchify.Group(jgd.batchify.Pad(), jgd.batchify.Stack())(
             list(zip(ragged, labels))),
         jgd.default_batchify_fn([(r[:1], i) for r, i in
                                  zip(ragged, labels)]),
         jgd.default_batchify_fn([jmx.np.array(r[:1]) for r in ragged])]
    for a, b in zip(t, j):
        _equal(a, b)
    assert t[0].device == tm.cpu()


# -- datasets ----------------------------------------------------------------

def test_dataset_operations_match_jax():
    base = [np.float32(i) * np.ones(2, np.float32) for i in range(10)]
    labels = list(range(10))
    got = []
    for pkg in (tgd, jgd):
        ds = pkg.ArrayDataset(base, labels)
        out = [ds[3], len(ds),
               [ds.transform(lambda x, y: (x * 2, y + 1))[i] for i in (0, 9)],
               ds.transform(lambda x, y: y, lazy=False)[4],
               ds.transform_first(lambda x: x + 1)[2],
               [s for s in ds.filter(lambda s: s[1] % 4 == 0)],
               [ds.shard(3, k)[0] for k in range(3)],
               len(ds.shard(3, 2)), len(ds.take(4)),
               ds.sample(pkg.SequentialSampler(3, start=5))[1],
               pkg.SimpleDataset(list("abc"))[1]]
        got.append(out)
    assert repr(got[0]) == repr(got[1])
    with pytest.raises(MXNetError, match="same length"):
        tgd.ArrayDataset([1, 2], [1])


def test_record_file_dataset_reads_jax_records(tmp_path):
    import mxnet_tpu.recordio as jrec
    path = str(tmp_path / "r.rec")
    w = jrec.MXIndexedRecordIO(str(tmp_path / "r.idx"), path, "w")
    for k in range(5):
        w.write_idx(k, bytes([k]) * (k + 1))
    w.close()
    t, j = tgd.RecordFileDataset(path), jgd.RecordFileDataset(path)
    assert len(t) == len(j) == 5
    assert [t[i] for i in range(5)] == [j[i] for i in range(5)]


# -- the DataLoader ----------------------------------------------------------

def _array_dataset(pkg, n=23):
    rng = np.random.RandomState(3)
    x = rng.randn(n, 2, 3).astype(np.float32)
    y = rng.randint(0, 5, n).astype(np.int32)
    return pkg.ArrayDataset(x, y)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_batches_match_jax(shuffle, last_batch):
    with tm.cpu():
        t = tgd.DataLoader(_array_dataset(tgd), batch_size=5,
                           shuffle=shuffle, last_batch=last_batch)
        tb = [list(t), list(t)]             # two epochs (rollover carries)
    j = jgd.DataLoader(_array_dataset(jgd), batch_size=5, shuffle=shuffle,
                       last_batch=last_batch)
    jb = [list(j), list(j)]
    assert len(t) == len(j)
    for te, je in zip(tb, jb):
        assert len(te) == len(je)
        for a, b in zip(te, je):
            _equal(a, b)
    assert tb[0][0][0].device == tm.cpu()


def _mnist(pkg):
    with environment("MXTPU_SYNTHETIC_DATA", "0"):
        return pkg.vision.MNIST(root=MNIST_ROOT, train=True)


def test_worker_pools_give_the_serial_batches():
    """A 2-worker process pool and a 2-thread pool over the MNIST fixture
    with `ToTensor` (the transform crosses to the workers by pickle) give
    the serial loader's batches; the thread pool, built under
    ``tm.cpu()``, places on the CPU from its worker threads."""
    with tm.cpu():
        ds = _mnist(tgd).transform_first(tgd.vision.transforms.ToTensor())
        loader = tgd.DataLoader(ds, batch_size=8, shuffle=True)
        serial = [list(loader), list(loader)]       # two epochs
        for kw in (dict(num_workers=2), dict(num_workers=2,
                                             thread_pool=False)):
            pool = tgd.DataLoader(ds, batch_size=8, shuffle=True, **kw)
            for want in serial:                     # the same two epochs
                got = list(pool)
                assert len(got) == len(want) == 7
                for a, b in zip(got, want):
                    _equal(a, b)
                    assert a[0].device == tm.cpu()
            del pool
    jl = list(jgd.DataLoader(
        _mnist(jgd).transform_first(jgd.vision.transforms.ToTensor()),
        batch_size=8, shuffle=True))
    for a, b in zip(serial[0], jl):
        _equal(a, b)
    gc.collect()
    assert not [f for f in os.listdir("/dev/shm")
                if f.startswith("mxtpu_torch-")]      # no segment leaked


def test_worker_processes_stay_on_the_cpu():
    """A spawned worker is pinned to the CPU before it unpickles anything:
    arrays it builds with no device land on the CPU and CUDA is never
    initialised there — whatever device the parent's scope names."""
    with tm.cpu():
        dl = tgd.DataLoader(common.DeviceProbe(), batch_size=2,
                            num_workers=2, thread_pool=False)
        rows = np.concatenate([b[0].asnumpy() for b in dl])
        del dl
    assert rows[:, 0].all() and not rows[:, 1].any()
    assert os.getpid() not in rows[:, 2]


def test_a_worker_error_reaches_the_caller():
    with tm.cpu():
        for kw in (dict(num_workers=2), dict(num_workers=2,
                                             thread_pool=False)):
            dl = tgd.DataLoader(common.FailingDataset(), batch_size=4, **kw)
            with pytest.raises((MXNetError, ValueError), match="bad sample"):
                list(dl)
            del dl


def test_a_stuck_worker_times_out():
    with tm.cpu():
        dl = tgd.DataLoader(common.SlowDataset(delay=1.0), batch_size=2,
                            num_workers=1, timeout=0.2)
        with pytest.raises(MXNetError, match="timed out"):
            list(dl)


def test_pin_memory_keeps_the_values_on_the_cpu():
    with tm.cpu():
        a = list(tgd.DataLoader(common.SquaresDataset(), batch_size=6,
                                pin_memory=True))
        b = list(tgd.DataLoader(common.SquaresDataset(), batch_size=6))
    for x, y in zip(a, b):
        _equal(x, y)


# -- vision ------------------------------------------------------------------

def test_mnist_fixture_equals_its_golden_file():
    golden = np.load(os.path.join(MNIST_ROOT, "golden.npz"))
    with tm.cpu():
        ds = _mnist(tgd)
        assert len(ds) == 50
        imgs = np.stack([ds[i][0].asnumpy()[..., 0] for i in range(50)])
        labels = np.array([ds[i][1] for i in range(50)])
    np.testing.assert_array_equal(imgs, golden["imgs"])
    np.testing.assert_array_equal(labels, golden["labels"])
    with environment("MXTPU_SYNTHETIC_DATA", "0"):
        with pytest.raises(MXNetError, match="not found"):
            tgd.vision.MNIST(root=os.path.join(MNIST_ROOT, "none"))


@pytest.fixture(scope="module")
def jax_synthetic():
    """The JAX package's seeded stand-ins, made once for the module."""
    with environment("MXTPU_SYNTHETIC_DATA", "1"):
        return {name: getattr(jgd.vision, cls)(root="/nonexistent",
                                               train=train)
                for name, cls, train in _SYNTHETIC}


_SYNTHETIC = [("mnist_test", "MNIST", False),
              ("fashion_test", "FashionMNIST", False),
              ("cifar10_test", "CIFAR10", False),
              ("cifar100_test", "CIFAR100", False)]


@pytest.mark.parametrize("name,cls,train", _SYNTHETIC)
def test_synthetic_datasets_are_bit_equal_to_jax(jax_synthetic, name, cls,
                                                 train):
    j = jax_synthetic[name]
    with environment("MXTPU_SYNTHETIC_DATA", "1"), tm.cpu():
        t = getattr(tgd.vision, cls)(root="/nonexistent", train=train)
        assert len(t) == len(j)
        np.testing.assert_array_equal(t._data, j._data)
        np.testing.assert_array_equal(t._label, j._label)
        for i in (0, len(t) - 1):
            _equal(t[i], j[i])


@pytest.mark.parametrize("cls", ["ImageRecordDataset", "ImageFolderDataset",
                                 "ImageListDataset"])
def test_image_datasets_raise_naming_a11(cls):
    with pytest.raises(MXNetError, match="A11"):
        getattr(tgd.vision, cls)("anything")


# -- transforms --------------------------------------------------------------

def _image(dtype=np.float32, shape=(9, 13, 3), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 255).astype(dtype)


@pytest.mark.parametrize("case", ["to_tensor", "to_tensor_batch",
                                  "normalize", "normalize_batch", "cast",
                                  "rotate", "rotate_zoom_in",
                                  "rotate_zoom_out", "compose",
                                  "flip_lr", "flip_tb", "crop"])
def test_transforms_match_jax(case):
    def build(T):
        return {
            "to_tensor": (T.ToTensor(), _image(np.uint8)),
            "to_tensor_batch": (T.ToTensor(), _image(np.uint8,
                                                     (2, 5, 6, 3))),
            "normalize": (T.Normalize([0.5, 0.2, 0.1], [2.0, 0.5, 1.5]),
                          _image(shape=(3, 5, 7)) / 255),
            "normalize_batch": (T.Normalize(0.3, 0.7),
                                _image(shape=(2, 1, 5, 7)) / 255),
            "cast": (T.Cast("float16"), _image()),
            "rotate": (T.Rotate(33.0), _image()),
            "rotate_zoom_in": (T.Rotate(-71.5, zoom_in=True), _image()),
            "rotate_zoom_out": (T.Rotate(120.0, zoom_out=True), _image()),
            "compose": (T.Compose([T.ToTensor(), T.Normalize(0.5, 0.25)]),
                        _image(np.uint8)),
            "flip_lr": (T.RandomFlipLeftRight(p=1.0), _image()),
            "flip_tb": (T.RandomFlipTopBottom(p=1.0), _image()),
            "crop": (T.CropResize(2, 1, 5, 4), _image()),
        }[case]

    tt, x = build(tgd.vision.transforms)
    jt, _ = build(jgd.vision.transforms)
    with tm.cpu():
        got = tt(tm.np.array(x)).asnumpy()
    want = np.asarray(jt(jmx.np.array(x)).asnumpy())
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = max(1.0, float(np.abs(want.astype(np.float32)).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    if case.startswith("to_tensor"):
        np.testing.assert_array_equal(got, want)    # one division each


def test_random_transforms_draw_from_numpy_like_jax():
    T, J = tgd.vision.transforms, jgd.vision.transforms
    x = _image()
    out = []
    for pkg_t, arr in ((T, tm.np.array), (J, jmx.np.array)):
        np.random.seed(5)
        with tm.cpu():
            ts = [pkg_t.RandomRotation((-30, 30)),
                  pkg_t.RandomApply(pkg_t.RandomFlipLeftRight(0.5), p=0.5),
                  pkg_t.RandomFlipTopBottom(0.5)]
            out.append([np.asarray(t(arr(x)).asnumpy()) for t in ts
                        for _ in range(3)])
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * 255)  # 0-255


@pytest.mark.parametrize("name,args", [
    ("Resize", (8,)), ("CenterCrop", (4,)), ("RandomResizedCrop", (4,)),
    ("RandomBrightness", (0.1,)), ("RandomContrast", (0.1,)),
    ("RandomSaturation", (0.1,)), ("RandomHue", (0.1,)),
    ("RandomColorJitter", (0.1,)), ("RandomLighting", (0.1,)),
    ("RandomGray", ()), ("RandomCrop", (4,)),
    ("CropResize", (0, 0, 4, 4, (2, 2)))])
def test_image_transforms_raise_naming_a11(name, args):
    with pytest.raises(MXNetError, match="A11"):
        getattr(tgd.vision.transforms, name)(*args)


def test_a_transform_pickles_for_the_workers():
    t = tgd.vision.transforms.Compose([tgd.vision.transforms.ToTensor(),
                                       tgd.vision.transforms.Normalize(0.5,
                                                                       0.5)])
    t2 = pickle.loads(pickle.dumps(t))
    x = _image(np.uint8)
    with tm.cpu():
        _equal(t(tm.np.array(x)), t2(tm.np.array(x)))
