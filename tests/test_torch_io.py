"""Port parity: `mx.io` of `mxnet_tpu_torch` (MXNet's 1.x iterators)
against the JAX package's on the CPU.

`NDArrayIter` (every ``last_batch_handle``, shuffled by NumPy's global
generator so one ``np.random.seed`` gives one order in both packages,
dict and list inputs, ``reset``), `CSVIter` (the native parser and the
NumPy fallback), `LibSVMIter` (dense batches; a label file; an index out
of range raises), `ResizeIter`, `PrefetchingIter`, `MNISTIter` over
``tests/fixtures/mnist`` (shuffled, flat, sharded) and `ImageRecordIter`
over ``tests/fixtures/imgrec`` (PNG records, so both codecs are exact):
against its golden file and, with shuffling, random crops and mirrors
from one seed, against JAX's batches.  Records written by
``recordio.pack_img`` read back through `ImageRecordIter`.  Batches are
compared exactly (the same float32 arithmetic on the host, the same
gathers).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu.io as jio
import mxnet_tpu_torch as tm
import mxnet_tpu_torch.io as tio
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMGREC = os.path.join(REPO, "tests", "fixtures", "imgrec")
MNIST = os.path.join(REPO, "tests", "fixtures", "mnist")


def _batches(it, limit=50):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [lab.asnumpy() for lab in (b.label or [])], b.pad))
        if len(out) == limit:
            break
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert len(gd) == len(wd) and len(gl) == len(wl)
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


def _both(make, seed=None):
    """`make(io)`'s batches in each package (the port's under
    ``tm.cpu()``), NumPy's global generator seeded alike before each."""
    if seed is not None:
        np.random.seed(seed)
    want = _batches(make(jio))
    if seed is not None:
        np.random.seed(seed)
    with tm.cpu():
        got = _batches(make(tio))
    return got, want


_R = np.random.RandomState(9)
DATA = _R.uniform(-1, 1, (10, 3, 2)).astype(np.float32)
LABEL = _R.randint(0, 5, 10).astype(np.float32)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    got, want = _both(lambda io: io.NDArrayIter(
        DATA, LABEL, batch_size=4, shuffle=shuffle,
        last_batch_handle=handle), seed=21)
    _same(got, want)
    assert len(got) == (2 if handle == "discard" else 3)


def test_ndarray_iter_inputs_reset_and_descriptions():
    def make(io):
        return io.NDArrayIter({"a": DATA, "b": DATA[:, 0]},
                              [LABEL, LABEL * 2], batch_size=3,
                              shuffle=True)
    np.random.seed(4)
    jit = make(jio)
    np.random.seed(4)
    with tm.cpu():
        tit = make(tio)
        _same(_batches(tit), _batches(jit))
        np.random.seed(8)
        jit.reset()
        np.random.seed(8)
        tit.reset()
        _same(_batches(tit), _batches(jit))
        assert [tuple(d) for d in tit.provide_data] == \
            [tuple(d) for d in jit.provide_data]
        assert [d.name for d in tit.provide_label] == ["softmax_label_0",
                                                      "softmax_label_1"]
        t = tio.NDArrayIter(torch.from_numpy(DATA), batch_size=5)
        b = t.next()
        assert b.label == [] and b.data[0].shape == (5, 3, 2)
        assert t.iter_next() and not t.iter_next()


@pytest.mark.parametrize("native", [True, False])
def test_csv_iter_matches_jax(tmp_path, monkeypatch, native):
    data = tmp_path / "d.csv"
    label = tmp_path / "l.csv"
    np.savetxt(data, DATA.reshape(10, 6), delimiter=",")
    np.savetxt(label, LABEL.reshape(10, 1), delimiter=",")
    if not native:
        import mxnet_tpu._native as jn
        import mxnet_tpu_torch._native as tn
        monkeypatch.setattr(jn, "available", lambda: False)
        monkeypatch.setattr(tn, "available", lambda: False)
    got, want = _both(lambda io: io.CSVIter(
        str(data), (3, 2), label_csv=str(label), batch_size=4))
    _same(got, want)
    np.testing.assert_allclose(got[0][0][0], DATA[:4], rtol=1e-6)


def test_libsvm_iter_matches_jax(tmp_path):
    lines = ["1 0:0.5 3:1.25", "0 1:-2.0", "2 2:0.75 4:3.0 5:1.0",
             "", "1 5:-1.5"]
    path = tmp_path / "d.libsvm"
    path.write_text("\n".join(lines) + "\n")
    labels = tmp_path / "l.txt"
    labels.write_text("3\n1\n4\n1\n")
    for kw in ({}, {"label_libsvm": str(labels)}):
        got, want = _both(lambda io: io.LibSVMIter(
            str(path), (6,), batch_size=3, **kw))
        _same(got, want)
    assert got[0][0][0][0].tolist() == [0.5, 0, 0, 1.25, 0, 0]
    bad = tmp_path / "bad.libsvm"
    bad.write_text("1 6:1.0\n")
    with pytest.raises(MXNetError, match="out of range"):
        tio.LibSVMIter(str(bad), (6,))


def test_resize_and_prefetching_iters_match_jax():
    got, want = _both(lambda io: io.ResizeIter(
        io.NDArrayIter(DATA, LABEL, batch_size=4), 5))
    _same(got, want)
    assert len(got) == 5
    got, want = _both(lambda io: io.PrefetchingIter(
        io.NDArrayIter(DATA, LABEL, batch_size=3,
                       last_batch_handle="discard")))
    _same(got, want)
    with tm.cpu():
        it = tio.PrefetchingIter([tio.NDArrayIter(DATA, batch_size=5),
                                  tio.NDArrayIter(LABEL, batch_size=5)])
        pair = it.next()
        assert len(pair) == 2 and pair[1].data[0].shape == (5,)


def _mnist(io, **kw):
    return io.MNISTIter(os.path.join(MNIST, "train-images-idx3-ubyte.gz"),
                        os.path.join(MNIST, "train-labels-idx1-ubyte.gz"),
                        batch_size=8, **kw)


@pytest.mark.parametrize("kw", [{"shuffle": False}, {"seed": 3},
                                {"flat": True, "seed": 5},
                                {"part_index": 1, "num_parts": 2}],
                         ids=["ordered", "shuffled", "flat", "sharded"])
def test_mnist_iter_matches_jax_and_the_golden_file(kw):
    got, want = _both(lambda io: _mnist(io, **kw))
    _same(got, want)
    assert len(got) == (3 if "num_parts" in kw else 6)
    if kw == {"shuffle": False}:
        golden = np.load(os.path.join(MNIST, "golden.npz"))
        np.testing.assert_array_equal(
            got[0][0][0][:, 0], golden["imgs"][:8].astype(np.float32) /
            np.float32(255.0))
        np.testing.assert_array_equal(got[0][1][0], golden["labels"][:8])


def _imgrec(io, **kw):
    return io.ImageRecordIter(os.path.join(IMGREC, "fixture.rec"),
                              kw.pop("data_shape", (3, 12, 16)),
                              kw.pop("batch_size", 4), **kw)


def test_image_record_iter_equals_its_golden_file():
    golden = np.load(os.path.join(IMGREC, "golden.npz"))
    with tm.cpu():
        it = _imgrec(tio)
        got = _batches(it)
        it.close()
    assert len(got) == 2
    imgs = np.concatenate([g[0][0] for g in got])
    np.testing.assert_array_equal(
        imgs, golden["imgs"].transpose(0, 3, 1, 2).astype(np.float32))
    np.testing.assert_array_equal(np.concatenate([g[1][0] for g in got]),
                                  golden["labels"].astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=7,
         data_shape=(3, 10, 12), batch_size=3),
    dict(resize=10, mean_r=120.0, mean_g=110.0, mean_b=100.0, std_r=50.0,
         std_g=60.0, std_b=70.0, scale=0.5, data_shape=(3, 8, 8)),
    dict(data_shape=(1, 12, 16), num_parts=2, part_index=1,
         batch_size=3)],
    ids=["augmented", "normalised", "grey_sharded"])
def test_image_record_iter_matches_jax(kw):
    def make(io):
        return _imgrec(io, **dict(kw))
    got, want = _both(make)
    _same(got, want)


def test_packed_images_read_back_through_the_iterator(tmp_path):
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (5, 6, 7, 3)).astype(np.uint8)
    rec, idx = str(tmp_path / "p.rec"), str(tmp_path / "p.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(imgs):
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i), i, 0), img,
                                     img_fmt=".png"))
    w.close()
    got, want = _both(lambda io: io.ImageRecordIter(
        rec, (3, 6, 7), 5, path_imgidx=idx))
    _same(got, want)
    np.testing.assert_array_equal(got[0][0][0],
                                  imgs.transpose(0, 3, 1, 2)
                                  .astype(np.float32))
    assert got[0][1][0].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_batches_land_on_the_current_device_and_errors_raise(tmp_path):
    with tm.cpu():
        b = tio.NDArrayIter(DATA, LABEL, batch_size=4).next()
    assert b.data[0]._data.device.type == "cpu"
    with pytest.raises(MXNetError, match="index file"):
        tio.ImageRecordIter(str(tmp_path / "none.rec"), (3, 4, 4), 2)
    with pytest.raises(MXNetError, match="data_shape"):
        tio.ImageRecordIter(os.path.join(IMGREC, "fixture.rec"), (4, 4), 2)
    assert tm.io.DataDesc("x", (1, 2)).layout == "NCHW"
