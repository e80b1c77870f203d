"""Port parity: `mxnet_tpu_torch.recordio` and its native reader against
``mxnet_tpu.recordio`` on the CPU.

Record files cross both ways: a file written by either package, on either
of its paths (the C++ reader built from ``_native/io.cc``, or the
pure-Python fallback), has the same bytes and is read back record for
record by the other.  The port's native library is built into the port's
build root, never into the package, and the port walks the committed image
record fixture (``tests/fixtures/imgrec``) with the labels its golden file
holds.  Records are compared exactly.
"""
import os

import numpy as np
import pytest

import mxnet_tpu._native as jnative
import mxnet_tpu.recordio as jrec
import mxnet_tpu_torch as tm
import mxnet_tpu_torch._native as tnative
import mxnet_tpu_torch.recordio as trec
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMGREC = os.path.join(REPO, "tests", "fixtures", "imgrec")


def _payloads(seed=0, n=17):
    """Records of every length mod 4 (the padding), an empty one among
    them."""
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(k)) for k in
            [0, 1, 2, 3, 4, 5, 130, *rng.randint(1, 300, n - 7)]]


def _native(pkg_native, on, monkeypatch):
    if not on:
        monkeypatch.setattr(pkg_native, "available", lambda: False)


def _write(pkg, path, recs, indexed):
    if indexed:
        w = pkg.MXIndexedRecordIO(path + ".idx", path, "w")
        for k, r in enumerate(recs):
            w.write_idx(k, r)
    else:
        w = pkg.MXRecordIO(path, "w")
        for r in recs:
            w.write(r)
    w.close()


def _read_all(pkg, path):
    r = pkg.MXRecordIO(path, "r")
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


def test_native_library_builds_into_the_build_root_not_the_package():
    assert tnative.available()
    lib = tnative.library_path()
    assert os.path.isfile(lib)
    pkg_dir = os.path.dirname(os.path.abspath(tnative.__file__))
    assert not lib.startswith(pkg_dir + os.sep)
    assert not [f for f in os.listdir(pkg_dir) if f.endswith(".so")]
    from mxnet_tpu_torch.kernels import _build_root
    assert os.path.commonpath([lib, _build_root()]) == _build_root()


def test_build_root_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_TORCH_BUILD_DIR", str(tmp_path))
    assert tnative.library_path().startswith(str(tmp_path) + os.sep)


@pytest.mark.parametrize("writer", ["jax", "jax_py", "torch", "torch_py"])
@pytest.mark.parametrize("indexed", [False, True])
def test_files_cross_both_ways_with_equal_bytes(tmp_path, monkeypatch,
                                                writer, indexed):
    recs = _payloads()
    ref = str(tmp_path / "ref.rec")
    with monkeypatch.context() as m:
        _native(jnative, False, m)
        _write(jrec, ref, recs, indexed)        # JAX's pure-Python writer
    path = str(tmp_path / "got.rec")
    pkg, nat = {"jax": (jrec, jnative), "jax_py": (jrec, jnative),
                "torch": (trec, tnative),
                "torch_py": (trec, tnative)}[writer]
    with monkeypatch.context() as m:
        _native(nat, not writer.endswith("_py"), m)
        _write(pkg, path, recs, indexed)
    with open(ref, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()
    if indexed:
        with open(ref + ".idx") as f, open(path + ".idx") as g:
            assert f.read() == g.read()
    for reader, nat in ((trec, tnative), (jrec, jnative)):
        for on in (True, False):
            with monkeypatch.context() as m:
                _native(nat, on, m)
                assert _read_all(reader, path) == recs


@pytest.mark.parametrize("native", [True, False])
def test_indexed_random_access_matches_jax(tmp_path, monkeypatch, native):
    recs = _payloads(seed=1)
    path = str(tmp_path / "x.rec")
    _write(jrec, path, recs, indexed=True)
    _native(tnative, native, monkeypatch)
    t = trec.MXIndexedRecordIO(path + ".idx", path, "r")
    j = jrec.MXIndexedRecordIO(path + ".idx", path, "r")
    assert t._native == native and t.keys == j.keys
    for k in [5, 0, 16, 3, 3, 9]:
        assert t.read_idx(k) == j.read_idx(k) == recs[k]
    t.close()
    j.close()


@pytest.mark.parametrize("native", [True, False])
def test_prefetched_reader_yields_every_record(tmp_path, monkeypatch, native):
    recs = _payloads(seed=2, n=40)
    path = str(tmp_path / "p.rec")
    _write(trec, path, recs, indexed=False)
    _native(tnative, native, monkeypatch)
    r = trec.MXPrefetchedRecordIO(path, capacity=3)
    assert (r._impl is not None) == native
    assert list(r) == recs
    r.close()
    # closed mid-file: no hang, nothing more
    r = trec.MXPrefetchedRecordIO(path, capacity=2)
    assert next(r) == recs[0]
    r.close()


def test_corrupt_record_raises_on_both_paths(tmp_path, monkeypatch):
    path = str(tmp_path / "c.rec")
    _write(trec, path, [b"abcd", b"efgh"], indexed=False)
    with open(path, "r+b") as f:
        f.seek(12)
        f.write(b"\x00\x00\x00\x00")        # the second record's magic
    with pytest.raises(IOError):
        _read_all(trec, path)
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(MXNetError, match="magic"):
        _read_all(trec, path)


@pytest.mark.parametrize("label", [3.5, [1.0, 2.5, -4.0],
                                   np.arange(5, dtype=np.float32)])
def test_pack_and_unpack_match_jax(label):
    hdr = (0, label, 7, 11)
    payload = b"payload-bytes"
    got = trec.pack(trec.IRHeader(*hdr), payload)
    assert got == jrec.pack(jrec.IRHeader(*hdr), payload)
    th, tp = trec.unpack(got)
    jh, jp = jrec.unpack(got)
    assert tp == jp == payload
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


def test_image_record_fixture_walks_with_the_golden_labels():
    golden = np.load(os.path.join(IMGREC, "golden.npz"))
    t = trec.MXIndexedRecordIO(os.path.join(IMGREC, "fixture.idx"),
                               os.path.join(IMGREC, "fixture.rec"), "r")
    j = jrec.MXIndexedRecordIO(os.path.join(IMGREC, "fixture.idx"),
                               os.path.join(IMGREC, "fixture.rec"), "r")
    assert len(t.keys) == len(golden["labels"]) == 8
    for i, k in enumerate(t.keys):
        raw = t.read_idx(k)
        assert raw == j.read_idx(k)
        hdr, img = trec.unpack(raw)
        assert float(np.asarray(hdr.label).ravel()[0]) == \
            float(golden["labels"][i])
        assert img[:4] == b"\x89PNG"
    t.close()
    j.close()


def test_image_packing_raises_naming_a11():
    """``pack_img`` / ``unpack_img`` work since A11 part 1: a PNG round
    trip is exact, and each fixture record unpacks to the JAX package's
    image; the image codec module itself (``mx.image``) still raises
    naming A11 part 2."""
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (6, 9, 3)).astype(np.uint8)
    with tm.cpu():
        hdr, got = trec.unpack_img(trec.pack_img(
            trec.IRHeader(0, 4.0, 11, 0), img, img_fmt=".png"))
        assert (hdr.label, hdr.id) == (4.0, 11)
        np.testing.assert_array_equal(got.asnumpy(), img)
        _, grey = trec.unpack_img(trec.pack_img(
            trec.IRHeader(0, 1.0, 0, 0), img[:, :, 0], img_fmt=".png"))
        np.testing.assert_array_equal(grey.asnumpy(),
                                      np.repeat(img[:, :, :1], 3, axis=2))
        j = jrec.MXIndexedRecordIO(os.path.join(IMGREC, "fixture.idx"),
                                   os.path.join(IMGREC, "fixture.rec"), "r")
        for k in j.keys:
            raw = j.read_idx(k)
            (wh, want), (gh, have) = jrec.unpack_img(raw), \
                trec.unpack_img(raw)
            assert tuple(gh) == tuple(wh)
            np.testing.assert_array_equal(have.asnumpy(), want.asnumpy())
        j.close()
    with pytest.raises(MXNetError, match="A11 part 2"):
        tm.image.imdecode


def test_bad_flag_raises():
    with pytest.raises(MXNetError, match="flag"):
        trec.MXRecordIO("unused.rec", "a")
