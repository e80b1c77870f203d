"""Port parity: `mxnet_tpu_torch.data` (order, mixture, packing, sharded
records, the pipeline) against ``mxnet_tpu.data`` on the CPU.

Everything here is integer arithmetic or record I/O, so it is compared
exactly: `EpochOrder.index` and `mix64` give the same integers, the
`MixtureDataset` schedule the same children and indices, `SequencePacker`
the same rows and carry, and `DataPipeline` the same batches over the same
shards, with the same ``state()`` as JSON — a state written by JAX's
pipeline seeks the port's to JAX's next batch, and the other way round.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu.data as jdata
import mxnet_tpu.recordio as jrec
import mxnet_tpu_torch.data as tdata
import mxnet_tpu_torch.data.order as torder
from mxnet_tpu_torch.base import MXNetError

N_SHARDS, PER_SHARD, WIDTH = 3, 13, 6


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three indexed shards of 13 int32 records each (written by the JAX
    package; the port reads them), plus the samples in flat order."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)
    samples = rng.randint(0, 1 << 20, size=(N_SHARDS * PER_SHARD, WIDTH)
                          ).astype(np.int32)
    for s in range(N_SHARDS):
        w = jrec.MXIndexedRecordIO(str(root / f"part-{s}.idx"),
                                   str(root / f"part-{s}.rec"), "w")
        for k in range(PER_SHARD):
            w.write_idx(k, samples[s * PER_SHARD + k].tobytes())
        w.close()
    return str(root / "*.rec"), samples


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    """Ragged token documents (lengths 1-23) in two indexed shards."""
    root = tmp_path_factory.mktemp("docs")
    rng = np.random.RandomState(1)
    out = []
    for s in range(2):
        w = jrec.MXIndexedRecordIO(str(root / f"d-{s}.idx"),
                                   str(root / f"d-{s}.rec"), "w")
        for k in range(20):
            d = rng.randint(1, 1000, size=rng.randint(1, 24)
                            ).astype(np.int32)
            w.write_idx(k, d.tobytes())
            out.append(d)
        w.close()
    return str(root / "*.rec"), out


@pytest.mark.parametrize("length,seed,window", [
    (1, 0, None), (2, 5, None), (96, 0, None), (97, 3, 8), (1000, 11, 64),
    (37, 2 ** 40 + 7, 0), (4096 + 5, 9, None)])
def test_epoch_order_gives_jax_indices(length, seed, window):
    t = tdata.EpochOrder(length, seed, window=window)
    j = jdata.EpochOrder(length, seed, window=window)
    offsets = range(length) if length <= 1000 else \
        np.random.RandomState(0).randint(0, length, 500).tolist()
    for epoch in (0, 1, 7):
        got = [t.index(epoch, o) for o in offsets]
        assert got == [j.index(epoch, o) for o in offsets]
        if length <= 1000:
            assert sorted(got) == list(range(length))
    assert repr(t) == repr(j)


def test_mix64_and_key_derivation_match_jax():
    import mxnet_tpu.data.order as jorder
    vals = [0, 1, 2 ** 63, 2 ** 64 - 1, -1, 123456789, 0xC0FFEE]
    assert [tdata.mix64(v) for v in vals] == [jdata.mix64(v) for v in vals]
    assert torder._derive(3, 7, 0x57) == jorder._derive(3, 7, 0x57)


def test_default_window_and_seed_read_the_environment(monkeypatch):
    for v in ("0", "17", "junk", "-3"):
        monkeypatch.setenv("MXTPU_DATA_WINDOW", v)
        assert tdata.default_window() == jdata.default_window()
    for v in ("5", "junk"):
        monkeypatch.setenv("MXTPU_DATA_SEED", v)
        assert tdata.default_data_seed() == jdata.default_data_seed()


def test_out_of_range_offsets_raise():
    o = tdata.EpochOrder(10, 0)
    with pytest.raises(IndexError):
        o.index(0, 10)
    with pytest.raises(ValueError):
        tdata.EpochOrder(0, 0)


@pytest.mark.parametrize("weights,shuffle", [(None, True), ([3, 1, 0.5],
                                                           True),
                                             ([1, 2, 1], False)])
def test_mixture_schedule_matches_jax(weights, shuffle):
    kids = [list(range(n)) for n in (5, 11, 3)]
    t = tdata.MixtureDataset(kids, weights=weights, seed=4, shuffle=shuffle)
    j = jdata.MixtureDataset(kids, weights=weights, seed=4, shuffle=shuffle)
    ts, js = t.init_counters(), j.init_counters()
    for p in range(200):
        tc, jc = t.select(p, ts), j.select(p, js)
        assert tc == jc
        assert t.locate(tc, ts[tc]) == j.locate(jc, js[jc])
        ts[tc] += 1
        js[jc] += 1
    assert t.weights == j.weights and repr(t) == repr(j)


def test_mixture_refuses_bad_weights():
    with pytest.raises(MXNetError):
        tdata.MixtureDataset([[1], [2]], weights=[1, 0])
    with pytest.raises(MXNetError):
        tdata.MixtureDataset([])


@pytest.mark.parametrize("split_docs", [True, False])
def test_sequence_packer_rows_and_carry_match_jax(docs, split_docs):
    _, ds = docs
    t = tdata.SequencePacker(16, pad_id=-1, split_docs=split_docs)
    j = jdata.SequencePacker(16, pad_id=-1, split_docs=split_docs)
    for i, d in enumerate(ds):
        assert t.add(d) == j.add(d)
        assert t.state() == j.state()
        while t.rows_ready >= 3:
            tb, jb = t.pop_batch(3), j.pop_batch(3)
            assert tb.keys() == jb.keys()
            for k in tb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
        if i == 17:                 # the carry crosses packages mid-stream
            t2 = tdata.SequencePacker(16, pad_id=-1, split_docs=split_docs)
            t2.load_state(json.loads(json.dumps(j.state())))
            t = t2
    assert t.flush() == j.flush()
    assert t.truncated_docs == j.truncated_docs
    with pytest.raises(MXNetError):
        t.pop_batch(t.rows_ready + 1)


def test_sharded_dataset_reads_every_record(shards):
    pattern, samples = shards
    t = tdata.ShardedRecordDataset(pattern)
    j = jdata.ShardedRecordDataset(pattern)
    assert len(t) == len(j) == len(samples) and t.num_shards == N_SHARDS
    for k in [0, 12, 13, 25, 38, 7]:
        np.testing.assert_array_equal(t[k], samples[k])
        assert t.read_raw(k) == j.read_raw(k)
        assert t.shard_of(k) == j.shard_of(k)
    assert t.read_counts == [6, 4, 2]      # two reads an index above
    t.close()
    j.close()
    with pytest.raises(MXNetError, match="no record shards"):
        tdata.ShardedRecordDataset(pattern + ".missing")


def _batches(p, n):
    return [next(p) for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(batch_size=8, seed=0),
    dict(batch_size=5, seed=3, window=4),
    dict(batch_size=6, seed=1, shuffle=False),
    dict(batch_size=8, seed=2, num_hosts=2, host_id=1),
])
def test_pipeline_batches_and_state_match_jax(shards, kw):
    pattern, samples = shards
    t = tdata.DataPipeline(tdata.ShardedRecordDataset(pattern), **kw)
    j = jdata.DataPipeline(jdata.ShardedRecordDataset(pattern), **kw)
    for _ in range(11):             # past an epoch boundary (39 samples)
        np.testing.assert_array_equal(next(t), next(j))
        assert json.dumps(t.state()) == json.dumps(j.state())
    assert t.host_rows == j.host_rows
    assert t.state_at(4) == j.state_at(4)
    t.close()
    j.close()


def test_pipeline_rows_follow_the_epoch_order(shards):
    pattern, samples = shards
    p = tdata.DataPipeline(tdata.ShardedRecordDataset(pattern),
                           batch_size=8, seed=0)
    order = tdata.EpochOrder(len(samples), 0)
    for k in range(4):
        want = samples[[order.index(0, 8 * k + r) for r in range(8)]]
        np.testing.assert_array_equal(next(p), want)


@pytest.mark.parametrize("at", [0, 3, 6])
def test_states_seek_across_the_packages(shards, at):
    pattern, _ = shards
    j = jdata.DataPipeline(jdata.ShardedRecordDataset(pattern),
                           batch_size=8, seed=5)
    _batches(j, 7)
    state = json.loads(json.dumps(j.state_at(at)))
    j2 = jdata.DataPipeline(jdata.ShardedRecordDataset(pattern),
                            batch_size=8, seed=5)
    j2.load_state(state)
    t = tdata.DataPipeline(tdata.ShardedRecordDataset(pattern),
                           batch_size=8, seed=5)
    t.load_state(state)
    assert t.state() == j2.state()
    np.testing.assert_array_equal(next(t), next(j2))
    # and back: the port's state seeks JAX's pipeline
    j3 = jdata.DataPipeline(jdata.ShardedRecordDataset(pattern),
                            batch_size=8, seed=5)
    j3.load_state(t.state())
    np.testing.assert_array_equal(next(t), next(j3))


def test_packed_and_mixture_pipelines_match_jax(shards, docs):
    pattern, _ = shards
    dpat, _ = docs

    def build(pkg):
        mix = pkg.MixtureDataset([pkg.ShardedRecordDataset(dpat),
                                  pkg.ShardedRecordDataset(pattern)],
                                 weights=[2, 1], seed=7)
        return pkg.DataPipeline(mix, batch_size=4, seed=7, seq_len=12)

    t, j = build(tdata), build(jdata)
    for _ in range(6):
        tb, jb = next(t), next(j)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    assert json.dumps(t.state()) == json.dumps(j.state())
    t.skip_batches(2)
    j.skip_batches(2)
    assert t.state() == j.state()
    state = json.loads(json.dumps(j.state_at(5)))
    t2, j2 = build(tdata), build(jdata)
    t2.load_state(state)
    j2.load_state(state)
    for _ in range(2):
        tb, jb = next(t2), next(j2)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


def test_load_state_refuses_another_stream(shards):
    pattern, _ = shards
    p = tdata.DataPipeline(tdata.ShardedRecordDataset(pattern),
                           batch_size=4, seed=1)
    st = p.state()
    with pytest.raises(MXNetError, match="seed"):
        tdata.DataPipeline(tdata.ShardedRecordDataset(pattern),
                           batch_size=4, seed=2).load_state(st)
    with pytest.raises(MXNetError, match="batch_size"):
        tdata.DataPipeline(tdata.ShardedRecordDataset(pattern),
                           batch_size=8, seed=1).load_state(st)
    with pytest.raises(MXNetError, match="newer"):
        p.load_state(dict(st, version=99))


def test_host_views_and_the_mesh_argument(shards):
    pattern, _ = shards
    assert tdata.host_shard_from_mesh() == (1, 0)
    assert tdata.host_range(8, 2, 1) == jdata.host_range(8, 2, 1) == (4, 8)
    with pytest.raises(MXNetError, match="divide"):
        tdata.host_range(7, 2, 0)
    with pytest.raises(MXNetError, match="A12"):
        tdata.host_shard_from_mesh(object())
    with pytest.raises(MXNetError, match="A12"):
        tdata.DataPipeline(tdata.ShardedRecordDataset(pattern),
                           batch_size=4, mesh=object())
    # hosts are views: 2 hosts' rows make up the 1-host batch
    whole = tdata.DataPipeline(tdata.ShardedRecordDataset(pattern),
                               batch_size=6, seed=9)
    parts = [tdata.DataPipeline(tdata.ShardedRecordDataset(pattern),
                                batch_size=6, seed=9, num_hosts=2,
                                host_id=h) for h in (0, 1)]
    for _ in range(3):
        np.testing.assert_array_equal(
            next(whole), np.concatenate([next(p) for p in parts]))


def test_pipeline_telemetry_names_match_jax(shards, tmp_path):
    import mxnet_tpu.telemetry as jtele
    import mxnet_tpu_torch.telemetry as ttele
    pattern, _ = shards
    names = []
    for pkg, tele in ((tdata, ttele), (jdata, jtele)):
        tele.enable()
        tele.registry().reset()
        try:
            p = pkg.DataPipeline(pkg.ShardedRecordDataset(pattern),
                                 batch_size=4, seed=0)
            _batches(p, 3)
            names.append(sorted(k for k in tele.snapshot()
                                if k.startswith("data_")))
            assert p.stats()["batches"] == 3
        finally:
            tele.disable()
            tele.registry().reset()
    assert names[0] == names[1] and "data_batches_total" in names[0]


def test_record_files_are_written_where_asked(tmp_path):
    """Nothing of the pipeline writes beside the package."""
    pkg_dir = os.path.dirname(os.path.abspath(tdata.__file__))
    before = sorted(os.listdir(pkg_dir))
    from mxnet_tpu_torch import recordio
    w = recordio.MXIndexedRecordIO(str(tmp_path / "a.idx"),
                                   str(tmp_path / "a.rec"), "w")
    w.write_idx(0, b"abcd")
    w.close()
    p = tdata.DataPipeline(tdata.ShardedRecordDataset(
        str(tmp_path / "*.rec"), decode=bytes), batch_size=1, seed=0)
    assert list(next(p)) == [b"abcd"]
    assert sorted(os.listdir(pkg_dir)) == before
