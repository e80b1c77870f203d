"""Port parity: `mxnet_tpu_torch.elastic` against ``mxnet_tpu.elastic`` on
the CPU (scenarios from ``tests/unittest/test_elastic.py`` and
``test_recovery.py``).

The flagship case is ``examples/bert_pretraining.py``'s loop at a small
size: the tiny BERT pretraining step (2 layers, hidden 64, dropout 0, f32,
Adam) under `ElasticLoop` with health and recovery on, in both packages
from the same weights and the same 12 seeded batches, a NaN planted in the
loss at step 5, a stop requested after step 7 (`request_stop`, never a
real signal: test workers share a process group), then a fresh loop that
resumes and meets an injected failure at step 9.  Both packages give the
same statuses, tier-1 skips, restores and checkpoint steps on disk, the
same non-finite counts and a grad_norm within 1e-5 (relative) at every
step, and every weight within 1e-5 (relative L2) of JAX's; the port's
final weights and Adam state are bit-equal to its own uninterrupted
run.  JAX's second loop reuses its
step object (its `load` overwrites the whole state); the port's builds a
fresh `TrainStep`, as a restarted job would.
"""
import os

import numpy as np
import pytest
import torch

from torch_plane_common import (  # noqa: F401 — clean_plane is autouse
    GuardLog, assert_rel, batches, clean_plane, enable_plane, jax_batch,
    jax_params, jax_step, jelastic, telastic, torch_params,
    torch_step)

import mxnet_tpu_torch as tm
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture
def reference_route(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "reference")


def _bert_scenario(monkeypatch, tmp, pkg, build, run_batch):
    """Loop A (NaN at 5, stop after 7), then loop B (resume, failure at 9);
    returns both results, the policies' skips, the steps on disk and each
    dispatched step's probes (grad_norm, nonfinite) by step id."""
    log = GuardLog(monkeypatch, pkg)
    data = batches(12, nan_at=5)
    probes = {}

    def run(step, i):
        h = run_batch(step, data[i])
        probes[h.step] = (float(h.probes["grad_norm"]),
                          float(h.probes["nonfinite"]))
        return h.loss

    step = build()
    loop_a = pkg.ElasticLoop(step, tmp, save_every=4, keep=2,
                             async_save=True)

    def on_step(i, _loss):
        if i == 7:
            log.stop()

    out_a = loop_a.run(lambda i: run(step, i), 12, on_step=on_step)
    step_b = build(step)
    loop_b = pkg.ElasticLoop(step_b, tmp, save_every=4, keep=2,
                             async_save=True,
                             failure_injector=pkg.FailureInjector([8]))
    out_b = loop_b.run(lambda i: run(step_b, i), 12)
    return dict(a=(out_a["status"], out_a["step"], out_a["restores"]),
                b=(out_b["status"], out_b["step"], out_b["restores"]),
                skips=(loop_a.recovery.skips, loop_b.recovery.skips),
                poison=loop_a.recovery.stats()["poison"],
                on_disk=[s for s, _ in loop_b.manager.checkpoints()],
                step=step_b, probes=probes)


def test_bert_elastic_loop_matches_jax(monkeypatch, tmp_path,
                                       reference_route):
    enable_plane()
    js, weights = jax_step()

    def jrun(step, b):
        return step.dispatch(*jax_batch(b))

    got_j = _bert_scenario(monkeypatch, str(tmp_path / "jax"), jelastic,
                           lambda prev=None: js, jrun)

    def trun(step, b):
        return step.dispatch(*b)

    got_t = _bert_scenario(monkeypatch, str(tmp_path / "port"), telastic,
                           lambda prev=None: torch_step(weights), trun)
    for k in ("a", "b", "skips", "poison", "on_disk"):
        assert got_t[k] == got_j[k], (k, got_t[k], got_j[k])
    assert got_t["a"] == ("preempted", 7, 0)
    assert got_t["b"] == ("completed", 12, 1)
    assert got_t["skips"] == (1, 0) and got_t["poison"] == [5]
    assert got_t["on_disk"] == [8, 12]
    js.sync_params_to_block()
    assert_rel(torch_params(got_t["step"]), jax_params(js))
    # the probes: grad_norm within 1e-5 of JAX's, the counts equal (the
    # poisoned step's is every element the NaN loss reaches)
    assert sorted(got_t["probes"]) == sorted(got_j["probes"]) == \
        list(range(1, 13))
    for k, (gn, bad) in got_t["probes"].items():
        jgn, jbad = got_j["probes"][k]
        assert bad == jbad, (k, bad, jbad)
        if k == 5:
            assert bad > 0 and np.isnan(gn) and np.isnan(jgn)
        else:
            assert bad == 0 and abs(gn - jgn) <= 1e-5 * abs(jgn), (k, gn,
                                                                   jgn)

    # the port against its own uninterrupted run: bit-equal
    ref = torch_step(weights)
    for b in batches(12, nan_at=5):
        ref(*b)
    for n in ref.param_names:
        assert torch.equal(ref.params[n], got_t["step"].params[n]), n
    for n in ref.diff_names:
        for a, b in zip(ref.opt_state[n], got_t["step"].opt_state[n]):
            assert torch.equal(a, b), n
    assert ref._t == got_t["step"]._t == 12


class Counter:
    """Deterministic save/load target: state = f(steps applied)."""

    def __init__(self):
        self.state = np.zeros(4)

    def apply(self, i):
        self.state = self.state * 0.9 + i

    def save(self, path):
        with open(path, "wb") as f:
            np.savez(f, state=self.state)

    def load(self, path):
        with np.load(path) as z:
            self.state = z["state"]


def _counter_case(pkg, tmp, case):
    t = Counter()
    if case == "complete":
        loop = pkg.ElasticLoop(t, tmp, save_every=3)
        out = loop.run(t.apply, 10)
    elif case == "restore":
        loop = pkg.ElasticLoop(t, tmp, save_every=2,
                               failure_injector=pkg.FailureInjector([3, 7]))
        out = loop.run(t.apply, 10)
    elif case == "before_first_save":
        loop = pkg.ElasticLoop(t, tmp, save_every=50,
                               failure_injector=pkg.FailureInjector([2]))
        out = loop.run(t.apply, 6)
    elif case == "gives_up":
        loop = pkg.ElasticLoop(t, tmp, save_every=1, max_restores=2)

        def bad(i):
            if i == 3:
                raise RuntimeError("persistent")
            t.apply(i)
        try:
            loop.run(bad, 10)
            out = {"status": "no raise"}
        except Exception as e:   # both raise MXNetError of their package
            out = {"status": "raised", "error": type(e).__name__,
                   "msg": str(e)}
    elif case == "resume":
        pkg.ElasticLoop(t, tmp, save_every=2).run(t.apply, 5)
        t2 = Counter()
        out = pkg.ElasticLoop(t2, tmp, save_every=2).run(t2.apply, 9)
        t = t2
    out = {k: v for k, v in out.items() if k not in ("checkpoint", "loss")}
    steps = sorted(int(f.split("-")[1].split(".")[0])
                   for f in os.listdir(tmp)
                   if f.startswith("ckpt-") and f.endswith(".npz"))
    return out, steps, t.state.tolist()


@pytest.mark.parametrize("case", ["complete", "restore", "before_first_save",
                                  "gives_up", "resume"])
def test_counter_target_matches_jax(tmp_path, case):
    got = _counter_case(telastic, str(tmp_path / "t"), case)
    want = _counter_case(jelastic, str(tmp_path / "j"), case)
    assert got == want


def test_preemption_guard_request_stop_and_grace(monkeypatch):
    for pkg in (jelastic, telastic):
        g = pkg.PreemptionGuard(grace=5.0)
        assert not g.preempted and g.deadline_remaining() is None
        g.request_stop()
        assert g.preempted
        assert 0.0 < g.deadline_remaining() <= 5.0
    monkeypatch.setenv("MXTPU_PREEMPT_GRACE", "3")
    assert telastic.PreemptionGuard().grace == \
        jelastic.PreemptionGuard().grace == 3.0


def test_emergency_checkpoint_writes_marker_and_resumes(tmp_path):
    from mxnet_tpu_torch import recovery
    t = Counter()
    for i in range(4):
        t.apply(i)
    loop = telastic.ElasticLoop(t, str(tmp_path), save_every=100)
    guard = telastic.PreemptionGuard(manager=loop.manager)
    guard.request_stop()
    info = guard.emergency_checkpoint(target=t, step=4)
    assert info["complete"] and not info["partial"] and info["step"] == 4
    marker = recovery.read_resume_marker(str(tmp_path))
    assert marker["step"] == 4 and marker["complete"]
    t2 = Counter()
    out = telastic.ElasticLoop(t2, str(tmp_path), save_every=100).run(
        t2.apply, 8)
    ref = Counter()
    for i in range(8):
        ref.apply(i)
    assert out["status"] == "completed"
    np.testing.assert_array_equal(t2.state, ref.state)
    assert recovery.read_resume_marker(str(tmp_path)) is None


@pytest.mark.parametrize("kw,item", [("mesh_controller", "A12")])
def test_unported_parts_raise_naming_their_item(tmp_path, kw, item):
    with pytest.raises(MXNetError, match=item):
        telastic.ElasticLoop(Counter(), str(tmp_path), **{kw: object()})


# ---------------------------------------------------------------------------
# the loop fed by the data plane: record shards -> DataPipeline ->
# DevicePrefetcher, stopped, resumed and failed over
# ---------------------------------------------------------------------------

def _decode(raw):
    return np.frombuffer(raw, np.float32)


@pytest.fixture
def shards(tmp_path):
    """30 samples of 7 float32 (6 inputs, 1 target) in 3 record shards."""
    from mxnet_tpu_torch import recordio
    rng = np.random.RandomState(0)
    samples = rng.randn(30, 7).astype(np.float32)
    for s in range(3):
        w = recordio.MXIndexedRecordIO(str(tmp_path / f"s{s}.idx"),
                                       str(tmp_path / f"s{s}.rec"), "w")
        for k in range(10):
            w.write_idx(k, samples[10 * s + k].tobytes())
        w.close()
    return str(tmp_path / "s*.rec"), samples


def _oracle(samples, n=12, batch=4, seed=3):
    """Batch k of the stream, straight from the epoch order."""
    from mxnet_tpu_torch.data import EpochOrder
    order = EpochOrder(len(samples), seed)
    return [samples[[order.index(*divmod(batch * k + r, len(samples)))
                     for r in range(batch)]] for k in range(n)]


class NumpyModel(Counter):
    """A target whose state folds in every batch it trains on."""

    def __init__(self):
        self.state = np.zeros(7)

    def train(self, b):
        self.state = self.state * 0.5 + np.asarray(b, np.float64).sum(0)


class LinearModel:
    """A small model: `Linear(6, 1)` with SGD through the port's
    `TrainStep` on the CPU, fed (inputs, target) columns of a batch."""

    def __init__(self):
        from mxnet_tpu_torch.optimizer import SGD
        from mxnet_tpu_torch.parallel import make_train_step
        torch.manual_seed(0)
        self.step = make_train_step(
            torch.nn.Linear(6, 1), SGD(learning_rate=0.05),
            lambda out, x, y: ((out - y) ** 2).mean(), num_model_args=1)

    def train(self, b):
        b = torch.as_tensor(np.asarray(b))
        return self.step.dispatch(b[:, :6], b[:, 6:]).loss

    @property
    def state(self):
        return np.concatenate([p.detach().numpy().ravel()
                               for p in self.step.params.values()])

    def save(self, path):
        self.step.save(path)

    def load(self, path):
        self.step.load(path)

    def drain(self, timeout=None):
        return self.step.drain(timeout)


def _data_loop(monkeypatch, tmp, el, data, pf, pattern, model_cls,
               stop_after=5, fail_at=8):
    """Loop A stops after `stop_after` steps; loop B (fresh model,
    pipeline and prefetcher, as a restarted job builds them) resumes and
    meets a failure at step `fail_at`.  Returns both results, the
    (step, batch) pairs each step trained on, the final model and the
    newest manifest's pipeline state."""
    log = GuardLog(monkeypatch, el)
    seen = []

    def build():
        pipe = data.DataPipeline(data.ShardedRecordDataset(
            pattern, decode=_decode), batch_size=4, seed=3)

        def data_reset(step):
            if pipe.state()["batch"] != step:
                # a fresh start: rewind what the first window pulled
                pipe.load_state(pipe.state_at(step))
            return pf.DevicePrefetcher(pipe, depth=2)
        return pipe, pf.DevicePrefetcher(pipe, depth=2), data_reset

    def run(model, injector=None, on_step=None):
        pipe, first, reset = build()
        loop = el.ElasticLoop(model, tmp, save_every=3, keep=2,
                              pipeline=pipe, prefetcher=first,
                              data_reset=reset,
                              failure_injector=injector)

        def step_fn(i):
            b = np.asarray(next(loop.prefetcher))
            seen.append((i, b.copy()))
            return model.train(b)
        return loop, loop.run(step_fn, 12, on_step=on_step)

    def on_step(i, _loss):
        if i == stop_after:
            log.stop()

    with tm.cpu():
        _, out_a = run(model_cls(), on_step=on_step)
        model = model_cls()
        loop, out_b = run(model, injector=el.FailureInjector([fail_at]))
    manifest = loop.manager.pipeline_state(loop.manager.latest()[1])
    return out_a, out_b, seen, model, manifest


def test_pipeline_fed_loop_stops_restores_and_replays_the_batches(
        monkeypatch, tmp_path, shards):
    """A small model (`Linear` through `TrainStep`) trained by the loop
    from record shards through the pipeline and the prefetcher: stopped
    after step 5, resumed by a fresh job, failed at step 8 and restored
    from step 6 — every step trains on the stream's own batch and the
    final weights are bit-equal to an uninterrupted run's."""
    import mxnet_tpu_torch.data as tdata
    import mxnet_tpu_torch.parallel.prefetch as tpf
    pattern, samples = shards
    oracle = _oracle(samples)
    out_a, out_b, seen, model, manifest = _data_loop(
        monkeypatch, str(tmp_path / "ck"), telastic, tdata, tpf, pattern,
        LinearModel)
    assert out_a["status"] == "preempted" and out_a["step"] == 5
    assert out_b["status"] == "completed" and out_b["restores"] == 1
    assert [i for i, _ in seen] == [0, 1, 2, 3, 4, 5, 6, 7, 6, 7, 8, 9,
                                    10, 11]
    for i, b in seen:
        np.testing.assert_array_equal(b, oracle[i], err_msg=f"step {i}")
    ref = LinearModel()
    for b in oracle:
        ref.train(b)
    np.testing.assert_array_equal(model.state, ref.state)
    assert manifest["batch"] == 12


def test_pipeline_fed_loop_matches_jax(monkeypatch, tmp_path, shards):
    """The same scenario in both packages (a NumPy model): the same
    statuses, the same batches at every step, the same final state and
    the same ``data_pipeline`` manifest state."""
    import mxnet_tpu.data as jdata
    import mxnet_tpu.parallel.prefetch as jpf
    import mxnet_tpu_torch.data as tdata
    import mxnet_tpu_torch.parallel.prefetch as tpf
    pattern, _ = shards
    got = []
    for el, data, pf, d in ((telastic, tdata, tpf, "t"),
                            (jelastic, jdata, jpf, "j")):
        out_a, out_b, seen, model, manifest = _data_loop(
            monkeypatch, str(tmp_path / d), el, data, pf, pattern,
            NumpyModel)
        got.append(((out_a["status"], out_a["step"]),
                    (out_b["status"], out_b["step"], out_b["restores"]),
                    seen, model.state, manifest))
    t, j = got
    assert t[0] == j[0] and t[1] == j[1] and t[4] == j[4]
    assert [i for i, _ in t[2]] == [i for i, _ in j[2]]
    for (_, a), (_, b) in zip(t[2], j[2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[3], j[3])


def test_a_pipeline_with_a_prefetcher_needs_data_reset(tmp_path, shards):
    import mxnet_tpu_torch.data as tdata
    import mxnet_tpu_torch.parallel.prefetch as tpf
    pattern, _ = shards
    with tm.cpu():
        pipe = tdata.DataPipeline(tdata.ShardedRecordDataset(
            pattern, decode=_decode), batch_size=4, seed=3)
        pf = tpf.DevicePrefetcher(pipe)
    with pytest.raises(MXNetError, match="data_reset"):
        telastic.ElasticLoop(Counter(), str(tmp_path / "x"), pipeline=pipe,
                             prefetcher=pf)
    pf.close()
    # a pipeline alone is enough: the poison fast-forward skips a batch
    pipe = tdata.DataPipeline(tdata.ShardedRecordDataset(
        pattern, decode=_decode), batch_size=4, seed=3)
    loop = telastic.ElasticLoop(Counter(), str(tmp_path / "y"),
                                pipeline=pipe)
    loop.data_skip(1)
    assert pipe.state()["batch"] == 1


def test_watchdog_fires_on_silence_and_not_on_activity():
    import threading
    import time
    fired = threading.Event()
    with telastic.Watchdog(timeout=0.4, on_hang=fired.set) as w:
        for _ in range(3):
            time.sleep(0.1)
            w.ping()
        assert not w.fired
        assert fired.wait(timeout=2.0)
    assert w.fired


def test_sync_flags_single_process_identity():
    assert telastic.sync_flags(True, False, True) == \
        jelastic.sync_flags(True, False, True) == (True, False, True)
    assert telastic.sync_flag(False) is False


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoints_cross_between_the_packages(tmp_path, monkeypatch):
    """A checkpoint of JAX's step loads into the port's `TrainStep` and the
    port's into JAX's step: parameters, Adam state and the step count
    bit-equal (``tests/test_torch_checkpoint.py`` has the rest of the
    checkpoint cases)."""
    import jax
    monkeypatch.setenv("MXTPU_PALLAS", "reference")
    data = batches(3)
    js, weights = jax_step()
    for b in data[:2]:
        js(*jax_batch(b))
    jpath = str(tmp_path / "jax.npz")
    js.save(jpath)
    ts = torch_step(weights)
    ts.load(jpath)
    js.sync_params_to_block()
    _same(torch_params(ts), jax_params(js))
    for n in ts.diff_names:
        jleaves = jax.tree_util.tree_leaves(js.opt_state[n])
        for a, b in zip(ts.opt_state[n], jleaves):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=n)
    assert ts._t == js._t == 2

    # the port trains on and saves; JAX's step loads it
    ts.dispatch(*data[2])
    tpath = str(tmp_path / "port.npz")
    ts.save(tpath)
    js.load(tpath)
    _same(jax_params(js), torch_params(ts))
    for n in ts.diff_names:
        jleaves = jax.tree_util.tree_leaves(js.opt_state[n])
        for a, b in zip(ts.opt_state[n], jleaves):
            np.testing.assert_array_equal(np.asarray(b), a.numpy(),
                                          err_msg=n)
    assert js._t == ts._t == 3
    with np.load(tpath) as z:
        assert "meta:rng_seed" in z.files and "meta:t" in z.files
        # the port's dropout generators ride along; JAX's load skips them
        assert "meta:torch_generator:0" in z.files
