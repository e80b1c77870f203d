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


@pytest.mark.parametrize("kw,item", [("mesh_controller", "A12"),
                                     ("pipeline", "A13"),
                                     ("prefetcher", "A13")])
def test_unported_parts_raise_naming_their_item(tmp_path, kw, item):
    with pytest.raises(MXNetError, match=item):
        telastic.ElasticLoop(Counter(), str(tmp_path), **{kw: object()})


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
