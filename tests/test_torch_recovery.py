"""Port parity: `mxnet_tpu_torch.recovery` against ``mxnet_tpu.recovery``
on the CPU (scenarios from ``tests/unittest/test_recovery.py``): the same
anomaly series gets the same tier decisions, skips, poison windows and
loss-scale backoffs; the health tag and resume marker agree; the elastic
rollback lands on the same checkpoint.  The port's tier-1 skip on the
device: after a NaN step the weights and Adam state are bit-equal to the
step's before, on the reference route and on the kernel route (the
kernels' plain versions on the CPU).  `agree_step` and
`elastic.sync_flags` run as `torch.distributed` collectives across two
``gloo`` processes."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_plane_common import (  # noqa: F401
    batches, clean_plane, jelastic, jhealth, jrecovery, jtele, telastic,
    thealth, torch_step, trecovery, ttele)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scalers():
    from mxnet_tpu.amp.loss_scaler import LossScaler as J
    from mxnet_tpu_torch.amp.loss_scaler import LossScaler as T
    return T, J


SERIES = {
    "skips_under_budget": [("nonfinite_grads", 5), ("loss_nonfinite", 5),
                           ("loss_nonfinite", 9)],
    "skip_budget": [("nonfinite_grads", s) for s in range(1, 6)],
    "divergence": [("loss_spike", 10), ("grad_explosion", 11),
                   ("loss_spike", 11), ("grad_explosion", 12)],
    "divergence_broken": [("loss_spike", 10), ("loss_spike", 12),
                          ("loss_spike", 13)],
    "rollback_budget": [("loss_spike", s) for s in range(1, 13)],
    "collapse_only": [("loss_scale_collapse", None)],
}


def _ladder(mod, scaler_cls, series):
    scaler = scaler_cls(init_scale=2.0 ** 16)
    pol = mod.RecoveryPolicy(skip_budget=3, rollback_budget=1,
                             divergence_patience=3, scaler=scaler)
    out = []
    for rule, step in series:
        pol.on_anomaly({"rule": rule, "step": step})
        act = pol.poll()
        if act is not None and act["kind"] == "rollback":
            pol.note_rollback(0)
        out.append(act)
    st = pol.stats()
    return out, st, scaler.loss_scale


@pytest.mark.parametrize("name", sorted(SERIES))
def test_same_anomalies_same_tier_decisions(name):
    T, J = _scalers()
    got = _ladder(trecovery, T, SERIES[name])
    assert got == _ladder(jrecovery, J, SERIES[name])


def test_backoff_defers_to_the_amp_loop_alike():
    T, J = _scalers()
    res = []
    for mod, cls in ((trecovery, T), (jrecovery, J)):
        sc = cls(init_scale=1024.0, tolerance=0.0)
        sc.update_scale(True)               # the loop shrank already
        pol = mod.RecoveryPolicy(scaler=sc)
        pol.on_anomaly({"rule": "nonfinite_grads", "step": 1})
        sc2 = cls(init_scale=1024.0, tolerance=0.9)
        sc2.update_scale(True)              # merely tolerated
        pol2 = mod.RecoveryPolicy(scaler=sc2)
        pol2.on_anomaly({"rule": "nonfinite_grads", "step": 1})
        res.append((sc.loss_scale, sc2.loss_scale))
    assert res[0] == res[1] == (512.0, 512.0)


def test_health_snapshot_and_env_budgets(monkeypatch):
    snaps = []
    for mod, hl in ((trecovery, thealth), (jrecovery, jhealth)):
        assert mod.health_snapshot(3) is None          # health off
        mod.enable()
        mon = hl.monitor()
        mon.observe(4, loss=1.0, grad_norm=float("nan"), nonfinite=0)
        snaps.append((mod.health_snapshot(10), mod.health_snapshot(30)))
        mod.disable()
        hl.disable()
    assert snaps[0] == snaps[1]
    assert snaps[0][0]["healthy"] is False and snaps[0][1]["healthy"]
    monkeypatch.setenv("MXTPU_SKIP_BUDGET", "2")
    monkeypatch.setenv("MXTPU_ROLLBACK_BUDGET", "bad")
    t, j = trecovery.RecoveryPolicy(), jrecovery.RecoveryPolicy()
    assert (t.skip_budget, t.rollback_budget) == \
        (j.skip_budget, j.rollback_budget) == (2, 2)


def test_resume_marker_alike(tmp_path):
    rows = []
    for mod in (trecovery, jrecovery):
        d = str(tmp_path / mod.__name__)
        os.makedirs(d)
        assert mod.read_resume_marker(d) is None
        mod.write_resume_marker(d, {"step": 7, "checkpoint": "c",
                                    "complete": True, "x": float("nan")})
        m = mod.read_resume_marker(d)
        rows.append({k: v for k, v in m.items() if k != "time"})
        mod.clear_resume_marker(d)
        assert mod.read_resume_marker(d) is None
    assert rows[0] == rows[1]
    assert trecovery.MARKER_NAME == jrecovery.MARKER_NAME


class Target:
    def __init__(self):
        self.state = np.zeros(2)

    def apply(self, i):
        self.state = self.state + i

    def save(self, path):
        with open(path, "wb") as f:
            np.savez(f, state=self.state)

    def load(self, path):
        with np.load(path) as z:
            self.state = z["state"]


def _rollback_run(pkg, rec, hl, tmp):
    rec.enable()
    t = Target()
    seen = []
    loop = pkg.ElasticLoop(t, tmp, save_every=2, keep=5)
    mon = hl.monitor()

    def step(i):
        seen.append(i)
        t.apply(i)
        if i in (6, 7, 8) and len(seen) < 12:
            mon.observe(i + 1, loss=1.0, grad_norm=1.0, nonfinite=0)
            for rule in ("loss_spike",):
                mon._notify([{"rule": rule, "step": i + 1}])

    out = loop.run(step, 12)
    res = ({k: out[k] for k in ("status", "step", "restores",
                                "rollbacks")}, seen, t.state.tolist(),
           [s for s, _ in loop.manager.checkpoints()])
    rec.disable()
    hl.disable()
    return res


def test_elastic_rollback_lands_alike(tmp_path):
    got = _rollback_run(telastic, trecovery, thealth, str(tmp_path / "t"))
    want = _rollback_run(jelastic, jrecovery, jhealth, str(tmp_path / "j"))
    assert got == want
    assert got[0]["rollbacks"] == 1


@pytest.mark.parametrize("route", ["reference", "kernel"])
def test_tier1_skip_keeps_weights_and_state_bit_exact(monkeypatch, route):
    monkeypatch.setenv("MXTPU_PALLAS", route)
    trecovery.enable()
    step = torch_step(None)
    assert step._skip_nonfinite
    assert step._fused_opt_kernel == (route == "kernel")
    data = batches(4, nan_at=3)
    for b in data[:2]:
        step.dispatch(*b)
    before = {n: p.detach().clone() for n, p in step.params.items()}
    state = {n: [s.clone() for s in step.opt_state[n]]
             for n in step.diff_names}
    h = step.dispatch(*data[2])
    assert float(h.probes["nonfinite"]) > 0
    for n, p in step.params.items():
        assert torch.equal(p, before[n]), n
    for n in step.diff_names:
        for a, b in zip(step.opt_state[n], state[n]):
            assert torch.equal(a, b), n
    step.dispatch(*data[3])                 # a clean step applies again
    assert any(not torch.equal(p, before[n])
               for n, p in step.params.items())
    assert [a["rule"] for a in thealth.monitor().anomalies] == [
        "nonfinite_grads", "loss_nonfinite"]


def test_agree_step_and_sync_flags_single_process():
    assert trecovery.agree_step(17) == jrecovery.agree_step(17) == 17


_COLLECTIVE = r"""
import os, sys
import torch.distributed as dist
sys.path.insert(0, {repo!r})
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        world_size=2, rank=rank)
from mxnet_tpu_torch import elastic, recovery
a = recovery.agree_step(10 + 5 * rank)
f = elastic.sync_flags(rank == 1, False, rank == 0)
print("RESULT", a, f, flush=True)
dist.destroy_process_group()
"""


def test_agree_step_and_sync_flags_across_two_processes(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "coll.py"
    script.write_text(_COLLECTIVE.format(repo=REPO))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXTPU_")}
    env["MXTPU_ELASTIC_SYNC_TIMEOUT"] = "20"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for out in outs:
        assert "RESULT 10 (True, False, True)" in out, outs
