"""Port parity: `mxnet_tpu_torch.health` against ``mxnet_tpu.health`` on the
CPU (scenarios from ``tests/unittest/test_health.py``): the same probe
series raises the same anomalies (rule, step, details), the flight recorder
writes the same bundles, the watchdog fires on silence and not under
suppression, `enable` / `disable` install and restore the crash handlers.
The `TrainStep` side: probes ride the `StepHandle` and reach the monitor at
retire; with health off a step computes none and its weights are
bit-identical to a health-on step's that never skips.  (The probes'
values against JAX's step: ``tests/test_torch_elastic.py``.)  No test waits
on a timer more than 2 s."""
import math
import signal
import sys
import time

import numpy as np
import pytest
import torch

from torch_plane_common import (  # noqa: F401
    batches, clean_plane, jhealth, jtele, thealth, torch_step, ttele)

NAN, INF = float("nan"), float("inf")

SERIES = {
    "nonfinite": [(1, 2.0, 1.0, 0), (2, NAN, NAN, 12), (3, 2.0, 1.0, 0)],
    "loss_nan": [(1, NAN, 1.0, 0), (2, INF, 1.0, 0)],
    "spike": [(i, 1.0, 1.0, 0) for i in range(1, 10)] + [(10, 50.0, 1.0, 0),
                                                         (11, 1.0, 1.0, 0)],
    "spike_early": [(1, 1.0, 1.0, 0), (2, 99.0, 1.0, 0)],
    "grad_explosion": [(i, 1.0, 0.5, 0) for i in range(1, 10)] +
                      [(10, 1.0, 100.0, 0)],
    "norm_overflow": [(1, 1.0, INF, 0)],
    "nan_not_in_ema": [(i, 1.0, 1.0, 0) for i in range(1, 9)] +
                      [(9, NAN, NAN, 5)] + [(10, 9.0, 1.0, 0)],
}


def _anomalies(mod, series, scales=()):
    mon = mod.HealthMonitor(min_history=8)
    for step, loss, gn, bad in series:
        mon.observe(step, loss=loss, grad_norm=gn, nonfinite=bad)
    for s in scales:
        mon.note_loss_scale(s, step=None)
    return [{k: (str(v) if isinstance(v, float) and not math.isfinite(v)
                 else v) for k, v in a.items() if k != "time"}
            for a in mon.anomalies], mon.anomaly_count, mon.observations


@pytest.mark.parametrize("name", sorted(SERIES))
def test_same_probe_series_same_anomalies(name):
    ttele.enable()
    jtele.enable()
    got = _anomalies(thealth, SERIES[name])
    assert got == _anomalies(jhealth, SERIES[name])
    assert got[1] > 0 or name == "spike_early"


def test_loss_scale_collapse_once_per_episode():
    scales = [1024.0, 2.0, 1.0, 1.0, 8.0, 2.0]
    assert _anomalies(thealth, [], scales) == _anomalies(jhealth, [], scales)
    assert _anomalies(thealth, [], scales)[1] == 2


def test_loss_scaler_reports_its_scale():
    from mxnet_tpu.amp.loss_scaler import LossScaler as JScaler
    from mxnet_tpu_torch.amp.loss_scaler import LossScaler as TScaler
    thealth.enable()
    jhealth.enable()
    for cls in (TScaler, JScaler):
        sc = cls(init_scale=4.0, scale_window=2, tolerance=0.0)
        for ov in (True, True, True):
            sc.update_scale(ov)
        sc.backoff()
    rows = [[a["rule"] for a in mod.monitor().anomalies]
            for mod in (thealth, jhealth)]
    assert rows[0] == rows[1] == ["loss_scale_collapse"]
    assert ttele.registry().get("health_loss_scale").value() == 1.0


def test_flight_recorder_bundle_alike(tmp_path):
    keys = []
    for mod, tele in ((thealth, ttele), (jhealth, jtele)):
        rec = mod.FlightRecorder(crash_dir=str(tmp_path / mod.__name__),
                                 capacity=3)
        for i in range(5):
            rec.record_event({"event": "e", "step": i if i % 2 else None})
        assert [r["step"] for r in rec.events()] == [1, 3, 3]
        try:
            raise ValueError("boom")
        except ValueError:
            path = rec.flush("exception", exc_info=sys.exc_info())
        b = mod.read_bundle(path)
        assert b["exception"]["type"] == "ValueError"
        keys.append((sorted(b), [r["step"] for r in b["events"]]))
        assert mod.FlightRecorder(crash_dir=None).flush("x") is None
    assert keys[0] == keys[1]


def test_watchdog_fires_on_silence_and_stays_quiet_when_suppressed():
    ttele.enable()
    fired = []
    wd = thealth.HangWatchdog(0.2, poll=0.05, on_stall=fired.append).start()
    try:
        deadline = time.monotonic() + 2.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired and wd.stalls >= 1
        n = wd.stalls
        with thealth.suppress_stalls("kernel_build"):
            time.sleep(0.5)
            assert thealth.stalls_suppressed()
        assert wd.stalls == n
    finally:
        wd.stop()
    with pytest.raises(ValueError):
        thealth.HangWatchdog(0)
    with pytest.raises(ValueError):
        thealth.HangWatchdog(1, action="explode")


def test_enable_installs_and_disable_restores_handlers(monkeypatch):
    hook, term = sys.excepthook, signal.getsignal(signal.SIGTERM)
    thealth.enable()
    assert sys.excepthook is thealth._excepthook
    assert signal.getsignal(signal.SIGTERM) is thealth._on_sigterm
    assert ttele.enabled() and thealth.monitor() is not None
    thealth.disable()
    assert sys.excepthook is hook
    assert signal.getsignal(signal.SIGTERM) is term
    monkeypatch.setenv("MXTPU_STALL_TIMEOUT", "bad")
    assert thealth.stall_timeout() is None
    monkeypatch.setenv("MXTPU_STALL_TIMEOUT", "30")
    assert thealth.stall_timeout() == jhealth.stall_timeout() == 30.0
    monkeypatch.setenv("MXTPU_STALL_ACTION", "Nope")
    thealth.enable()                     # a bad env action degrades
    assert thealth.watchdog().action == "record"
    thealth.disable()


def test_beats_ages_and_healthz():
    thealth.beat("a")
    time.sleep(0.02)
    thealth.beat("b")
    ages = thealth.heartbeat_ages()
    assert ages["a"] >= ages["b"] >= 0
    assert thealth.clear_beat("a") and not thealth.clear_beat("a")
    hz = thealth.healthz()
    assert set(hz) == set(jhealth.healthz())


def test_step_probes_reach_the_monitor(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "reference")
    thealth.enable()
    step = torch_step(None)
    assert step._health_probes and not step._skip_nonfinite
    data = batches(3, nan_at=2)
    hs = [step.dispatch(*b) for b in data]
    assert step.drain() == 0
    mon = thealth.monitor()
    assert mon.observations == 3
    # without recovery the NaN step reaches the weights, so step 3 is
    # non-finite too
    assert [(a["step"], a["rule"]) for a in mon.anomalies] == [
        (2, "nonfinite_grads"), (2, "loss_nonfinite"),
        (3, "nonfinite_grads"), (3, "loss_nonfinite")]
    assert float(hs[0].probes["nonfinite"]) == 0
    assert float(hs[1].probes["nonfinite"]) > 0
    assert not all(torch.isfinite(p).all() for p in step.params.values())
    assert [e["ids"] for e in thealth._collect_inflight()
            if e["source"] == "TrainStep"][-1] == []


@pytest.mark.parametrize("route", ["reference", "kernel"])
def test_health_off_step_computes_no_probes_and_same_weights(monkeypatch,
                                                            route):
    monkeypatch.setenv("MXTPU_PALLAS", route)
    data = batches(3)
    off = torch_step(None)
    assert not off._health_probes
    hs = [off.dispatch(*b) for b in data]
    assert all(h.probes is None for h in hs)
    assert off.steps_in_flight() == 0     # the CPU finishes at once
    thealth.enable()
    from mxnet_tpu_torch import recovery
    recovery.enable()
    on = torch_step(None)
    assert on._skip_nonfinite
    hs_on = [on.dispatch(*b) for b in data]
    for n in off.param_names:
        assert torch.equal(off.params[n], on.params[n]), n
    for n in off.diff_names:
        for a, b in zip(off.opt_state[n], on.opt_state[n]):
            assert torch.equal(a, b), n
    np.testing.assert_array_equal([float(h.loss) for h in hs],
                                  [float(h.loss) for h in hs_on])
