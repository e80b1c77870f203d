"""Port parity: `mxnet_tpu_torch.resilience` against
``mxnet_tpu.resilience`` on the CPU (scenarios from
``tests/unittest/test_resilience.py``): the same ``MXTPU_FAULT_SPEC`` fires
the same points at the same hits with the same actions, bad specs fail the
same way, and `retry_with_backoff` waits the same delays under the same
seed.  Exact equality throughout (no arithmetic differs)."""
import random

import pytest

from torch_plane_common import clean_plane, jres, tres  # noqa: F401

POINTS = ["ckpt_write", "ckpt_read", "ckpt_write", "elastic_step",
          "ckpt_write", "elastic_step", "ckpt_read", "elastic_step",
          "worker_exec", "elastic_step"]


def _fire_all(mod, spec, monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_SPEC", spec)
    out = []
    for name in POINTS:
        try:
            mod.fault_point(name)
            out.append((name, None))
        except BaseException as e:  # FaultExit is a BaseException
            out.append((name, type(e).__name__, str(e)))
    reg = mod.fault_registry()
    return out, {n: reg.hits(n) for n in set(POINTS)}, reg.armed


@pytest.mark.parametrize("spec", [
    "", "ckpt_write@2", "ckpt_read@1:OSError,elastic_step@3",
    "elastic_step@1,elastic_step@4:ValueError,ckpt_write@3:exit",
    " ckpt_write@1 , worker_exec@1:kill ", "unused_point@1"])
def test_same_spec_fires_same_points_and_hits(monkeypatch, spec):
    assert _fire_all(tres, spec, monkeypatch) == \
        _fire_all(jres, spec, monkeypatch)


@pytest.mark.parametrize("spec", ["noat", "x@0", "x@y", "x@1:NotAnError",
                                  "x@-2"])
def test_bad_specs_raise_alike(spec):
    msgs = []
    for mod in (tres, jres):
        with pytest.raises(ValueError) as e:
            mod.FaultRegistry(spec)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_registry_reparses_when_the_env_changes(monkeypatch):
    for mod in (tres, jres):
        monkeypatch.setenv("MXTPU_FAULT_SPEC", "a@1")
        with pytest.raises(mod.FaultInjected):
            mod.fault_point("a")
        mod.fault_point("a")                # fired once only
        monkeypatch.setenv("MXTPU_FAULT_SPEC", "a@1,b@1")
        with pytest.raises(mod.FaultInjected):
            mod.fault_point("a")            # fresh counters
        assert mod.fault_registry().hits("a") == 1


def _retry_run(mod, seed, fails, **kw):
    random.seed(seed)
    delays, calls = [], [0]
    t = [0.0]

    def fn():
        calls[0] += 1
        if calls[0] <= fails:
            raise OSError(f"blip {calls[0]}")
        return "ok"

    def sleep(d):
        delays.append(d)
        t[0] += d

    try:
        res = mod.retry_with_backoff(fn, sleep=sleep, clock=lambda: t[0],
                                     **kw)
    except OSError as e:
        res = f"raised {e}"
    return res, delays, calls[0]


@pytest.mark.parametrize("seed,fails,kw", [
    (0, 2, {}), (3, 5, {"retries": 3}),
    (7, 4, {"retries": 6, "full_jitter": True}),
    (11, 6, {"retries": 8, "base_delay": 0.5, "max_delay": 1.0}),
    (5, 6, {"retries": 8, "max_elapsed": 1.0}),
    (9, 1, {"jitter": 0.0})])
def test_retry_waits_the_same_delays_under_one_seed(seed, fails, kw):
    assert _retry_run(tres, seed, fails, **kw) == \
        _retry_run(jres, seed, fails, **kw)


def test_retry_only_the_allowlist_and_never_base_exceptions():
    for mod in (tres, jres):
        with pytest.raises(ValueError):
            mod.retry_with_backoff(lambda: (_ for _ in ()).throw(
                ValueError("typo")), sleep=lambda d: None)
        calls = []

        def exit_fn():
            calls.append(1)
            raise mod.FaultExit("p", 1)

        with pytest.raises(mod.FaultExit):
            mod.retry_with_backoff(exit_fn, retry_on=(BaseException,),
                                   sleep=lambda d: None)
        assert calls == [1]
