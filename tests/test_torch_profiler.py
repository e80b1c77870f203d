"""Port parity: `mxnet_tpu_torch.profiler` against ``mxnet_tpu.profiler``
on the CPU (scenarios from ``tests/unittest/test_profiler.py``): MXNet's
``set_config`` / ``set_state`` / ``start`` / ``stop`` / ``pause`` /
``resume`` / ``dump`` / ``dumps`` over ``torch.profiler``.  The same user
scopes, markers and counters give the same aggregate rows (names, counts)
and the same counter values; `dump` writes one Chrome trace holding the
scopes and the session's torch ops."""
import json

import pytest
import torch

from torch_plane_common import clean_plane  # noqa: F401

import mxnet_tpu.profiler as jprof
import mxnet_tpu_torch.profiler as tprof


@pytest.fixture(autouse=True)
def _profilers_stopped():
    for mod in (tprof, jprof):
        mod.stop()
        mod.dumps(reset=True)
    yield
    for mod in (tprof, jprof):
        mod.stop()
        mod.dumps(reset=True)
        mod._config.update(aggregate_stats=False, filename="profile_output")


def _session(mod, path):
    mod.set_config(filename=str(path), aggregate_stats=True)
    assert mod.state() == "STOPPED"
    mod.start()
    assert mod.state() == "RUNNING"
    for _ in range(3):
        with mod.scope("fwd"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    t = mod.Task("task")
    t.start()
    t.stop()
    mod.Marker("m").mark()
    c = mod.Counter("seen", value=2)
    c.increment(3)
    c.decrement()
    mod.pause()
    with mod.scope("fwd"):               # scopes record while paused
        pass
    mod.resume()
    out = mod.dump()
    assert mod.state() == "STOPPED"
    stats = json.loads(mod.dumps(format="json"))
    return out, {k: v["Count"] for k, v in stats["Time"].items()}, \
        stats["Counters"]


def test_same_scopes_same_rows_and_counters(tmp_path):
    _, t_rows, t_counters = _session(tprof, tmp_path / "t")
    _, j_rows, j_counters = _session(jprof, tmp_path / "j")
    assert t_rows == j_rows == {"fwd": 4, "task": 1, "marker:m": 1}
    assert t_counters == j_counters == {"seen": 4}


def test_dump_writes_scopes_and_torch_ops(tmp_path):
    out, _, _ = _session(tprof, tmp_path / "trace")
    assert out == str(tmp_path / "trace") + ".json"
    doc = json.load(open(out))
    names = [e.get("name") for e in doc["traceEvents"]]
    assert names.count("fwd") >= 4            # scopes (and their ranges)
    assert any("mm" in str(n) for n in names)
    table = tprof.dumps()
    assert "User scopes" in table and "fwd" in table
    assert "Operators (last session)" in table


def test_set_state_and_table_sorting():
    tprof.set_state("run")
    assert tprof.state() == "RUNNING"
    with tprof.scope("a"):
        pass
    with tprof.scope("a"):
        pass
    with tprof.scope("b"):
        pass
    tprof.set_state("stop")
    rows = json.loads(tprof.dumps(format="json", sort_by="count"))["Time"]
    assert list(rows) == ["a", "b"]
    with pytest.raises(ValueError):
        tprof.set_state("paused")
    tprof.dumps(reset=True)
    assert json.loads(tprof.dumps(format="json"))["Time"] == {}


def test_step_annotation_is_a_record_function_range():
    with torch.profiler.profile() as prof:
        with tprof.step_annotation("train", step_num=3):
            torch.ones(2) + 1
    assert any(e.name == "train#3" for e in prof.events())
