"""Port parity: `mxnet_tpu_torch.telemetry` against ``mxnet_tpu.telemetry``
on the CPU (scenarios from ``tests/unittest/test_telemetry.py``): the same
updates give the same snapshot, Prometheus text and JSON-safe values; the
journal writes the same rows; the same misuse raises alike.  The memory
monitor reads ``torch.cuda.memory_stats`` in place of JAX's live arrays
(on the CPU: host RSS only)."""
import json
import math

import pytest

from torch_plane_common import clean_plane, jtele, ttele  # noqa: F401

from mxnet_tpu_torch.base import MXNetError


def _drive(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("steps_total", "Steps", labelnames=("kind",))
    c.inc(kind="train")
    c.inc(2.5, kind="eval")
    g = reg.gauge("in_flight", 'Steps "in" flight\nsecond line')
    g.set(3)
    g.dec(1)
    g.inc(0.5)
    h = reg.histogram("lat_ms", "Latency", labelnames=("op",),
                      buckets=(1.0, 5.0, 25.0))
    for v in (0.2, 1.0, 3.0, 30.0, float("inf")):
        h.observe(v, op='a"b')
    reg.gauge("weird", "").set(float("nan"))
    lab = reg.gauge("gone", "", labelnames=("r",))
    lab.set(1, r="x")
    lab.set(2, r="y")
    lab.remove(r="x")
    reg.add_collector(lambda: {"fed": {"type": "gauge", "help": "f",
                                       "series": [{"labels": {"r": "1"},
                                                   "value": 7}]}})
    return reg


def test_same_updates_same_snapshot_and_prometheus():
    t, j = _drive(ttele), _drive(jtele)
    assert ttele.json_safe(t.snapshot()) == jtele.json_safe(j.snapshot())
    assert t.to_prometheus() == j.to_prometheus()
    assert json.loads(t.to_json())["metrics"] == \
        json.loads(j.to_json())["metrics"]
    assert t.names() == j.names()


@pytest.mark.parametrize("bad", ["name", "labels", "kind", "buckets",
                                 "negative", "rebucket"])
def test_same_misuse_raises_alike(bad):
    msgs = []
    for mod in (ttele, jtele):
        reg = mod.MetricsRegistry()
        reg.counter("c", labelnames=("a",))
        reg.histogram("h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError) as e:
            if bad == "name":
                reg.counter("9bad")
            elif bad == "labels":
                reg.counter("c", labelnames=("a",)).inc(b=1)
            elif bad == "kind":
                reg.gauge("c")
            elif bad == "buckets":
                reg.histogram("h2", buckets=(2.0, 1.0))
            elif bad == "negative":
                reg.counter("c", labelnames=("a",)).inc(-1, a=1)
            else:
                reg.histogram("h", buckets=(1.0, 3.0))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_json_safe_alike():
    obj = {"a": [1.0, float("nan"), float("inf"), -float("inf")],
           "b": ({"c": 2},), "d": "s"}
    assert ttele.json_safe(obj) == jtele.json_safe(obj)
    assert ttele.json_safe(obj)["a"][1] == "NaN"


def test_journal_rows_alike(tmp_path):
    rows = []
    for mod, name in ((ttele, "t.jsonl"), (jtele, "j.jsonl")):
        path = str(tmp_path / name)
        mod.enable(journal_path=path)
        mod.event("step_dispatched", step=3, dispatch_ms=1.5)
        mod.event("checkpoint_write", path="x", ms=float("nan"))
        mod.event("step_retired", step=4)
        mod.disable()
        mod.event("dropped", step=9)          # disabled: nothing written
        got = mod.RunJournal.read(path)
        rows.append([{k: v for k, v in r.items() if k != "ts"}
                     for r in got])
        assert mod.RunJournal.tail(path, 2) == got[-2:]
    assert rows[0] == rows[1]
    assert [r["step"] for r in rows[0]] == [3, 3, 4]


def test_event_taps_see_every_event():
    seen = {}
    for mod in (ttele, jtele):
        got = []
        mod.add_event_tap(got.append)
        mod.enable()
        mod.event("anomaly", step=2, rule="r")
        mod.remove_event_tap(got.append)
        mod.event("anomaly", step=3, rule="r")
        mod.disable()
        seen[mod] = [{k: v for k, v in r.items() if k != "ts"}
                     for r in got]
    assert seen[ttele] == seen[jtele] == [
        {"event": "anomaly", "step": 2, "rule": "r"}]


def test_memory_monitor_host_rss_on_the_cpu():
    reg = ttele.MetricsRegistry()
    mon = ttele.MemoryMonitor(interval=60.0, registry=reg)
    out = mon.sample_once()
    assert out["live_bytes"] == {} and out["memory_stats"] == {}
    assert out["host_rss"] > 0
    assert reg.get("host_rss_bytes").value() == out["host_rss"]
    mon.start()
    mon.stop()


def test_metrics_server_serves_the_registry():
    import urllib.request
    ttele.enable()
    ttele.counter("served_total", "x").inc()
    srv = ttele.serve_metrics(port=0)
    # loopback only, and never through a proxy the environment names
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(f"http://127.0.0.1:{srv.port}/metrics",
                         timeout=2) as r:
            body = r.read().decode()
        with opener.open(f"http://127.0.0.1:{srv.port}/healthz",
                         timeout=2) as r:
            hz = json.loads(r.read())
    finally:
        srv.stop()
    assert "served_total 1" in body
    assert "heartbeats" in hz and "steps_in_flight" in hz


def test_compile_cache_listener_names_its_item():
    with pytest.raises(MXNetError, match="A1"):
        ttele.install_compile_cache_listener()


def test_enabled_gate_and_fmt():
    assert not ttele.enabled()
    ttele.enable()
    assert ttele.enabled()
    ttele.disable()
    assert ttele._fmt_val(float("nan")) == jtele._fmt_val(float("nan"))
    assert ttele._fmt_val(math.inf) == "+Inf"
