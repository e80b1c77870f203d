"""Port parity: `mxnet_tpu_torch.tracing` against ``mxnet_tpu.tracing`` on
the CPU (scenarios from ``tests/unittest/test_tracing.py``): the same spans
give the same trees and Chrome events (names, parents, tracks, tags), the
clock sync the same offsets, the cost accountant the same MFU rows under
one peak (``MXTPU_PEAK_TFLOPS``).  FLOPs: JAX reads XLA's ``cost_analysis``,
the port counts with ``FlopCounterMode`` (`tracing.FlopCount`); on the same
matmuls both give 2·M·N·K.  The port's peaks are the H100's (989 TFLOP/s
bf16 and f16, 67 f32) and it has no TPU entry."""
import json

import numpy as np
import pytest
import torch

from torch_plane_common import (  # noqa: F401
    clean_plane, jtele, jtrace, torch_step, ttele, ttrace)


def _spans(mod):
    mod.enable()
    tr = mod.get_tracer("train")
    with tr.span("outer", step=1) as o:
        with tr.span("inner", kind="a"):
            pass
        m = tr.start_span("manual", parent=o.context(), track="dev")
    m.finish(extra=2)
    tr.record_span("posthoc", 1.0, 1.5, track="ckpt", step=3)
    with mod.span("other", tracer="run"):
        pass
    ev = mod.chrome_events()
    spans = [s for t in mod.tracers().values() for s in t.spans()]
    names = {s.span_id: s.name for s in spans}
    tree = {s.name: names.get(s.parent_id) for s in spans}
    rows = [(e["name"], e["ph"], e.get("cat"),
             {k: v for k, v in e["args"].items()
              if k not in ("trace_id", "span_id", "parent_id")})
            for e in ev if e["ph"] == "X"]
    meta = [(e["name"], e["args"]["name"]) for e in ev if e["ph"] == "M"]
    return tree, sorted(rows, key=str), sorted(meta)


def test_same_spans_same_tree_and_chrome_events():
    assert _spans(ttrace) == _spans(jtrace)


def test_chrome_export_file(tmp_path):
    ttrace.enable(dir=str(tmp_path))
    with ttrace.span("x", step=1):
        pass
    path = ttrace.export_chrome()
    doc = json.load(open(path))
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == ["x"]
    assert doc["otherData"]["exporter"] == "mxnet_tpu_torch.tracing"


def test_clock_sync_alike():
    got = []
    for mod in (ttrace, jtrace):
        cs = mod.ClockSync(window=3)
        cs.seed(5.0)
        seeded = cs.offset
        for ts, rts, tr in ((1.0, 11.2, 1.4), (2.0, 12.05, 2.1),
                            (3.0, 13.3, 3.5), (4.0, 14.0, 4.02)):
            cs.update(ts, rts, tr)
        got.append((seeded, cs.offset, cs.rtt, cs.samples,
                    cs.rebase(20.0)))
    assert got[0] == got[1]


def test_tracer_ingest_and_wire_alike():
    got = []
    for mod in (ttrace, jtrace):
        a = mod.get_tracer("a")
        with a.span("root", step=1):
            pass
        rows = [mod.span_to_wire(s) for s in a.drain()]
        b = mod.get_tracer("b")
        assert b.ingest(rows + [{"bad": 1}], offset=0.5, pid=7,
                        replica="r0") == 1
        s = b.spans()[0]
        got.append((s.name, s.tags, s.pid, s.trace_id.split("-")[0]))
    assert got[0] == got[1]


def test_cost_accountant_rows_alike_under_one_peak(monkeypatch):
    monkeypatch.setenv("MXTPU_PEAK_TFLOPS", "100")
    rows = []
    for mod, tele in ((ttrace, ttele), (jtrace, jtele)):
        tele.enable()
        acc = mod.account()
        acc.record_features("k", {"flops": 2e12, "bytes_accessed": 5e9,
                                  "hbm_bytes_est": 1e9}, kind="train_step")
        row = mod.note_step_cost("k", 0.04, device="cpu")
        mfu = tele.registry().get("mfu_estimate").value(program="train_step")
        rows.append((row, mfu))
        assert mod.note_step_cost("missing", 1.0) is None
    assert rows[0] == rows[1]
    assert rows[0][0]["mfu_estimate"] == pytest.approx(0.5)


def test_h100_peaks_and_projection(monkeypatch):
    assert ttrace.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert ttrace.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert ttrace.peak_flops("NVIDIA H100", torch.float16) == 989e12
    assert ttrace.peak_flops("tpu v5e") == 989e12    # no TPU entry
    assert ttrace.projected_peak_flops() == (989e12, "h100")
    monkeypatch.setenv("MXTPU_PEAK_TFLOPS", "10")
    assert ttrace.peak_flops("NVIDIA H100") == 10e12
    est = ttrace.estimate_mfu(1e12, 1.0, device="cpu", dtype="float32")
    assert est["projected"] and est["mfu_estimate"] == pytest.approx(0.1)


@pytest.mark.parametrize("M,K,N", [(8, 16, 4), (33, 7, 65)])
def test_flop_count_matches_xla_cost_analysis(M, K, N):
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    c = rng.randn(N, 3).astype(np.float32)
    compiled = jax.jit(lambda x, y, z: jnp.dot(jnp.dot(x, y), z)).lower(
        a, b, c).compile()
    want = jtrace.cost_features_of(compiled)["flops"]
    with ttrace.FlopCount() as fc:
        torch.from_numpy(a) @ torch.from_numpy(b) @ torch.from_numpy(c)
    got = ttrace.cost_features_of(fc)
    assert got["flops"] == want == 2 * M * K * N + 2 * M * N * 3
    assert got["kernel_flops"] == 0


def test_kernel_flops_are_noted_only_inside_a_count():
    ttrace.note_kernel_flops("flash_attention_fwd", 1e6)   # no-op
    with ttrace.FlopCount() as fc:
        ttrace.note_kernel_flops("flash_attention_fwd", 4e6)
        ttrace.note_kernel_flops("flash_attention_bwd", 1e7)
    f = fc.features()
    assert f["kernel_flops"] == 1.4e7 and f["flops"] == 1.4e7
    assert f["kernel_flops_by_op"] == {"flash_attention_fwd": 4e6,
                                       "flash_attention_bwd": 1e7}


def test_train_step_counts_its_flops_at_warmup(monkeypatch):
    from torch_plane_common import batches
    monkeypatch.setenv("MXTPU_PALLAS", "reference")
    ttele.enable()
    ttrace.enable()
    step = torch_step(None)
    b = batches(2)
    assert step.cost_features() is None
    step.warmup(*b[0])
    feats = step.cost_features()
    assert feats["flops"] > 0 and feats["torch_flops"] == feats["flops"]
    h = step.dispatch(*b[1])
    step.drain()
    assert h.probes is None                 # health off: no probes
    mfu = step.mfu_estimate(0.01)
    assert mfu["projected"] and mfu["mfu_estimate"] > 0
    names = [s.name for s in ttrace.get_tracer("train").spans()]
    assert names.count("train.compile") == 1
    assert "train.dispatch" in names and "train.device" in names
