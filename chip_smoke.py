#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` and drives its
serving main path at full GPT-2-small width and depth (12 layers, hidden
768, vocab 50257, seeded random weights):

1. prints the card (name and power limit from ``nvidia-smi``) and the
   torch / CUDA versions;
2. holds each kernel against its plain PyTorch version at the slice's
   shapes — K1 ragged paged attention (f32/bf16, decode C=1 and prefill
   C=16, MHA and GQA rep 4, ragged context lengths with an empty slot and
   non-page-aligned lengths, with and without a window) and K2 int8/int4
   dequant-matmul (f32/bf16 activations, M in {8, 128}, the four GPT-2
   projection shapes) — within max-abs 1e-4 (f32) / 2e-2 (bf16) of the
   output scale, and times kernel, plain version, a one-call library
   yardstick (never used by the port) and the card's bound;
3. serves 16 greedy requests (prompts of 16-256 tokens, 32 new tokens,
   staggered arrivals) through ``InferenceEngine`` with
   ``ServeConfig(max_slots=8, max_len=512, page_size=16, prefill_chunk=16)``
   in float32, checks K1 launched 12 times per fused step, and holds every
   stream against the same engine built on the plain versions and against
   ``GPTForCausalLM.generate`` — a divergence is accepted only where the
   plain path's top-2 logit gap is below 1e-4;
4. the same at ``quant_bits=8`` and ``quant_bits=4`` (K2 must launch);
5. bfloat16 end to end, reporting the share of streams equal to the plain
   path's.

Every count is reset just before a run it reports and read just after.
The last three stdout lines are the ``nvidia-smi`` card line, the
``kernels`` JSON and ``{"ok": true, "device": {...}}``; the full per-case
results go to ``--out``.  Any failed phase exits non-zero without
that last line; so does a machine without a CUDA device, or a directory
that holds this script alone.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
GAP = 1e-4            # near-tie threshold on the plain path's top-2 gap
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # max-abs / output scale
HBM_BPS = 3.35e12     # H100 SXM HBM3
PEAK = {"float32": 67e12, "bfloat16": 989e12}   # FMA f32 / dense bf16 TC


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters=30, warm=3):
    """Median device time of one call (CUDA events around each call), with
    the 50 MB L2 flushed before each: the serving loop finds weights and
    K/V pages cold, so a timing that reuses warm inputs would flatter."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in evs)
    return ts[len(ts) // 2]


def bound(nbytes, flops, dtype):
    """Least time (ms) for the work: bytes over HBM rate vs operations
    over the peak rate of the input type; whichever is larger."""
    tb = nbytes / HBM_BPS * 1e3
    to = flops / PEAK[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_cases(dev):
    """K1 at the main path's shapes: 8 slots, 12 heads, D 64, page 16, a
    257-page pool, 32 table entries per slot (max_len 512)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import paged_attention as pa

    B, H, D, ps, maxp = 8, 12, 64, 16, 32
    npages = B * maxp + 1
    rng = np.random.RandomState(0)
    start = np.array([0, 37, 100, 255, 300, 0, 470, 16], np.int32)
    out = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for C in (1, 16):
            nt = np.array([C, C, min(C, 5), C, 1, 0, C, C], np.int32)
            ctx = start + nt
            for Hkv in (12, 3):
                for window in (None, 64):
                    q = torch.from_numpy(rng.randn(B, H, C, D).astype(
                        np.float32)).to(dev, dt)
                    kp = torch.from_numpy(rng.randn(npages, ps, Hkv, D)
                                          .astype(np.float32)).to(dev, dt)
                    vp = torch.from_numpy(rng.randn(npages, ps, Hkv, D)
                                          .astype(np.float32)).to(dev, dt)
                    pt = torch.from_numpy((rng.permutation(npages - 1)
                                           + 1).reshape(B, maxp)
                                          .astype(np.int32)).to(dev)
                    ctx_t = torch.from_numpy(ctx).to(dev)
                    st_t = torch.from_numpy(start).to(dev)
                    args = (q, kp, vp, pt, ctx_t, st_t)
                    got = pa.ragged_paged_attention(*args, window=window)
                    ref = pa.paged_attention_reference(*args,
                                                       window=window)
                    torch.cuda.synchronize()
                    err = scale = 0.0
                    for b in range(B):
                        n = int(nt[b])
                        if n == 0:
                            continue
                        d = (got[b, :, :n].float() - ref[b, :, :n].float())
                        err = max(err, float(d.abs().max()))
                        scale = max(scale,
                                    float(ref[b, :, :n].float().abs().max()))
                    # library yardstick: SDPA over a pre-gathered,
                    # head-expanded context with the same boolean mask
                    L = maxp * ps
                    kc = pa.gather_pages(kp, pt).permute(0, 2, 1, 3)
                    vc = pa.gather_pages(vp, pt).permute(0, 2, 1, 3)
                    kc = kc.repeat_interleave(H // Hkv, 1).contiguous()
                    vc = vc.repeat_interleave(H // Hkv, 1).contiguous()
                    t_idx = torch.arange(L, device=dev)
                    qpos = st_t[:, None] + torch.arange(C, device=dev)
                    mask = (t_idx[None, None, :] <= qpos[:, :, None]) & \
                        (t_idx[None, None, :] < ctx_t[:, None, None])
                    if window is not None:
                        mask &= t_idx[None, None, :] >= \
                            qpos[:, :, None] - window
                    mask = mask[:, None]
                    sdpa = torch.nn.functional.scaled_dot_product_attention
                    case = dict(dtype=dtype, C=C, Hkv=Hkv, window=window,
                                max_abs_err=err, out_scale=scale,
                                tol=TOL[dtype] * scale,
                                ok=err <= TOL[dtype] * scale)
                    case["ms"] = time_ms(lambda: pa.ragged_paged_attention(
                        *args, window=window))
                    case["plain_ms"] = time_ms(
                        lambda: pa.paged_attention_reference(
                            *args, window=window))
                    case["library_ms"] = time_ms(lambda: sdpa(
                        q, kc, vc, attn_mask=mask))
                    # the work this data needs: q + the K/V rows below
                    # ctx (from the window's floor) + out + indices
                    item = q.element_size()
                    keys = sum(int(c) - (max(0, int(s) - window)
                                         if window is not None else 0)
                               for s, c in zip(start, ctx))
                    attended = 0
                    for s, n in zip(start, nt):
                        for c in range(int(n)):
                            p = int(s) + c
                            lo = max(0, p - window) if window is not None \
                                else 0
                            attended += p - lo + 1
                    nbytes = 2 * q.numel() * item \
                        + 2 * keys * Hkv * D * item + 4 * (B * maxp + 2 * B)
                    flops = 4.0 * attended * H * D
                    case["bound_ms"], case["bound_by"] = bound(
                        nbytes, flops, dtype)
                    out.append(case)
    return out


K2_SHAPES = [(2304, 768), (768, 768), (3072, 768), (768, 3072)]


def k2_cases(dev):
    """K2 at GPT-2 small's projection shapes (N, K) for M in {8, 128}."""
    import torch
    from mxnet_tpu_torch.ops import quantized_matmul as qm

    g = torch.Generator().manual_seed(1)
    out = []
    for bits in (8, 4):
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for M in (8, 128):
                for N, K in K2_SHAPES:
                    qt = qm.quantize_weight(
                        torch.randn(N, K, generator=g) * 0.02, bits).to(dev)
                    x = torch.randn(M, K, generator=g).to(dev, dt)
                    got = qm.quantized_matmul(x, qt)
                    ref = qm.quantized_matmul_reference(x, qt)
                    torch.cuda.synchronize()
                    err = float((got.float() - ref.float()).abs().max())
                    scale = float(ref.float().abs().max())
                    wd = qm.dequantize_weight(qt, dt)
                    case = dict(bits=bits, dtype=dtype, M=M, N=N, K=K,
                                max_abs_err=err, out_scale=scale,
                                tol=TOL[dtype] * scale,
                                ok=err <= TOL[dtype] * scale)
                    case["ms"] = time_ms(lambda: qm.quantized_matmul(x, qt))
                    case["plain_ms"] = time_ms(
                        lambda: qm.quantized_matmul_reference(x, qt))
                    case["library_ms"] = time_ms(lambda: x @ wd.T)
                    nbytes = x.numel() * x.element_size() + qt.nbytes() \
                        + M * N * x.element_size()
                    case["bound_ms"], case["bound_by"] = bound(
                        nbytes, 2.0 * M * N * K, dtype)
                    out.append(case)
    return out


# ---------------------------------------------------------------------------
# phases 3-5: the serving main path end to end
# ---------------------------------------------------------------------------

def make_prompts(vocab, n=16, lo=16, hi=256, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, n)
    lens[0], lens[1] = lo, hi             # both ends of the range
    return [rng.randint(0, vocab, int(k)).tolist() for k in lens]


def drive(engine, prompts, max_new):
    """Serve `prompts` with staggered arrivals (a burst of 8, then one
    every other step) so prefill and decode mix and slots churn.  Returns
    (streams, stats)."""
    import torch
    handles, step_ms = [], []
    t0 = time.perf_counter()
    for p in prompts[:8]:
        handles.append(engine.submit(p, max_new_tokens=max_new))
    arrivals = iter(prompts[8:])
    polls = 0
    while True:
        ts = time.perf_counter()
        progressed = engine.step()
        if progressed:
            step_ms.append((time.perf_counter() - ts) * 1e3)
        polls += 1
        if polls % 2 == 0:
            nxt = next(arrivals, None)
            if nxt is not None:
                handles.append(engine.submit(nxt, max_new_tokens=max_new))
        if not progressed and len(handles) == len(prompts) and \
                engine.scheduler.queue_depth == 0:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(h.tokens) for h in handles)
    ttft = sorted(h.ttft_s * 1e3 for h in handles)
    st = sorted(step_ms)

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(p * (len(xs) - 1)))]

    stats = dict(generated_tokens=toks, wall_s=wall,
                 tokens_per_s=toks / wall, ttft_p50_ms=pct(ttft, 0.5),
                 ttft_p99_ms=pct(ttft, 0.99), steps=len(step_ms),
                 step_ms_mean=sum(st) / len(st), step_ms_p50=pct(st, 0.5),
                 step_ms_p99=pct(st, 0.99),
                 evictions=sum(h.evictions for h in handles))
    return [h.result(timeout=0) for h in handles], stats


def top2_gap(P, cfg, prefix):
    """Top-2 logit gap of the plain path for the token after `prefix`."""
    import torch
    from mxnet_tpu_torch.ops.quantized_matmul import matmul_nt_reference
    from mxnet_tpu_torch.serve.decode import (dense_kv_fn, lm_logits,
                                              transformer_step)
    dev = P["embed"].device
    T = len(prefix)
    Hkv = cfg.num_kv_heads or cfg.num_heads
    D = cfg.hidden_size // cfg.num_heads
    with torch.inference_mode():
        tok = torch.tensor([prefix], dtype=torch.int32, device=dev)
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
        kc = torch.zeros((cfg.num_layers, 1, Hkv, T, D),
                         dtype=P["embed"].dtype, device=dev)
        kv = dense_kv_fn(kc, torch.zeros_like(kc), pos, cfg.window)
        h = transformer_step(P, cfg, tok, pos, kv,
                             matmul=matmul_nt_reference)
        logits = lm_logits(P, h[:, -1], matmul=matmul_nt_reference)[0]
        top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def compare_streams(got, want, P, cfg, what):
    """Every stream in `got` equals `want`, except where the plain path's
    top-2 gap at the first differing token is below GAP.  Returns the
    number of such accepted near-tie divergences; raises on any other."""
    near = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        k = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        gap = top2_gap(P, cfg, w[:k])
        if gap >= GAP:
            raise AssertionError(
                f"{what}: stream {i} diverges at token {k} ({g[k]} vs "
                f"{w[k]}) where the plain path's top-2 gap is {gap:.3g} "
                f">= {GAP}")
        near += 1
    return near


def serve_phase(model, prompts, max_new, quant_bits, check_generate=False):
    """Kernel engine vs plain-version engine on the same weights."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig

    def engine(plain):
        sc = ServeConfig(max_slots=8, max_len=512, page_size=16,
                         prefill_chunk=16, quant_bits=quant_bits)
        eng = InferenceEngine(model, sc, device=model.device, seed=0,
                              plain_ops=plain)
        eng.warmup()
        return eng

    eng = engine(False)
    kernels.reset_launch_counts()
    streams, stats = drive(eng, prompts, max_new)
    launches = kernels.launch_counts()
    fused = eng.stats()["steps_executed"]
    stats.update(launches=launches, fused_steps=fused,
                 weight_bytes=eng.weight_bytes(), quant_bits=quant_bits,
                 bonus_pages=eng.bonus_pages)
    del eng
    plain = engine(True)
    pstreams, pstats = drive(plain, prompts, max_new)
    stats["plain_tokens_per_s"] = pstats["tokens_per_s"]
    stats["plain_step_ms_mean"] = pstats["step_ms_mean"]
    return streams, pstreams, plain, stats


def run_e2e(dev, results):
    import torch
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small

    cfg = gpt_small(dropout=0.0)
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    prompts = make_prompts(cfg.vocab_size)
    max_new = 32
    L = cfg.num_layers

    # phase 3: dense f32
    streams, pstreams, plain, st = serve_phase(model, prompts, max_new, 0)
    if st["launches"]["ragged_paged_attention"] != L * st["fused_steps"]:
        raise AssertionError(
            f"K1 launched {st['launches']['ragged_paged_attention']} times "
            f"over {st['fused_steps']} fused steps (want {L} per step)")
    st["near_ties_vs_plain"] = compare_streams(streams, pstreams, plain.P,
                                               cfg, "f32 kernel vs plain")
    gen = [model.generate(torch.tensor([p]), max_new_tokens=max_new)[0]
           .tolist() for p in prompts]
    st["near_ties_vs_generate"] = compare_streams(
        streams, gen, plain.P, cfg, "f32 engine vs generate")
    for s, p in zip(streams, prompts):
        if len(s) != len(p) + max_new or not all(
                0 <= t < cfg.vocab_size for t in s):
            raise AssertionError("malformed stream")
    results["e2e"]["float32"] = st
    print(f"[e2e f32] {json.dumps(st)}", flush=True)
    del plain

    # phase 4: int8 and int4 weights
    for bits in (8, 4):
        streams, pstreams, plain, st = serve_phase(model, prompts, max_new,
                                                   bits)
        if st["launches"]["quantized_matmul"] <= 0:
            raise AssertionError(f"K2 never launched at quant_bits={bits}")
        if st["launches"]["ragged_paged_attention"] != L * st["fused_steps"]:
            raise AssertionError(f"K1 launch count off at int{bits}")
        st["near_ties_vs_plain"] = compare_streams(
            streams, pstreams, plain.P, cfg, f"int{bits} kernel vs plain")
        results["e2e"][f"int{bits}"] = st
        print(f"[e2e int{bits}] {json.dumps(st)}", flush=True)
        del plain
    del model
    torch.cuda.empty_cache()

    # phase 5: bfloat16 (no equality demanded)
    cfg16 = gpt_small(dropout=0.0, dtype="bfloat16")
    model16 = GPTForCausalLM(cfg16, device=dev, seed=0)
    streams, pstreams, plain, st = serve_phase(model16, prompts, max_new, 0)
    st["equal_stream_share"] = sum(a == b for a, b in zip(
        streams, pstreams)) / len(streams)
    results["e2e"]["bfloat16"] = st
    print(f"[e2e bf16] {json.dumps(st)}", flush=True)


# ---------------------------------------------------------------------------

def kernel_entries(results):
    """One entry per ported kernel for the ``kernels`` line: the
    representative main-path case (K1: f32 decode C=1 MHA, no window; K2:
    int8 f32 M=8 768->2304) and the largest error over every case."""
    k1 = results["k1"]
    k2 = results["k2"]
    rep1 = next(c for c in k1 if c["dtype"] == "float32" and c["C"] == 1
                and c["Hkv"] == 12 and c["window"] is None)
    rep2 = next(c for c in k2 if c["bits"] == 8 and c["dtype"] == "float32"
                and c["M"] == 8 and c["N"] == 2304)
    e2e = results["e2e"]
    k1_launch = e2e.get("float32", {}).get("launches", {}).get(
        "ragged_paged_attention", 0)
    k2_launch = sum(e2e.get(k, {}).get("launches", {}).get(
        "quantized_matmul", 0) for k in ("int8", "int4"))

    def entry(name, src, replaces, launches, cases, rep):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": rep["ms"], "kernel_ms": rep["ms"],
                "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"]}

    return [
        entry("ragged_paged_attention",
              "mxnet_tpu_torch/csrc/paged_attention.cu",
              "mxnet_tpu/ops/pallas/paged_attention.py:285", k1_launch, k1,
              rep1),
        entry("quantized_matmul",
              "mxnet_tpu_torch/csrc/quantized_matmul.cu",
              "mxnet_tpu/ops/pallas/quantized_matmul.py:341", k2_launch, k2,
              rep2),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "chip_smoke.json"),
                    help="where the full per-case results are written")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible — this smoke runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from mxnet_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port package is not here ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[versions] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "e2e": {}}
    failed = []
    t0 = time.perf_counter()
    # build from the checkout's sources, never from a leftover library
    shutil.rmtree(os.path.join(HERE, "build", "mxnet_tpu_torch"),
                  ignore_errors=True)
    try:
        kernels.build_all(verbose=True)
        results["build_s"] = time.perf_counter() - t0
        print(f"[build] {results['build_s']:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: kernel build failed", file=sys.stderr)
        return 1

    for name, fn in (("k1", k1_cases), ("k2", k2_cases)):
        try:
            results[name] = fn(dev)
            for c in results[name]:
                print(f"[{name}] {json.dumps(c)}", flush=True)
            bad = [c for c in results[name] if not c["ok"]]
            if bad:
                raise AssertionError(f"{name}: {len(bad)} case(s) outside "
                                     f"tolerance")
        except Exception:
            traceback.print_exc()
            failed.append(name)
    try:
        run_e2e(dev, results)
    except Exception:
        traceback.print_exc()
        failed.append("e2e")
    results["seconds"] = time.perf_counter() - t0
    results["failed"] = failed
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": kernel_entries(results)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
