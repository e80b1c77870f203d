#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` and drives its
three main paths: serving at full GPT-2-small width and depth (12 layers,
hidden 768, vocab 50257, seeded random weights), the BERT-base pretraining
step at full width and depth, and Switch-MoE training at switch-base-8's
widths (hidden 768, FFN 3072, 8 experts) through `TrainStep` and the gluon
`Trainer`:

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
   path's;
6. (k3) flash attention, forward and forward + backward, against its plain
   version at BERT's attention shape (B 64, H 12, L 128, D 64) in f32 and
   bf16 with no mask, a key-padding bias from seeded ``valid_length``
   (0.85 L - L), a per-row bias, causal, and the padding bias with dropout
   0.1 (one seed on both sides, so the keep masks coincide) — max-abs
   1e-4 (f32) / 2e-2 (bf16) of the scale of O, dQ, dK and dV; timed
   against ``scaled_dot_product_attention`` with the same float mask;
7. (k4) the streaming softmax cross-entropy, forward and backward, against
   its plain version at (1280, 30522) in f32 and bf16 and at the odd
   V 50257, timed against ``cross_entropy(x.float(), y)``;
8. (k5) the fused LayerNorm / RMSNorm row kernel, with and without a
   residual, against its plain version in f32 and bf16 (f32 gamma and
   beta, as BERT keeps them) at (8192, 768) and (1280, 768) — the step's
   norms — and (37, 200), within 1e-4 / 2e-2 of the output scale; timed
   against ``F.layer_norm`` / ``F.rms_norm`` with the parameters cast to
   x's dtype;
9. (k6) the optimizer kernels over BERT-base's real parameter list (159
   tensors, 133.6 M elements; f32 model: one dtype group, bf16 model: bf16
   weights and f32 LayerNorm parameters) — the multi-tensor chunk for Adam,
   AdamW and SGD with momentum, LAMB phases A and B — against the per-leaf
   plain version, ``kernel_plain`` (each state within 1e-5 of its scale;
   each weight within its rounding plus 1e-5 of its update's scale, and at
   most 1e-4 of the bf16 weights' elements off the plain value), with
   planted faults built from the kernel's results (state not stored,
   weights unchanged) that the comparison must reject, ``skip=True``
   bit-identical on the card; device times from ``torch.profiler``,
   beside ``torch._fused_adam_`` / ``_fused_adamw_`` /
   ``_fused_sgd_`` over the same tensors as the nearest library call
   (torch's Adam puts epsilon after the bias correction, MXNet's before);
10. (train) ``bench.py``'s BERT-base pretraining step (batch 64 x 128, 20
   masked positions, padded by ``valid_length``, dropout 0.1) through
   ``TrainStep`` for 20 steps on the default kernel route
   (``MXTPU_PALLAS=auto``): bf16 and f32 weights with Adam lr 1e-4 and
   with LAMB lr 1e-3 — every LayerNorm through the fused norm (26 launches
   a step), the optimizer through the chunk kernel (once per dtype group a
   step) or LAMB's phases (once per tensor each) — and slice 2's
   ``MXTPU_PALLAS=reference`` bf16 Adam step (no norm or optimizer
   launch).  The flash kernels launch 12 times a step each way and the
   cross-entropy kernels once.  Each run's loss trajectory equals that of
   the same step built on the plain versions from the same seed (relative
   1e-4; 1e-3 for bf16 on the kernel route, see `traj_tol`), and the loss
   falls; prints samples/s, step ms and TFLOP/s
   (``bench.py``'s count) and the share of the card's dense bf16 peak.
   Two controls plant a fault in the bf16 Adam kernel-route step (Adam
   without bias correction; LayerNorm on the norm kernel's RMS branch),
   and each must depart from that run's oracle by more than the limit.
11. (k7) the MoE row gather against its plain version, bit for bit: the
   slice's dispatch (8192 tokens into 8 x 1280 slots, H 768) and combine
   (scaled by gate * kept in f32) in f32 and bf16, with routing from a
   seeded skewed router (tokens overflow, slots stay empty), and an odd
   case (T 53, E 4, C 6, H 256) through ``moe_dispatch`` / ``moe_combine``
   with ``use_kernel=True``; dropped tokens and empty slots exactly zero;
   two planted faults (the scale ignored, ``kept`` ignored) must be
   rejected; timed beside ``torch.index_select`` (combine: index_select
   and a multiply, two calls) and the bound;
12. (tune) the autotuner's trial launches of the chunk kernel (row 10),
   with ``MXTPU_AUTOTUNE_CACHE`` in a temporary directory: a cold
   ``tune("fused_optimizer", (n,), "float32")`` for the MoE layer's
   parameters (37.8 M) and BERT-base's (133.6 M) runs trials that the
   chunk kernel counts, every candidate block size gives the bits of the
   static ``CHUNK`` (which k6's tolerances hold to the plain update), a
   warm call is a hit with 0 trials, and the next ``apply_updates``
   launches with the tuned chunk; the tuned configs are dropped after the
   phase, so the phases that follow launch at ``CHUNK``;
13. (moe) ``MoEFeedForward(768, 3072, num_experts=8, capacity_factor=1.25)``
   trained 20 steps on a seeded (64, 128, 768) batch, loss MSE + 0.01 aux,
   Adam lr 1e-4, through ``TrainStep`` and through ``gluon.Trainer``
   (``loss.backward(); trainer.step(8192)`` on the batch's summed loss), in
   f32 and bf16: the gather launches twice a step (dispatch, combine), the
   chunk kernel once, nothing else; each loss trajectory is held against
   the same run on the plain versions (``MXTPU_PALLAS=reference``, per-leaf
   optimizer) within `moe_tol`, tokens routed apart from the oracle
   counted per step, the loss falls, and a planted fault (combine without
   the gate) must depart by more than the limit.  Prints tokens/s, step ms, TFLOP/s
   of the expert products and the share of the dense peak.

Every count is reset just before a run it reports and read just after.
The last three stdout lines are the ``nvidia-smi`` card line, the
``kernels`` JSON and ``{"ok": true, "device": {...}}``; the full per-case
results go to ``--out``.  Any failed phase exits non-zero without
that last line; so does a machine without a CUDA device, or a directory
that holds this script alone.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
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
TRAIN_STEPS = 20
OPT_RTOL = 1e-5       # optimizer kernels vs plain, of each tensor's scale
OPT_MISMATCH = 1e-4   # share of bf16 weight elements off the plain value


def traj_tol(dtype, route):
    """Loss trajectory limit, relative, kernel step vs its plain oracle.
    f32 on either route, and bf16 on the reference route (f32 activations
    after the first LayerNorm): the sound runs deviate by at most 1.3e-7
    and 1.6e-6, so 1e-4.  bf16 on the kernel route keeps bf16 activations,
    where a kernel and its plain version round differently and one changed
    rounding spreads through every later layer: the sound runs reach 1.4e-4
    in 20 steps, so 1e-3 there.  The train phase's controls (planted
    faults, `TRAIN_FAULTS`) show every run how far above it a wrong kernel
    lands."""
    return 1e-3 if dtype == "bfloat16" and route != "reference" else 1e-4


def traj_dev(losses, oracle):
    """Largest relative departure of a loss trajectory from its oracle's."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses, oracle))


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
# phases 6-7: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def _scale_err(got, want):
    """(max-abs error, scale) of `got` against `want`, in f32."""
    return (float((got.float() - want.float()).abs().max()),
            float(want.float().abs().max()))


def bert_batch(vocab, batch=64, seq=128, n_mask=20, seed=0):
    """``bench.py``'s batch (bench.py:96-110): ids, valid_length in
    [0.85 seq, seq], sorted masked positions, MLM labels."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    vlen = rng.randint(int(0.85 * seq), seq + 1, (batch,)).astype(np.int32)
    mpos = np.sort(rng.rand(batch, seq).argsort(axis=1)[:, :n_mask],
                   axis=1).astype(np.int32)
    labels = rng.randint(0, vocab, (batch, n_mask)).astype(np.int32)
    return ids, vlen, mpos, labels


FLASH_CASES = ("none", "pad", "row", "causal", "pad_dropout")


def k3_cases(dev):
    """The flash kernels at BERT-base's attention shape, one (b, h) per
    bh: B 64, H 12, L 128, D 64."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa

    B, H, L, D = 64, 12, 128, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 1.0 / D ** 0.5
    vlen = torch.from_numpy(bert_batch(30522)[1]).to(dev)
    g = torch.Generator().manual_seed(3)
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    out = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(B, H, L, D, generator=g).to(dev, dt)
                       for _ in range(4))
        pad = torch.where(torch.arange(L, device=dev)[None] < vlen[:, None],
                          0.0, fa.MASK_VALUE)                     # (B, L)
        row = torch.randn(B, L, L, generator=g).to(dev)
        for name in FLASH_CASES:
            bias = {"pad": pad, "pad_dropout": pad, "row": row}.get(name)
            causal = name == "causal"
            rate = 0.1 if name == "pad_dropout" else 0.0
            bias3, per_head, per_row = (None, False, False) if bias is None \
                else fa.normalize_bias(bias, B, H, L, L)
            a = (q, k, v, bias3, seed, scale, causal, rate, per_head,
                 per_row)
            ok_, lk_ = fa._flash_fwd_cuda(*a)
            op_, lp_ = fa.flash_fwd_reference(*a)
            gk = fa._flash_bwd_cuda(q, k, v, bias3, seed, ok_, lk_, do,
                                    scale, causal, rate, per_head, per_row)
            gp = fa.flash_bwd_reference(q, k, v, bias3, seed, op_, lp_, do,
                                        scale, causal, rate, per_head,
                                        per_row)
            torch.cuda.synchronize()
            errs = {}
            for nm, x, y in zip(("out", "dq", "dk", "dv"),
                                (ok_,) + tuple(gk), (op_,) + tuple(gp)):
                errs[nm] = _scale_err(x, y)
            case = dict(dtype=dtype, case=name,
                        max_abs_err=max(e for e, _ in errs.values()),
                        errors={nm: {"err": e, "scale": sc}
                                for nm, (e, sc) in errs.items()},
                        ok=all(e <= TOL[dtype] * sc
                               for e, sc in errs.values()))
            # timings: kernel, plain version, SDPA with the same float mask
            mask = None if bias is None else (
                bias[:, None, None, :] if bias.dim() == 2
                else bias[:, None]).to(dt)
            qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

            def lib_fwd():
                return sdpa(qs, ks, vs, attn_mask=mask, dropout_p=rate,
                            is_causal=causal)
            o_lib = lib_fwd()
            case["ms"] = time_ms(lambda: fa._flash_fwd_cuda(*a))
            case["plain_ms"] = time_ms(lambda: fa.flash_fwd_reference(*a))
            case["library_ms"] = time_ms(lib_fwd)
            bwd_args = (q, k, v, bias3, seed)
            tail = (scale, causal, rate, per_head, per_row)
            case["bwd_ms"] = time_ms(lambda: fa._flash_bwd_cuda(
                *bwd_args, ok_, lk_, do, *tail))
            case["bwd_plain_ms"] = time_ms(lambda: fa.flash_bwd_reference(
                *bwd_args, op_, lp_, do, *tail))
            case["bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(
                o_lib, (qs, ks, vs), do, retain_graph=True))

            def kernel_fb():
                o_, l_ = fa._flash_fwd_cuda(*a)
                return fa._flash_bwd_cuda(*bwd_args, o_, l_, do, *tail)

            def plain_fb():
                o_, l_ = fa.flash_fwd_reference(*a)
                return fa.flash_bwd_reference(*bwd_args, o_, l_, do, *tail)
            case["fwd_bwd_ms"] = time_ms(kernel_fb)
            case["fwd_bwd_plain_ms"] = time_ms(plain_fb)
            case["fwd_bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(
                lib_fwd(), (qs, ks, vs), do))
            # the work this data needs: (query, key) pairs not masked
            if causal:
                pairs = B * H * L * (L + 1) // 2
            elif bias is pad:
                pairs = H * L * int(vlen.sum())
            else:
                pairs = B * H * L * L
            item = q.element_size()
            tensor = B * H * L * D * item
            bias_b = 0 if bias3 is None else bias3.numel() * 4
            case["bound_ms"], case["bound_by"] = bound(
                4 * tensor + B * H * L * 4 + bias_b, 4.0 * pairs * D, dtype)
            case["bwd_bound_ms"], case["bwd_bound_by"] = bound(
                8 * tensor + B * H * L * 4 + bias_b, 10.0 * pairs * D, dtype)
            out.append(case)
            del o_lib, qs, ks, vs
    return out


XENT_SHAPES = [("float32", 1280, 30522), ("bfloat16", 1280, 30522),
               ("float32", 1280, 50257)]


def k4_cases(dev):
    """The cross-entropy kernels at the MLM head's logits (64 x 20 masked
    rows, vocab 30522) and at an odd vocabulary."""
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.ops import softmax_xent as sx

    g = torch.Generator().manual_seed(4)
    out = []
    for dtype, N, V in XENT_SHAPES:
        dt = getattr(torch, dtype)
        x = (2.0 * torch.randn(N, V, generator=g)).to(dev, dt)
        lab = torch.randint(0, V, (N,), generator=g).to(dev, torch.int32)
        gr = torch.rand(N, generator=g).to(dev)
        lk_, sk_ = sx._xent_fwd_cuda(x, lab)
        lp_, sp_ = sx.xent_fwd_reference(x, lab)
        dk_ = sx._xent_bwd_cuda(x, lab, sk_, gr)
        dp_ = sx.xent_bwd_reference(x, lab, sp_, gr)
        torch.cuda.synchronize()
        errs = {"loss": _scale_err(lk_, lp_), "dx": _scale_err(dk_, dp_)}
        case = dict(dtype=dtype, N=N, V=V,
                    max_abs_err=max(e for e, _ in errs.values()),
                    errors={nm: {"err": e, "scale": sc}
                            for nm, (e, sc) in errs.items()},
                    ok=all(e <= TOL[dtype] * sc for e, sc in errs.values()))
        x32 = x.float().requires_grad_()
        y64 = lab.long()
        lib = tF.cross_entropy(x32, y64, reduction="none")
        case["ms"] = time_ms(lambda: sx._xent_fwd_cuda(x, lab))
        case["plain_ms"] = time_ms(lambda: sx.xent_fwd_reference(x, lab))
        case["library_ms"] = time_ms(lambda: tF.cross_entropy(
            x.float(), y64, reduction="none"))
        case["bwd_ms"] = time_ms(lambda: sx._xent_bwd_cuda(x, lab, sk_, gr))
        case["bwd_plain_ms"] = time_ms(
            lambda: sx.xent_bwd_reference(x, lab, sp_, gr))
        case["bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(
            lib, x32, gr, retain_graph=True))
        item = x.element_size()
        case["bound_ms"], case["bound_by"] = bound(
            N * V * item + 3 * N * 4, 3.0 * N * V, dtype)
        case["bwd_bound_ms"], case["bwd_bound_by"] = bound(
            2 * N * V * item + 3 * N * 4, 3.0 * N * V, dtype)
        out.append(case)
        del x32, lib
    return out


NORM_SHAPES = [(8192, 768), (1280, 768), (37, 200)]
NORM_VARIANTS = (("ln", False, False), ("rms", True, False),
                 ("ln_res", False, True), ("rms_res", True, True))


def k5_cases(dev):
    """The fused norm at the BERT step's shapes (64 x 128 tokens and the
    1280 masked rows of the MLM head, hidden 768) and a ragged one; f32
    gamma and beta, as BERT's LayerNorms keep them."""
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.ops import fused_norm as fn

    g = torch.Generator().manual_seed(7)
    out = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for rows, h in NORM_SHAPES:
            x = torch.randn(rows, h, generator=g).to(dev, dt)
            r = torch.randn(rows, h, generator=g).to(dev, dt)
            gamma = (torch.rand(h, generator=g) + 0.5).to(dev)
            beta = torch.randn(h, generator=g).to(dev)
            g16, b16 = gamma.to(dt), beta.to(dt)
            for name, rms, res in NORM_VARIANTS:
                rr = r if res else None
                bb = None if rms else beta
                eps = 1e-6 if rms else 1e-12
                a = (x, rr, gamma, bb, eps, rms)
                got = fn._norm_cuda(*a)
                want = fn.norm_plain(*a)
                torch.cuda.synchronize()
                pairs = list(zip(got, want)) if res else [(got, want)]
                errs = [_scale_err(u, v) for u, v in pairs]
                case = dict(dtype=dtype, rows=rows, h=h, case=name,
                            max_abs_err=max(e for e, _ in errs),
                            errors=[{"err": e, "scale": sc}
                                    for e, sc in errs],
                            ok=all(e <= TOL[dtype] * sc for e, sc in errs))
                case["ms"] = time_ms(lambda: fn._norm_cuda(*a))
                case["plain_ms"] = time_ms(lambda: fn.norm_plain(*a))
                if res:       # no one library call adds and normalises
                    case["library_ms"] = None
                elif rms:
                    case["library_ms"] = time_ms(lambda: tF.rms_norm(
                        x, (h,), g16, eps))
                else:
                    case["library_ms"] = time_ms(lambda: tF.layer_norm(
                        x, (h,), g16, b16, eps))
                item = x.element_size()
                nbytes = rows * h * item * (2 + 2 * res) + \
                    h * 4 * (1 + (not rms))
                case["bound_ms"], case["bound_by"] = bound(
                    nbytes, (5 if rms else 8) * rows * h, dtype)
                out.append(case)
    return out


def profile_ms(fn, iters=5):
    """Device time of one call of `fn`, by kernel name and in total (ms),
    from ``torch.profiler`` over `iters` calls after one warm call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            us = float(getattr(e, attr, 0.0) or 0.0)
            if us:
                break
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / iters
    return sum(by_name.values()), by_name


OPT_RULES = (("adam", "Adam", {}), ("adamw", "AdamW", {}),
             ("sgd_momentum", "SGD", {"momentum": 0.9}), ("lamb", "LAMB", {}))


def bert_leaves(dtype):
    """(name, shape, dtype) of every parameter of BERT-base for
    pretraining in `dtype` (LayerNorm parameters stay f32)."""
    from mxnet_tpu_torch.models import BertForPretraining, bert_base
    m = BertForPretraining(bert_base(dtype=dtype), device="cpu", seed=0)
    return [(n, tuple(p.shape), p.dtype) for n, p in m.named_parameters()]


def _opt_tree(leaves, opt, dev, seed):
    """Weights N(0, 0.02), gradients N(0, 1e-3), Adam-like moments."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    params, grads, states = {}, {}, {}
    for n, shape, dt in leaves:
        params[n] = (0.02 * torch.randn(shape, generator=g, device=dev)
                     ).to(dt)
        grads[n] = (1e-3 * torch.randn(shape, generator=g, device=dev)
                    ).to(dt)
        st = opt.create_state(params[n], dtype=torch.float32)
        states[n] = tuple(
            (1e-4 * torch.randn(shape, generator=g, device=dev)) if k == 0
            else 1e-8 * torch.rand(shape, generator=g, device=dev)
            for k in range(len(st)))
    return params, grads, states


def _opt_err(new_p, new_s, want_p, want_s, old_p):
    """(max-abs error, share of bf16 weight elements off the plain value,
    ok) of an update against the plain version's.  Each state tensor is
    held within OPT_RTOL of its own scale, max |plain|.  A weight is held
    within its rounding (2 ulps in f32, one step in bf16: at most 2**-22
    and 2**-7 of the value) plus OPT_RTOL of its update's scale, max
    |plain - old|.  An update below one bf16 step moves only some of a
    bf16 weight's elements, so at most OPT_MISMATCH of those elements may
    differ from the plain value at all."""
    import torch
    err, ok, off, n16 = 0.0, True, 0, 0
    for n in new_p:
        a, b = new_p[n].float(), want_p[n].float()
        d = (a - b).abs()
        bf16 = new_p[n].dtype == torch.bfloat16
        lim = (2.0 ** -7 if bf16 else 2.0 ** -22) * b.abs() + \
            OPT_RTOL * float((b - old_p[n].float()).abs().max())
        ok = ok and bool((d <= lim).all())
        err = max(err, float(d.max()))
        if bf16:
            off += int((d > 0).sum())
            n16 += d.numel()
        for s, w in zip(new_s[n], want_s[n]):
            d = float((s.float() - w.float()).abs().max())
            ok = ok and d <= OPT_RTOL * float(w.float().abs().max())
            err = max(err, d)
    share = off / n16 if n16 else 0.0
    return err, share, ok and share <= OPT_MISMATCH


def _opt_controls(new_p, new_s, want_p, want_s, old_p, old_s):
    """Planted faults built from the kernel's own results, no launch: each
    must fail `_opt_err`.  The last state slot (Adam's v, SGD's momentum)
    left unstored, and each weight dtype's weights left unchanged.
    Returns {fault: caught}."""
    faults = {"last_state_not_stored": (new_p, {
        n: tuple(new_s[n][:-1]) + (old_s[n][-1],) for n in new_s})}
    for dt in sorted({str(p.dtype) for p in new_p.values()}):
        faults[f"{dt[6:]}_weights_unchanged"] = ({
            n: old_p[n] if str(p.dtype) == dt else p
            for n, p in new_p.items()}, new_s)
    return {k: not _opt_err(p, s, want_p, want_s, old_p)[2]
            for k, (p, s) in faults.items()}


def _library_call(rule, opt, params, grads, states, hp_vals):
    """The nearest one-call PyTorch multi-tensor update on the same
    tensors, grouped by weight dtype, with its state in the weight's dtype
    (as torch keeps it); None for LAMB."""
    import torch
    if rule == "lamb":
        return None
    groups = {}
    for n, p in params.items():
        groups.setdefault(p.dtype, []).append(n)
    lists = []
    for names in groups.values():
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        ss = [[s.to(params[n].dtype) for s in states[n]] for n in names]
        steps = [torch.full((), 3.0, device=ps[0].device) for _ in ps]
        lists.append((ps, gs, ss, steps))
    lr, wd = hp_vals["lr"], hp_vals["wd"]

    def call():
        for ps, gs, ss, steps in lists:
            if rule == "sgd_momentum":
                torch._fused_sgd_(ps, gs, [s[0] for s in ss],
                                  weight_decay=wd, momentum=opt.momentum,
                                  lr=lr, dampening=0.0, nesterov=False,
                                  maximize=False, is_first_step=False)
            else:
                fused = torch._fused_adam_ if rule == "adam" else \
                    torch._fused_adamw_
                fused(ps, gs, [s[0] for s in ss], [s[1] for s in ss], [],
                      steps, lr=lr, beta1=opt.beta1, beta2=opt.beta2,
                      weight_decay=wd, eps=opt.epsilon, amsgrad=False,
                      maximize=False)
    return call


# (bytes per element given the weight's itemsize w, f32 operations per
# element): each input read once and each output written once, state f32
_OPT_WORK = {
    "adam": (lambda w: 3 * w + 16, 14),        # w g m v in; w m v out
    "adamw": (lambda w: 3 * w + 16, 15),
    "sgd_momentum": (lambda w: 3 * w + 8, 6),  # w g mom in; w mom out
    "lamb_a": (lambda w: 2 * w + 20, 17),      # w g m v in; m v r out
    "lamb_b": (lambda w: 2 * w + 4, 3)}        # w r in; w out


def _opt_bound(rule, params, phase=None):
    """`bound` of one update of `params` by `rule` (LAMB: one phase)."""
    per, ops = _OPT_WORK[f"lamb_{phase}" if rule == "lamb" else rule]
    n = sum(p.numel() for p in params.values())
    nbytes = sum(per(p.element_size()) * p.numel() for p in params.values())
    return bound(nbytes, ops * n, "float32")


def k6_cases(dev):
    """The optimizer kernels over BERT-base's parameter list, f32 and bf16
    models: each rule's kernel route against its plain version, the
    device time of each, and the skip flag's bit identity."""
    import torch
    from mxnet_tpu_torch import kernels, optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo

    out = []
    for dtype in ("float32", "bfloat16"):
        leaves = bert_leaves(dtype)
        for rule, cls, kw in OPT_RULES:
            lr = 1e-3 if rule == "lamb" else 1e-4
            opt = getattr(topt, cls)(learning_rate=lr, **kw)
            hp_vals = {"lr": lr, "wd": 0.01, "rescale_grad": 1.0, "t": 3.0}
            hp = {k: torch.full((), v, device=dev)
                  for k, v in hp_vals.items()}
            hp["clip_gradient"] = None
            params, grads, states = _opt_tree(leaves, opt, dev, seed=8)
            want_p, want_s = fo.kernel_plain(opt, params, grads, states, hp)
            kp = {n: t.clone() for n, t in params.items()}
            ks = {n: tuple(t.clone() for t in st)
                  for n, st in states.items()}
            kernels.reset_launch_counts()
            fo.apply_updates(opt, kp, grads, ks, hp, use_kernel=True)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            err, share, ok = _opt_err(kp, ks, want_p, want_s, params)
            controls = _opt_controls(kp, ks, want_p, want_s, params, states)
            ok = ok and all(controls.values())
            n_groups = len({p.dtype for p in params.values()})
            want_l = ({"lamb_phase_a": len(params),
                       "lamb_phase_b": len(params)} if rule == "lamb"
                      else {"fused_optimizer_chunk": n_groups})
            ok = ok and all(launches[k] == v for k, v in want_l.items())
            # skip=True leaves every weight and state bit-identical
            sp = {n: t.clone() for n, t in params.items()}
            ss = {n: tuple(t.clone() for t in st)
                  for n, st in states.items()}
            fo.apply_updates(opt, sp, grads, ss, hp, use_kernel=True,
                             skip=torch.ones((), dtype=torch.bool,
                                             device=dev))
            skip_ok = all(torch.equal(sp[n], params[n]) and all(
                torch.equal(a, b) for a, b in zip(ss[n], states[n]))
                for n in params)
            del sp, ss, want_p, want_s
            case = dict(dtype=dtype, rule=rule, tensors=len(params),
                        elements=sum(p.numel() for p in params.values()),
                        groups=n_groups, launches=launches,
                        max_abs_err=err, bf16_weight_mismatch_share=share,
                        controls_caught=controls,
                        skip_bit_identical=skip_ok, ok=ok and skip_ok)

            def kernel_call():
                fo.apply_updates(opt, kp, grads, ks, hp, use_kernel=True)

            def plain_call():
                fo.kernel_plain(opt, params, grads, states, hp)
            case["device_ms"], by_name = profile_ms(kernel_call)
            case["kernel_device_ms"] = {k: v for k, v in by_name.items()
                                        if "kernel" in k}
            case["plain_ms"], _ = profile_ms(plain_call)
            case["call_ms"] = time_ms(kernel_call, iters=10, warm=2)
            case["plain_call_ms"] = time_ms(plain_call, iters=10, warm=2)
            lib = _library_call(rule, opt, kp, grads, ks, hp_vals)
            case["library_ms"] = None if lib is None else \
                profile_ms(lib)[0]
            if rule == "lamb":
                for ph in ("a", "b"):
                    ms = sum(v for k, v in by_name.items()
                             if f"lamb_{ph}_kernel" in k)
                    case[f"phase_{ph}_ms"] = ms
                    case[f"phase_{ph}_bound_ms"], case[
                        f"phase_{ph}_bound_by"] = _opt_bound(rule, params,
                                                             ph)
                case["ms"] = case["phase_a_ms"] + case["phase_b_ms"]
                case["bound_ms"] = case["phase_a_bound_ms"] + \
                    case["phase_b_bound_ms"]
                case["bound_by"] = "bytes"
            else:
                case["ms"] = sum(v for k, v in by_name.items()
                                 if "chunk_kernel" in k)
                case["bound_ms"], case["bound_by"] = _opt_bound(rule,
                                                                params)
            out.append(case)
            del kp, ks, params, grads, states, lib
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: the BERT-base pretraining step end to end
# ---------------------------------------------------------------------------

def bench_flops_per_step(cfg, batch, seq, n_mask):
    """``bench.py``'s train FLOPs (bench.py:184-189): 3x the forward's
    matmul FLOPs, the MLM head on the masked positions only."""
    h, l, i, V = (cfg.hidden_size, cfg.num_layers, cfg.intermediate_size,
                  cfg.vocab_size)
    fwd_per_token = 2 * l * (4 * h * h + 2 * h * i) + 4 * l * seq * h
    fwd_per_masked = 2 * (h * h + h * V)
    return 3 * batch * (fwd_per_token * seq + fwd_per_masked * n_mask)


@contextlib.contextmanager
def pallas_mode(mode):
    """``MXTPU_PALLAS=mode`` for the duration of the block."""
    old = os.environ.get("MXTPU_PALLAS")
    os.environ["MXTPU_PALLAS"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MXTPU_PALLAS", None)
        else:
            os.environ["MXTPU_PALLAS"] = old


OPT_LR = {"Adam": 1e-4, "LAMB": 1e-3}
# planted faults for the train phase's controls, each one kernel's math
# gone wrong on the bf16 kernel route: the trajectory check against the
# sound bf16 Adam run's oracle must reject every one
TRAIN_FAULTS = ("adam_without_bias_correction", "layernorm_as_rmsnorm")


def _layernorm_as_rmsnorm(x, gamma, beta, eps):
    """A LayerNorm whose row kernel takes its RMS branch: no centring."""
    from mxnet_tpu_torch.ops import fused_norm as fn
    return fn._kernel_route(x, None, gamma, beta, eps, True,
                            x.device.type == "cuda")


def bert_train_step(dev, dtype, plain=False, opt="Adam", route="auto",
                    fault=None):
    """``bench.py``'s pretraining step: full-width BERT-base (seed 0)
    behind its positional adapter (ids, valid_length, masked_positions),
    the mean MLM cross-entropy, `opt` (Adam lr 1e-4 or LAMB lr 1e-3) in a
    `TrainStep`, built under ``MXTPU_PALLAS=route`` (the step resolves its
    optimizer route once, at construction; the norms read the policy at
    each call, so run it under the same mode).  ``plain=True`` builds the
    oracle, which launches no kernel: every attention swaps in
    `multi_head_attention_reference`, the loss is
    `softmax_cross_entropy_reference`, on the kernel route every LayerNorm
    swaps in `fused_layer_norm_reference` (the fused kernel's plain
    version) and the optimizer update is the kernels' plain version
    `ops.fused_optimizer.kernel_plain`, leaf by leaf (LAMB's trust ratio in
    f32, as the kernels keep it); on the reference route the optimizer
    takes that route's per-leaf update, which rounds the ratio to a bf16
    weight's dtype, as JAX's does.  `fault`
    plants one of `TRAIN_FAULTS` in a kernel-route Adam step: the chunk
    kernel's AdamW rule with ``correct_bias=False`` and no weight decay,
    or every LayerNorm on the norm kernel's RMS branch."""
    import torch
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.models import BertForPretraining, bert_base
    from mxnet_tpu_torch.models.layers import FusedSelfAttention, LayerNorm
    from mxnet_tpu_torch.ops.attention import multi_head_attention_reference
    from mxnet_tpu_torch.ops.fused_norm import fused_layer_norm_reference
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.ops.softmax_xent import (
        softmax_cross_entropy, softmax_cross_entropy_reference)
    from mxnet_tpu_torch.parallel import TrainStep

    class Bench(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = BertForPretraining(bert_base(dtype=dtype),
                                            device=dev, seed=0)

        def forward(self, ids, vl, mp):
            return self.model(ids, valid_length=vl, masked_positions=mp)

    bench = Bench()
    xent = softmax_cross_entropy
    if plain:
        for m in bench.modules():
            if isinstance(m, FusedSelfAttention):
                m.attend = multi_head_attention_reference
            if isinstance(m, LayerNorm) and route != "reference":
                m.norm = fused_layer_norm_reference
        xent = softmax_cross_entropy_reference
    optimizer = getattr(topt, opt)(learning_rate=OPT_LR[opt])
    update = None
    if plain and route != "reference":
        update = kernel_plain
    if fault == "adam_without_bias_correction":
        optimizer = topt.AdamW(learning_rate=OPT_LR[opt], correct_bias=False)
    elif fault == "layernorm_as_rmsnorm":
        for m in bench.modules():
            if isinstance(m, LayerNorm):
                m.norm = _layernorm_as_rmsnorm

    def loss_fn(out, ids, vl, mp, lab):
        return xent(out[0], lab).mean()

    with pallas_mode("reference" if plain else route):
        return TrainStep(bench, optimizer, loss_fn, num_model_args=3,
                         update=update)


def train_run(dev, dtype, plain, batch, opt="Adam", route="auto",
              fault=None):
    """`TRAIN_STEPS` steps of the pretraining step under
    ``MXTPU_PALLAS=route``; returns its stats, the step time and the
    step's parameter counts (tensors, dtype groups)."""
    import torch
    from mxnet_tpu_torch import kernels

    step = bert_train_step(dev, dtype, plain, opt, route, fault)
    params = [step.params[n] for n in step.diff_names]
    counts = (len(params), len({p.dtype for p in params}))
    with pallas_mode(route):
        warm_s = step.warmup(*batch)
        losses = []
        kernels.reset_launch_counts()
        for i in range(TRAIN_STEPS):
            losses.append(step.dispatch(*batch).loss)
            if i == 1:        # time the steady steps 3..N
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 2)
        launches = kernels.launch_counts()
    return dict(losses=[float(x) for x in losses], step_ms=step_s * 1e3,
                warmup_s=warm_s, launches=launches,
                fused_opt_kernel=step._fused_opt_kernel,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), \
        step_s, counts


# (weights, optimizer, MXTPU_PALLAS): the default kernel route in bf16 and
# f32 with each optimizer (f32 holds the kernels to the tight trajectory
# limit), and slice 2's reference route
TRAIN_RUNS = (("bfloat16", "Adam", "auto"), ("float32", "Adam", "auto"),
              ("bfloat16", "LAMB", "auto"), ("float32", "LAMB", "auto"),
              ("bfloat16", "Adam", "reference"))


def want_launches(opt, route, n_tensors, n_groups, layers):
    """Exact launches over `TRAIN_STEPS` steps: 26 norms a step (embed,
    2 per layer, the MLM head) and the optimizer on the kernel route only;
    flash and cross-entropy on both."""
    kr = route != "reference"
    lamb = kr and opt == "LAMB"
    per_step = {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                "fused_norm": 2 * layers + 2 if kr else 0,
                "fused_optimizer_chunk": n_groups if kr and not lamb else 0,
                "lamb_phase_a": n_tensors if lamb else 0,
                "lamb_phase_b": n_tensors if lamb else 0}
    return {k: v * TRAIN_STEPS for k, v in per_step.items()}


def run_train(dev, results, card):
    import torch
    from mxnet_tpu_torch.models import bert_base

    cfg = bert_base()
    B, S, M = 64, 128, 20
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in bert_batch(cfg.vocab_size, B, S, M))
    flops = bench_flops_per_step(cfg, B, S, M)
    for dtype, opt, route in TRAIN_RUNS:
        key = f"{dtype}_{opt.lower()}_{route}"
        torch.cuda.reset_peak_memory_stats()
        st, step_s, (n_t, n_g) = train_run(dev, dtype, False, batch, opt,
                                           route)
        torch.cuda.empty_cache()
        pst, pstep_s, _ = train_run(dev, dtype, True, batch, opt, route)
        torch.cuda.empty_cache()
        want = want_launches(opt, route, n_t, n_g, cfg.num_layers)
        got = {k: st["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"train {key}: kernel launches {got}, "
                                 f"want {want} over {TRAIN_STEPS} steps")
        if any(pst["launches"].values()):
            raise AssertionError(f"train {key}: the plain run launched "
                                 f"kernels {pst['launches']}")
        dev_rel = traj_dev(st["losses"], pst["losses"])
        ls = st["losses"]
        if not all(math.isfinite(x) for x in ls):
            raise AssertionError(f"train {key}: non-finite loss {ls}")
        st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  trajectory_rel_dev=dev_rel,
                  trajectory_tol=traj_tol(dtype, route),
                  samples_per_s=B / step_s,
                  plain_samples_per_s=B / pstep_s, tensors=n_t,
                  dtype_groups=n_g, flops_per_step=flops,
                  tflops=flops / step_s / 1e12,
                  bf16_peak_share=flops / step_s / PEAK["bfloat16"])
        results["train"][key] = st
        print(f"[train {key}] {json.dumps(st)}", flush=True)
        print(f"[train {key}] {B / step_s:.1f} samples/s, "
              f"{st['step_ms']:.2f} ms/step, {st['tflops']:.2f} TFLOP/s = "
              f"{100 * st['bf16_peak_share']:.2f}% of the dense bf16 peak "
              f"(989 TFLOP/s) of {card}", flush=True)
        tol = traj_tol(dtype, route)
        if dev_rel > tol:
            raise AssertionError(
                f"train {key}: loss trajectory departs from the plain "
                f"path's by {dev_rel:.3g} > {tol} ({ls} vs {pst['losses']})")
        if not ls[-1] < ls[0]:
            raise AssertionError(f"train {key}: loss did not fall {ls}")

    # the controls: how far a wrong kernel moves the trajectory, read
    # against the limit the sound bf16 run is held to
    oracle = results["train"]["bfloat16_adam_auto"]["plain_losses"]
    tol = traj_tol("bfloat16", "auto")
    for fault in TRAIN_FAULTS:
        st, _, _ = train_run(dev, "bfloat16", False, batch, "Adam", "auto",
                             fault)
        torch.cuda.empty_cache()
        dev_rel = traj_dev(st["losses"], oracle)
        results["train_controls"][fault] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol, caught=dev_rel > tol)
        print(f"[train control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            raise AssertionError(
                f"train control {fault}: the planted fault departs from the "
                f"oracle by only {dev_rel:.3g} <= {tol}; the trajectory "
                f"check cannot see it")


# ---------------------------------------------------------------------------
# phase 11: the MoE row gather against its plain version
# ---------------------------------------------------------------------------

MOE_H, MOE_I, MOE_E, MOE_CF = 768, 3072, 8, 1.25   # switch-base-8's widths
MOE_B, MOE_L = 64, 128                             # bench.py's batch
# (dtype, tokens, experts, hidden, capacity factor): the slice's shapes,
# and an odd one (capacity int(0.46 * 53 / 4) = 6) through the wrappers
K7_CASES = (("float32", 8192, 8, 768, 1.25), ("bfloat16", 8192, 8, 768, 1.25),
            ("float32", 53, 4, 256, 0.46))


def skewed_routing(dev, T, E, H, cf, seed):
    """Seeded tokens (T, H) and a router whose row e is scaled by 1 +
    0.25 e, routed by the layer's own `route`: later experts draw more
    tokens than their capacity, earlier ones leave slots empty."""
    import torch
    from mxnet_tpu_torch.parallel.moe import route
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, H, generator=g)
    rw = torch.randn(E, H, generator=g) / H ** 0.5
    rw = rw * (1.0 + 0.25 * torch.arange(E, dtype=torch.float32))[:, None]
    expert, gate, pos, kept, cap, _ = route(x.to(dev), rw.to(dev), cf)
    return x, expert, gate, pos, kept, cap


def _faults_caught(md, down, expert, pos, kept, gate, E, C, want):
    """Planted faults of the combine launched on the card, each compared
    with the plain version as a sound result is: the scale ignored, and
    ``kept`` ignored (dropped tokens read their expert's slot 0 at their
    gate).  Returns {fault: rejected}."""
    import torch
    slot, _ = md.combine_index(expert, pos, kept, gate, E, C)
    no_kept = (expert.to(torch.int32) * C + pos).to(torch.int32)
    bad = {"scale_ignored": md.gather_rows(down, slot, None,
                                           counter="moe_combine"),
           "kept_ignored": md.gather_rows(down, no_kept, gate.float(),
                                          counter="moe_combine")}
    return {k: not torch.equal(v, want) for k, v in bad.items()}


def k7_cases(dev):
    """The row gather at the slice's shapes and an odd one: bit equality
    with `gather_rows_plain`, zero rows, planted faults, times."""
    import torch
    from mxnet_tpu_torch.ops import moe_dispatch as md

    out = []
    for dtype, T, E, H, cf in K7_CASES:
        dt = getattr(torch, dtype)
        x, expert, gate, pos, kept, C = skewed_routing(dev, T, E, H, cf,
                                                       seed=11)
        x = x.to(dev, dt)
        g = torch.Generator().manual_seed(12)
        down = torch.randn(E * C, H, generator=g).to(dev, dt)
        inv = md.dispatch_index(expert, pos, kept, E, C)
        slot, scale = md.combine_index(expert, pos, kept, gate, E, C)
        got = {"dispatch": md.gather_rows(x, inv, counter="moe_dispatch"),
               "combine": md.gather_rows(down, slot, scale,
                                         counter="moe_combine")}
        want = {"dispatch": md.gather_rows_plain(x, inv),
                "combine": md.gather_rows_plain(down, slot, scale)}
        if T < 1000:      # the odd case through the public wrappers
            got["dispatch"] = md.moe_dispatch(
                x, expert, pos, kept, E, C, use_kernel=True).reshape(-1, H)
            got["combine"] = md.moe_combine(
                down.reshape(E, C, H), expert, pos, kept, gate,
                use_kernel=True)
        torch.cuda.synchronize()
        empty = inv == T
        zero = {"dispatch": empty, "combine": ~kept}
        n_kept = int(kept.sum())
        controls = _faults_caught(md, down, expert, pos, kept, gate, E, C,
                                  want["combine"])
        xz = torch.cat([x, x.new_zeros(1, H)])
        dz = torch.cat([down, down.new_zeros(1, H)])
        inv64, slot64, scale_dt = inv.long(), slot.long(), scale.to(dt)
        item = x.element_size()
        for op in ("dispatch", "combine"):
            a, b = got[op], want[op]
            case = dict(dtype=dtype, op=op, T=T, E=E, C=C, H=H,
                        kept=n_kept, dropped=T - n_kept,
                        empty_slots=int(empty.sum()),
                        bit_equal=bool(torch.equal(a, b)),
                        zero_rows_exact=not bool(a[zero[op]].any()),
                        max_abs_err=float((a.float() - b.float()).abs().max()))
            case["ok"] = case["bit_equal"] and case["zero_rows_exact"]
            if T > 1000:    # the slice's shapes overflow and leave slots empty
                case["ok"] = case["ok"] and case["dropped"] > 0 and \
                    case["empty_slots"] > 0
            if op == "combine":
                case["controls_caught"] = controls
                case["ok"] = case["ok"] and all(controls.values())
                case["ms"] = time_ms(lambda: md.gather_rows(
                    down, slot, scale, counter="moe_combine"))
                case["plain_ms"] = time_ms(lambda: md.gather_rows_plain(
                    down, slot, scale))
                # two calls: no one library call gathers and scales
                case["library_ms"] = time_ms(lambda: torch.index_select(
                    dz, 0, slot64) * scale_dt[:, None])
                case["library_calls"] = 2
                nbytes = n_kept * H * item + T * H * item + 8 * T
                flops = T * H
            else:
                case["ms"] = time_ms(lambda: md.gather_rows(
                    x, inv, counter="moe_dispatch"))
                case["plain_ms"] = time_ms(lambda: md.gather_rows_plain(
                    x, inv))
                case["library_ms"] = time_ms(lambda: torch.index_select(
                    xz, 0, inv64))
                case["library_calls"] = 1
                nbytes = n_kept * H * item + E * C * H * item + 4 * E * C
                flops = 0
            case["bound_ms"], case["bound_by"] = bound(nbytes, flops,
                                                       "float32")
            out.append(case)
    return out


# ---------------------------------------------------------------------------
# phase 12: the autotuner's trial launches of the chunk kernel (row 10)
# ---------------------------------------------------------------------------

def moe_param_count():
    return MOE_E * MOE_H + 2 * MOE_E * MOE_I * MOE_H


def run_tune(dev, results, card):
    """Cold and warm ``tune("fused_optimizer", (n,), "float32")`` for the
    MoE layer's and BERT-base's f32 parameter counts, in a temporary
    cache; every candidate's bits against ``CHUNK``'s; the next launch's
    chunk.  The tuned configs are dropped from this process's memory after
    the phase, so each later phase launches at ``CHUNK`` whatever ran
    before it."""
    import tempfile
    import torch
    from mxnet_tpu_torch import kernels, optimizer as topt
    from mxnet_tpu_torch.ops import autotune as at
    from mxnet_tpu_torch.ops import fused_optimizer as fo

    bert_n = sum(math.prod(s) for _, s, _ in bert_leaves("float32"))
    old = os.environ.get("MXTPU_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MXTPU_AUTOTUNE_CACHE"] = tmp
        at.clear_memory_cache()
        try:
            for label, n in (("moe_f32", moe_param_count()),
                             ("bert_f32", bert_n)):
                results["tune"][label] = st = tune_case(dev, n, at, fo, topt,
                                                        kernels, torch)
                print(f"[tune {label}] {json.dumps(st)}", flush=True)
                for c, ms in sorted(st["timings_ms"].items()):
                    print(f"[tune {label}] chunk {c}: {ms:.4f} ms (host "
                          f"clock, synchronised), bound {st['bound_ms']:.4f}"
                          f" ms ({st['bound_by']}) on {card}", flush=True)
                if not st["ok"]:
                    raise AssertionError(f"tune {label}: {st}")
        finally:
            at.clear_memory_cache()
            if old is None:
                os.environ.pop("MXTPU_AUTOTUNE_CACHE", None)
            else:
                os.environ["MXTPU_AUTOTUNE_CACHE"] = old


def tune_case(dev, n, at, fo, topt, kernels, torch):
    kernels.reset_launch_counts()
    cold = at.tune("fused_optimizer", (n,), "float32")
    trial_launches = kernels.launch_counts()["fused_optimizer_chunk"]
    warm = at.tune("fused_optimizer", (n,), "float32")
    warm_launches = kernels.launch_counts()["fused_optimizer_chunk"] - \
        trial_launches
    # bits at every candidate against CHUNK's, CHUNK's against the plain
    opt = topt.Adam(learning_rate=1e-3)
    g = torch.Generator(device=dev).manual_seed(13)
    w0 = {"w": 0.02 * torch.randn(n, generator=g, device=dev)}
    gr = {"w": 1e-3 * torch.randn(n, generator=g, device=dev)}
    s0 = {"w": (1e-4 * torch.randn(n, generator=g, device=dev),
                1e-8 * torch.rand(n, generator=g, device=dev))}
    hp = {k: torch.full((), v, device=dev) for k, v in (
        ("lr", 1e-3), ("wd", 0.01), ("rescale_grad", 1.0), ("t", 3.0))}
    hp["clip_gradient"] = None
    keep, hptr = fo._device_hp(hp, None, dev)

    def at_chunk(chunk):
        p = {"w": w0["w"].clone()}
        s = {"w": tuple(t.clone() for t in s0["w"])}
        fo._chunk_cuda(opt, 0, ["w"], p, gr, s, hptr, dev, chunk)
        return p, s
    ref_p, ref_s = at_chunk(fo.CHUNK)
    want_p, want_s = fo.kernel_plain(opt, w0, gr, s0, hp)
    err, _, plain_ok = _opt_err(ref_p, ref_s, want_p, want_s, w0)
    del want_p, want_s
    equal = {}
    for c in fo._candidates((n,), "float32"):
        p, s = at_chunk(c.chunk)
        equal[c.chunk] = bool(torch.equal(p["w"], ref_p["w"]) and all(
            torch.equal(a, b) for a, b in zip(s["w"], ref_s["w"])))
        del p, s
    # the next apply_updates launches with the tuned chunk
    kernels.reset_launch_counts()
    fo.apply_updates(opt, {"w": ref_p["w"]}, gr, ref_s, hp, use_kernel=True)
    torch.cuda.synchronize()
    next_chunk = fo.last_chunk["float32"]
    next_launches = kernels.launch_counts()["fused_optimizer_chunk"]
    bound_ms, bound_by = _opt_bound("adam", w0)
    # the tuned chunk's launch (CUDA events, L2 flushed) beside the plain
    # version and torch's one-call fused Adam over the same leaf
    tp, ts = ref_p, ref_s
    chunk = cold.config.chunk
    ms = time_ms(lambda: fo._chunk_cuda(opt, 0, ["w"], tp, gr, ts, hptr,
                                        dev, chunk), iters=10, warm=2)
    plain_ms = time_ms(lambda: fo.kernel_plain(opt, tp, gr, ts, hp),
                       iters=5, warm=1)
    steps = [torch.full((), 3.0, device=dev)]
    library_ms = time_ms(lambda: torch._fused_adam_(
        [tp["w"]], [gr["w"]], [ts["w"][0]], [ts["w"][1]], [], steps,
        lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
        amsgrad=False, maximize=False), iters=10, warm=2)
    del keep, ref_p, ref_s, w0, gr, s0, tp, ts
    torch.cuda.empty_cache()
    per_trial = 1 + 5          # time_callable's warmup and runs
    st = dict(elements=n, bucket=at.shape_bucket((n,))[0],
              config=dict(cold.config), cold_trials=cold.trials,
              cold_search_ms=cold.search_ms,
              trial_launches=trial_launches,
              timings_ms={str(dict(k)["chunk"]): v
                          for k, v in cold.timings_ms.items()},
              warm_hit=warm.cache_hit, warm_trials=warm.trials,
              warm_launches=warm_launches,
              candidates_bit_equal_to_chunk=equal,
              chunk_vs_plain_err=err, chunk_vs_plain_ok=plain_ok,
              next_launch_chunk=next_chunk,
              next_launches=next_launches, ms=ms, plain_ms=plain_ms,
              library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    st["ok"] = (cold.trials > 0 and trial_launches == per_trial * cold.trials
                and warm.cache_hit and warm.trials == 0
                and warm_launches == 0 and all(equal.values()) and plain_ok
                and next_chunk == cold.config.chunk and next_launches == 1)
    return st


# ---------------------------------------------------------------------------
# phase 13: Switch-MoE training at full width
# ---------------------------------------------------------------------------

# (weights, entry point): TrainStep (f32 optimizer state) and the gluon
# Trainer (state in the weights' dtype: the chunk kernel's bf16/bf16
# instance for a bf16 layer)
MOE_RUNS = (("float32", "step"), ("bfloat16", "step"),
            ("float32", "trainer"), ("bfloat16", "trainer"))
MOE_FAULTS = ("combine_without_gate",)


def moe_tol(dtype):
    """Loss trajectory limit, relative, kernel route vs its plain oracle.
    f32: the gathers are copies and one f32 multiply on both routes and
    the chunk kernel is Adam's math, so the runs differ by f32 rounding of
    the update alone (fused multiply-adds) and the routing flips only at
    near ties, each token 1/8192 of the loss: 1e-4, `traj_tol`'s f32 limit.
    bf16: the kernel's combine multiplies in f32 and casts once, the
    reference in bf16 (two roundings, as in JAX), so rows differ by a bf16
    step and the difference spreads through the updates: 1e-3,
    `traj_tol`'s bf16 kernel-route limit.  The planted fault shows how far
    above it a wrong kernel lands."""
    return 1e-3 if dtype == "bfloat16" else 1e-4


def moe_batch(dev, dtype, seed=21):
    """bench.py's 64 x 128 tokens at hidden 768: seeded x and target."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(MOE_B, MOE_L, MOE_H, generator=g).to(dev, dt)
                 for _ in range(2))


def moe_loss(out, x, y):
    """MSE to the target plus 0.01 x the load-balance loss, in f32."""
    return ((out[0].float() - y.float()) ** 2).mean() + 0.01 * out[1]


def moe_run(dev, dtype, entry, plain, batch, fault=None):
    """`TRAIN_STEPS` steps of the MoE layer (seed 0) with Adam lr 1e-4
    through `entry` under ``MXTPU_PALLAS=auto`` (or ``reference`` for the
    plain oracle); returns its stats, the step time and the experts the
    router chose at each step (recorded where `switch_moe` routes)."""
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.ops import moe_dispatch as md
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import MoEFeedForward, TrainStep
    from mxnet_tpu_torch.parallel import moe as moe_mod

    experts = []
    route0, combine_index0 = moe_mod.route, md.combine_index

    def recording_route(*a, **k):
        r = route0(*a, **k)
        experts.append(r[0])
        return r

    def gateless(expert, pos, kept, gate, e, c):
        slot, _ = combine_index0(expert, pos, kept, gate, e, c)
        return slot, kept.float()

    x, y = batch
    tokens = x.shape[0] * x.shape[1]
    mode = "reference" if plain else "auto"
    moe_mod.route = recording_route
    if fault == "combine_without_gate":
        md.combine_index = gateless
    try:
        with pallas_mode(mode):
            layer = MoEFeedForward(MOE_H, MOE_I, num_experts=MOE_E,
                                   capacity_factor=MOE_CF, dtype=dtype,
                                   device=dev, seed=0)
            opt = Adam(learning_rate=1e-4)
            if entry == "step":
                step = TrainStep(layer, opt, moe_loss, num_model_args=1)
                step.warmup(x, y)
                fused = step._fused_opt_kernel
            else:
                trainer = Trainer(dict(layer.named_parameters()), opt)
                fused = None

            def one():
                if entry == "step":
                    return step.dispatch(x, y).loss
                loss = moe_loss(layer(x), x, y)
                # MXNet's convention: the batch's summed loss, which
                # step(batch_size) rescales by 1 / batch_size
                (loss * tokens).backward()
                trainer.step(tokens)
                return loss.detach()
            experts.clear()
            kernels.reset_launch_counts()
            losses = []
            for i in range(TRAIN_STEPS):
                losses.append(one())
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 2)
            launches = kernels.launch_counts()
    finally:
        moe_mod.route, md.combine_index = route0, combine_index0
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    return dict(losses=[float(v) for v in losses], step_ms=step_s * 1e3,
                launches=launches, fused_opt_kernel=fused,
                chunk=fo.last_chunk.get(dtype),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), \
        step_s, [e.clone() for e in experts]


def moe_flops_per_step(tokens):
    """The expert products: up and down, 2 E C H I operations each
    forward, three times that a training step."""
    cap = int(MOE_CF * tokens / MOE_E)
    return 3 * 2 * 2 * MOE_E * cap * MOE_H * MOE_I


def run_moe(dev, results, card):
    import torch
    flops = moe_flops_per_step(MOE_B * MOE_L)
    tokens = MOE_B * MOE_L
    for dtype, entry in MOE_RUNS:
        key = f"{dtype}_{entry}"
        batch = moe_batch(dev, dtype)
        torch.cuda.reset_peak_memory_stats()
        st, step_s, ex = moe_run(dev, dtype, entry, False, batch)
        torch.cuda.empty_cache()
        pst, pstep_s, pex = moe_run(dev, dtype, entry, True, batch)
        torch.cuda.empty_cache()
        want = {k: 0 for k in st["launches"]}
        want.update(moe_dispatch=TRAIN_STEPS, moe_combine=TRAIN_STEPS,
                    fused_optimizer_chunk=TRAIN_STEPS)
        if st["launches"] != want:
            raise AssertionError(f"moe {key}: kernel launches "
                                 f"{st['launches']}, want {want}")
        if any(pst["launches"].values()):
            raise AssertionError(f"moe {key}: the plain run launched "
                                 f"kernels {pst['launches']}")
        ls = st["losses"]
        if not all(math.isfinite(v) for v in ls):
            raise AssertionError(f"moe {key}: non-finite loss {ls}")
        dev_rel = traj_dev(ls, pst["losses"])
        peak = PEAK[dtype]
        st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  trajectory_rel_dev=dev_rel, trajectory_tol=moe_tol(dtype),
                  tokens_routed_apart=[int((a != b).sum())
                                       for a, b in zip(ex, pex)],
                  tokens_per_s=tokens / step_s,
                  plain_tokens_per_s=tokens / pstep_s,
                  flops_per_step=flops, tflops=flops / step_s / 1e12,
                  peak_share=flops / step_s / peak, peak_flops=peak)
        results["moe"][key] = st
        print(f"[moe {key}] {json.dumps(st)}", flush=True)
        print(f"[moe {key}] {tokens / step_s:.1f} tokens/s, "
              f"{st['step_ms']:.3f} ms/step, {st['tflops']:.2f} TFLOP/s = "
              f"{100 * st['peak_share']:.2f}% of the dense {dtype} peak "
              f"({peak / 1e12:.0f} TFLOP/s) of {card}", flush=True)
        tol = moe_tol(dtype)
        if dev_rel > tol:
            raise AssertionError(
                f"moe {key}: loss trajectory departs from the plain path's "
                f"by {dev_rel:.3g} (limit {tol}) ({ls} vs {pst['losses']})")
        if not ls[-1] < ls[0]:
            raise AssertionError(f"moe {key}: loss did not fall {ls}")

    # the control: a combine that ignores the gate, read against the f32
    # TrainStep run's oracle and limit
    oracle = results["moe"]["float32_step"]["plain_losses"]
    tol = moe_tol("float32")
    for fault in MOE_FAULTS:
        st, _, _ = moe_run(dev, "float32", "step", False,
                           moe_batch(dev, "float32"), fault)
        torch.cuda.empty_cache()
        dev_rel = traj_dev(st["losses"], oracle)
        results["moe_controls"][fault] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol, caught=dev_rel > tol)
        print(f"[moe control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            raise AssertionError(
                f"moe control {fault}: the planted fault departs from the "
                f"oracle by only {dev_rel:.3g} <= {tol}")


# ---------------------------------------------------------------------------

def kernel_entries(results):
    """One entry per ported kernel for the ``kernels`` line: the
    representative main-path case (K1: f32 decode C=1 MHA, no window; K2:
    int8 f32 M=8 768->2304; flash: f32 with the padding bias and dropout
    0.1, as the BERT step calls it; cross-entropy: f32 (1280, 30522); the
    fused norm: bf16 LayerNorm at (8192, 768), the step's own; the chunk:
    Adam over the f32 BERT-base model; LAMB: the bf16 model, each phase's
    device time over all tensors, beside the plain LAMB update (both
    phases) and no library call) and the largest error over every case.
    The MoE gather: dispatch and combine at the slice's f32 shapes (8192
    tokens, 8 x 1280 slots, H 768).  Launches are the counts of the
    main-path runs (serving for K1/K2, the BERT and MoE training runs for
    the others)."""
    k1, k2, k3, k4, k5, k6, k7 = (results[k] for k in (
        "k1", "k2", "k3", "k4", "k5", "k6", "k7"))
    rep1 = next(c for c in k1 if c["dtype"] == "float32" and c["C"] == 1
                and c["Hkv"] == 12 and c["window"] is None)
    rep2 = next(c for c in k2 if c["bits"] == 8 and c["dtype"] == "float32"
                and c["M"] == 8 and c["N"] == 2304)
    rep3 = next(c for c in k3 if c["dtype"] == "float32"
                and c["case"] == "pad_dropout")
    rep4 = next(c for c in k4 if c["dtype"] == "float32" and c["V"] == 30522)
    rep5 = next(c for c in k5 if c["dtype"] == "bfloat16" and
                c["rows"] == 8192 and c["case"] == "ln")
    chunk = [c for c in k6 if c["rule"] != "lamb"]
    lamb = [c for c in k6 if c["rule"] == "lamb"]
    rep7 = next(c for c in chunk if c["dtype"] == "float32" and
                c["rule"] == "adam")
    rep8 = next(c for c in lamb if c["dtype"] == "bfloat16")
    rep_d = next(c for c in k7 if c["dtype"] == "float32" and
                 c["T"] == 8192 and c["op"] == "dispatch")
    rep_c = next(c for c in k7 if c["dtype"] == "float32" and
                 c["T"] == 8192 and c["op"] == "combine")
    e2e = results["e2e"]
    train = dict(results["train"], **results["moe"])
    k1_launch = e2e.get("float32", {}).get("launches", {}).get(
        "ragged_paged_attention", 0)
    k2_launch = sum(e2e.get(k, {}).get("launches", {}).get(
        "quantized_matmul", 0) for k in ("int8", "int4"))

    def train_launches(name):
        return sum(r["launches"][name] for r in train.values())

    def entry(name, src, replaces, launches, cases, rep, pre="", ms=None):
        mk = ms or pre + "ms"           # the kernel time's key; its bound's
        return {"name": name, "route": "cuda", "source": src,   # beside it
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": rep[mk], "kernel_ms": rep[mk],
                "plain_ms": rep[pre + "plain_ms"],
                "bound_ms": rep[mk[:-2] + "bound_ms"],
                "bound_by": rep[mk[:-2] + "bound_by"],
                "library_ms": rep[pre + "library_ms"]}

    fa_src = "mxnet_tpu_torch/csrc/flash_attention.cu"
    fa_py = "mxnet_tpu/ops/pallas/flash_attention.py"
    sx_src = "mxnet_tpu_torch/csrc/softmax_xent.cu"
    sx_py = "mxnet_tpu/ops/pallas/softmax_xent.py"
    fo_src = "mxnet_tpu_torch/csrc/fused_optimizer.cu"
    fo_py = "mxnet_tpu/ops/pallas/fused_optimizer.py"
    return [
        entry("ragged_paged_attention",
              "mxnet_tpu_torch/csrc/paged_attention.cu",
              "mxnet_tpu/ops/pallas/paged_attention.py:285", k1_launch, k1,
              rep1),
        entry("quantized_matmul",
              "mxnet_tpu_torch/csrc/quantized_matmul.cu",
              "mxnet_tpu/ops/pallas/quantized_matmul.py:341", k2_launch, k2,
              rep2),
        entry("flash_attention_fwd", fa_src, f"{fa_py}:284",
              train_launches("flash_attention_fwd"), k3, rep3),
        entry("flash_attention_bwd", fa_src, f"{fa_py}:489",
              train_launches("flash_attention_bwd"), k3, rep3, "bwd_"),
        entry("softmax_xent_fwd", sx_src, f"{sx_py}:95",
              train_launches("softmax_xent_fwd"), k4, rep4),
        entry("softmax_xent_bwd", sx_src, f"{sx_py}:127",
              train_launches("softmax_xent_bwd"), k4, rep4, "bwd_"),
        entry("fused_norm", "mxnet_tpu_torch/csrc/fused_norm.cu",
              "mxnet_tpu/ops/pallas/fused_norm.py:164",
              train_launches("fused_norm"), k5, rep5),
        entry("fused_optimizer_chunk", fo_src, f"{fo_py}:220",
              train_launches("fused_optimizer_chunk"), chunk, rep7),
        entry("lamb_phase_a", fo_src, f"{fo_py}:307",
              train_launches("lamb_phase_a"), lamb, rep8,
              ms="phase_a_ms"),
        entry("lamb_phase_b", fo_src, f"{fo_py}:333",
              train_launches("lamb_phase_b"), lamb, rep8,
              ms="phase_b_ms"),
        entry("moe_dispatch", "mxnet_tpu_torch/csrc/moe_dispatch.cu",
              "mxnet_tpu/ops/pallas/moe_dispatch.py:139",
              train_launches("moe_dispatch"),
              [c for c in k7 if c["op"] == "dispatch"], rep_d),
        entry("moe_combine", "mxnet_tpu_torch/csrc/moe_dispatch.cu",
              "mxnet_tpu/ops/pallas/moe_dispatch.py:139",
              train_launches("moe_combine"),
              [c for c in k7 if c["op"] == "combine"], rep_c),
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
               "e2e": {}, "train": {}, "train_controls": {}, "tune": {},
               "moe": {}, "moe_controls": {}}
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

    for name, fn in (("k1", k1_cases), ("k2", k2_cases), ("k3", k3_cases),
                     ("k4", k4_cases), ("k5", k5_cases), ("k6", k6_cases),
                     ("k7", k7_cases)):
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
    try:
        run_train(dev, results, card)
    except Exception:
        traceback.print_exc()
        failed.append("train")
    for name, fn in (("tune", run_tune), ("moe", run_moe)):
        try:
            fn(dev, results, card)
        except Exception:
            traceback.print_exc()
            failed.append(name)
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
