#!/usr/bin/env python3
"""Two optimizer-kernel times the smoke read under their byte bound,
timed again four ways, with each bound's bytes counted from the leaves.

    python3 opt_bound_check.py [--out chiprun_out/opt_bound_check.json]

The cases are the chip smoke's k6 cases (`chip_smoke._k6_case`'s inputs,
`_opt_tree` seed 8): LAMB over BERT-base's f16 leaves with f32 state and,
beside it, over its bf16 leaves; AdamW over GPT-2 small's f32 leaves.
Each kernel's device time is read from ``torch.profiler`` (k6's
`profile_ms`: calls back to back, nothing flushed), then with the 256 MB
flush before each call that writes (`chip_smoke.time_ms`'s ``zero_``) or
reads (k47's `clean_ms`'s ``sum``) before each call; the whole call is
also timed by `clean_ms` and `chip_smoke.time_ms` with CUDA events.  Each
bound is counted twice: `chip_smoke._opt_bound` and, independently, every
leaf's elements times the bytes the kernel reads and writes for it
(LAMB B: the weight read and written, phase A's f32 direction read; the
AdamW chunk: weight and gradient read, weight written, two f32 moments
read and written).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS = 10


def flushed_profile(fn, flush, iters=ITERS):
    """Device ms of one call by kernel name, ``torch.profiler`` over
    `iters` calls, `flush` (None, "write" or "read" of 256 MB) before
    each; the flush's own kernels are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    buf = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush == "write":
                buf.zero_()
            elif flush == "read":
                buf.sum()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or
                   getattr(e, "self_cuda_time_total", 0.0) or 0.0)
        if us > 0 and ("lamb" in e.key or "chunk" in e.key):
            out[e.key] = us / 1e3 / iters
    return out


def counted_bytes(rule, params, states):
    """Bytes one update moves, leaf by leaf, from the leaves' sizes."""
    per = {}
    for n, p in params.items():
        w = p.element_size()
        s = states[n][0].element_size() if states[n] else 4
        if rule == "lamb_b":
            per[n] = p.numel() * (w + w + 4)
        elif rule == "lamb_a":
            per[n] = p.numel() * (w + w + 2 * s + 2 * s + 4)
        else:                                   # adamw chunk
            per[n] = p.numel() * (w + w + w + 2 * s + 2 * s)
    return sum(per.values())


def case(dev, model, leaves, dtype, rule, cls, state_dtype="float32"):
    import torch
    import chip_smoke
    import k47_profile
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    lr = 1e-3 if rule == "lamb" else 1e-4
    opt = cls(learning_rate=lr)
    hp = {k: torch.full((), v, device=dev) for k, v in
          {"lr": lr, "wd": 0.01, "rescale_grad": 1.0, "t": 3.0}.items()}
    hp["clip_gradient"] = None
    params, grads, states = chip_smoke._opt_tree(leaves, opt, dev, seed=8,
                                                 state_dtype=state_dtype)

    def call():
        fo.apply_updates(opt, params, grads, states, hp, use_kernel=True)
    out = dict(model=model, dtype=dtype, state_dtype=state_dtype, rule=rule,
               elements=sum(p.numel() for p in params.values()),
               tensors=len(params))
    for flush in (None, "write", "read"):
        out[f"kernels_ms_flush_{flush}"] = flushed_profile(call, flush)
    out["call_clean_ms"] = k47_profile.clean_ms(call)
    out["call_time_ms"] = chip_smoke.time_ms(call)
    phases = ("a", "b") if rule == "lamb" else (None,)
    for ph in phases:
        key = f"lamb_{ph}" if ph else rule
        b_ms, by = chip_smoke._opt_bound(rule, params, ph, states)
        nbytes = counted_bytes(key, params, states)
        out[f"{key}_bound_ms"] = b_ms
        out[f"{key}_bound_by"] = by
        out[f"{key}_counted_bytes"] = nbytes
        out[f"{key}_counted_bound_ms"] = nbytes / chip_smoke.HBM_BPS * 1e3
    del params, grads, states
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "opt_bound_check.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("opt_bound_check: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch import optimizer as topt
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"[card] {card}", flush=True)
    kernels.build_all()
    res = {"card": card, "cases": []}
    for model, leaves_of, dtype, rule, cls in (
            ("bert_base", chip_smoke.bert_leaves, "float16", "lamb",
             topt.LAMB),
            ("bert_base", chip_smoke.bert_leaves, "bfloat16", "lamb",
             topt.LAMB),
            ("gpt_small", chip_smoke.gpt_leaves, "float32", "adamw",
             topt.AdamW)):
        c = case(dev, model, leaves_of(dtype), dtype, rule, cls)
        res["cases"].append(c)
        print(f"[case] {json.dumps(c)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
