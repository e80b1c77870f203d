#!/usr/bin/env python3
"""Where a fused serving step of the PyTorch port spends its time, on the card.

    python3 serve_profile.py [--out chiprun_out/serve_profile.json]

Builds full-width GPT-2 small (seeded random weights) and an
``InferenceEngine(ServeConfig(max_slots=8, max_len=512, page_size=16,
prefill_chunk=16))`` per weight format (f32, int8), then over an int8 KV
pool (``kv_dtype="int8"``) with f32 weights and with int8 weights under
``MXTPU_QUANT_ACT=1``, fills all 8 slots with
128-token prompts, and traces two windows with ``torch.profiler``: the
first prefill steps (C=16, every slot prefilling) and a steady decode
window (C=1).  For each window it reports the host wall per step, the
device time per step (the sum of kernel durations), the device idle share
(1 - device / wall), kernel launches per step, K1's and K2's device time
and calls per step (kernels named ``rpa*`` and ``qmm*``), and the kernels
that take the most device time.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _dev_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_window(engine, n_steps):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
    dev_us = sum(_dev_us(e) for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=_dev_us, reverse=True)[:12]
    k1 = [e for e in kern if "rpa" in e.key]
    k2 = [e for e in kern if "qmm" in e.key]
    return {
        "steps": n_steps,
        "wall_ms_per_step": wall * 1e3 / n_steps,
        "device_ms_per_step": dev_us / 1e3 / n_steps,
        "device_idle_share": 1.0 - dev_us / 1e6 / wall,
        "kernel_launches_per_step": launches / n_steps,
        "k1_ms_per_step": sum(_dev_us(e) for e in k1) / 1e3 / n_steps,
        "k1_calls_per_step": sum(e.count for e in k1) / n_steps,
        "k2_ms_per_step": sum(_dev_us(e) for e in k2) / 1e3 / n_steps,
        "k2_calls_per_step": sum(e.count for e in k2) / n_steps,
        "top_kernels": [{"name": e.key[:90], "calls_per_step":
                         e.count / n_steps,
                         "ms_per_step": _dev_us(e) / 1e3 / n_steps}
                        for e in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "serve_profile.json"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt_small(dropout=0.0)
    model = GPTForCausalLM(cfg, seed=0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, 128).tolist()
               for _ in range(8)]
    out = {"card": torch.cuda.get_device_name(0)}
    for label, bits, kv, act in (("float32", 0, "", None),
                                 ("int8", 8, "", None),
                                 ("int8_kv", 0, "int8", None),
                                 ("int8_kv_act8", 8, "int8", "1")):
        if act:
            os.environ["MXTPU_QUANT_ACT"] = act
        else:
            os.environ.pop("MXTPU_QUANT_ACT", None)
        eng = InferenceEngine(model, ServeConfig(
            max_slots=8, max_len=512, page_size=16, prefill_chunk=16,
            quant_bits=bits, kv_dtype=kv), seed=0)
        eng.warmup()
        for p in prompts:
            eng.submit(p, max_new_tokens=64)
        res = {"prefill": profile_window(eng, 4)}
        while any(s is not None and len(s.req._sequence()) - s.ctx > 1
                  for s in eng.scheduler._slots):
            eng.step()                      # finish the prefills
        for _ in range(3):
            eng.step()                      # settle into decode
        res["decode"] = profile_window(eng, 10)
        eng.run_until_idle()
        out[label] = res
        print(f"[{label}] {json.dumps(res)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
