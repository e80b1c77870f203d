#!/usr/bin/env python3
"""K1, the ragged paged attention, and f32 serving, beside another tree.

    python3 k1_profile.py [--other DIR] [--out chiprun_out/k1_profile.json]

Runs each tree in turns (this, other, other, this with ``--other``, an
earlier commit unpacked with ``git archive``; this alone without), each
run in fresh processes of that tree with its own package, kernels and
`chip_smoke.py`:
- `chip_smoke.k1_cases`: phase 2's K1 cases, timed by the tree's
  `chip_smoke.time_ms` (the same timer in both trees);
- phase 3 in float32: `chip_smoke.serve_phase` (16 staggered greedy
  requests, 32 new tokens), its tokens/s and step ms;
- phase 5 in bfloat16, the same requests: its tokens/s, step ms and the
  share of streams equal to the plain engine's;
- the tree's ``serve_profile.py``: the f32 prefill and decode windows'
  traced wall, device time and K1's device time a step (kernels named
  ``rpa*``).
Prints every run's numbers and, per K1 case, each tree's mean.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

_RUN = """
import json, sys, torch, chip_smoke
from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
k1 = chip_smoke.k1_cases(dev)
cfg = gpt_small(dropout=0.0)
model = GPTForCausalLM(cfg, device=dev, seed=0)
prompts = chip_smoke.make_prompts(cfg.vocab_size)
_, _, _, st = chip_smoke.serve_phase(model, prompts, 32, 0)
del model
torch.cuda.empty_cache()
model = GPTForCausalLM(gpt_small(dropout=0.0, dtype="bfloat16"), device=dev,
                       seed=0)
streams, pstreams, _, st16 = chip_smoke.serve_phase(model, prompts, 32, 0)
st16["equal_stream_share"] = sum(
    a == b for a, b in zip(streams, pstreams)) / len(streams)
json.dump({"k1": k1, "serve_f32": st, "serve_bf16": st16},
          open(sys.argv[1], "w"))
"""


def run_tree(tree, out_dir, i):
    path = os.path.join(out_dir, f"k1_run{i}.json")
    subprocess.run([sys.executable, "-c", _RUN, path], cwd=tree, check=True)
    prof = os.path.join(out_dir, f"k1_run{i}_serve_profile.json")
    subprocess.run([sys.executable, "serve_profile.py", "--out", prof],
                   cwd=tree, check=True, stdout=subprocess.DEVNULL)
    with open(path) as f:
        run = json.load(f)
    with open(prof) as f:
        run["profile_f32"] = json.load(f)["float32"]
    return run


def k1_ms(window):
    """K1's device ms a step, from any tree's `serve_profile` window."""
    if "k1_ms_per_step" in window:
        return window["k1_ms_per_step"]
    return sum(k["ms_per_step"] for k in window["top_kernels"]
               if "rpa" in k["name"])


def key(c):
    return (c["dtype"], c.get("pool_dtype", c["dtype"]), c["C"], c["Hkv"],
            c["window"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None,
                    help="a second tree to run in the same call")
    ap.add_argument("--out", default=os.path.join(
        HERE, "chiprun_out", "k1_profile.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_profile: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    order = ["this", "other", "other", "this"] if args.other else ["this"]
    trees = {"this": HERE, "other": os.path.abspath(args.other or HERE)}
    runs = []
    for i, which in enumerate(order):
        r = run_tree(trees[which], out_dir, i)
        s, s16 = r["serve_f32"], r["serve_bf16"]
        w = {k: dict(wall_ms=v["wall_ms_per_step"],
                     device_ms=v["device_ms_per_step"],
                     idle=v["device_idle_share"], k1_ms=k1_ms(v))
             for k, v in r["profile_f32"].items()}
        runs.append(dict(tree=which, tokens_per_s=s["tokens_per_s"],
                         step_ms_mean=s["step_ms_mean"],
                         plain_tokens_per_s=s["plain_tokens_per_s"],
                         k1_launches=s["launches"]["ragged_paged_attention"],
                         fused_steps=s["fused_steps"], profile=w, k1=r["k1"],
                         bf16_tokens_per_s=s16["tokens_per_s"],
                         bf16_step_ms_mean=s16["step_ms_mean"],
                         bf16_plain_tokens_per_s=s16["plain_tokens_per_s"],
                         bf16_equal_stream_share=s16["equal_stream_share"]))
        print(f"[run {i} {which}] f32 phase 3 {s['tokens_per_s']:.1f} "
              f"tokens/s, step {s['step_ms_mean']:.3f} ms (plain "
              f"{s['plain_tokens_per_s']:.1f}); bf16 phase 5 "
              f"{s16['tokens_per_s']:.1f} tokens/s, step "
              f"{s16['step_ms_mean']:.3f} ms, equal streams "
              f"{s16['equal_stream_share']:.4f}; profile "
              f"{json.dumps(w)}", flush=True)
    rows, ok = [], True
    for c in runs[0]["k1"]:
        k = key(c)
        row = dict(zip(("dtype", "pool_dtype", "C", "Hkv", "window"), k),
                   bound_ms=c["bound_ms"], library_ms=c["library_ms"])
        for which in ("this", "other"):
            got = [d for r in runs if r["tree"] == which
                   for d in r["k1"] if key(d) == k]
            if got:
                row[f"{which}_ms_runs"] = [d["ms"] for d in got]
                row[f"{which}_ms"] = sum(d["ms"] for d in got) / len(got)
        ok = ok and all(d["ok"] for r in runs if r["tree"] == "this"
                        for d in r["k1"] if key(d) == k)
        rows.append(row)
        print(f"[k1] {k[0]:8s} pool {k[1]:8s} C {k[2]:2d} Hkv {k[3]:2d} "
              f"window {str(k[4]):4s}  this {row['this_ms']:.4f}  other "
              f"{row.get('other_ms', float('nan')):.4f}  SDPA "
              f"{c['library_ms']:.4f}  bound {c['bound_ms']:.4f} ms",
              flush=True)
    with open(args.out, "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "order": order,
                   "other": args.other, "runs": runs, "cases": rows}, f,
                  indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
