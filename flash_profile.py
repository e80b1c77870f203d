#!/usr/bin/env python3
"""The flash attention kernels and the BERT step's time in them, beside
another tree.

    python3 flash_profile.py [--other DIR] [--k3-only]
                             [--out chiprun_out/flash_profile.json]
    python3 flash_profile.py --bwd-plans [--out ...]

Runs each tree in turns (this, other, other, this with ``--other``, an
earlier commit unpacked with ``git archive``; this alone without), each
run in fresh processes of that tree with its own package, kernels and
`chip_smoke.py`:
- `chip_smoke.k3_cases`: phase 6's flash cases (B 64, H 12, L 128, D 64;
  five masks, f32 and bf16), forward and backward timed by the tree's
  `chip_smoke.time_ms` (the same timer in both trees) beside SDPA;
- the tree's ``train_profile.py``: the BERT-base step's traced wall,
  device time and device time by kernel class, per run of its ``RUNS``.
Prints every run's numbers and, per flash case, each tree's mean forward
and backward ms (the forward also device-only and its host µs a call,
where the tree's phase 6 times them) beside SDPA's.  ``--k3-only`` leaves
the training profile out.

``--bwd-plans`` instead times the bf16 backward's launch plans at GPT-2
small's attention (B 8, H 12, L 1024, D 64, causal, dropout 0.1) and at
the gpt_gqa phase's (the same over 3 kv heads, window 256): the grid of
persistent blocks, one an SM (`_bwd_plan`'s bf16 rule) or one an item
(its f32 rule), at key tiles of 64 and 128, each by `chip_smoke.time_ms`.
Needs a CUDA card.
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
torch.backends.cuda.matmul.allow_tf32 = False
json.dump(chip_smoke.k3_cases(torch.device("cuda", 0)), open(sys.argv[1], "w"))
"""


def run_tree(tree, out_dir, i, k3_only=False):
    path = os.path.join(out_dir, f"flash_run{i}.json")
    subprocess.run([sys.executable, "-c", _RUN, path], cwd=tree, check=True)
    if k3_only:
        with open(path) as f:
            return dict(k3=json.load(f), steps={})
    prof = os.path.join(out_dir, f"flash_run{i}_train_profile.json")
    subprocess.run([sys.executable, "train_profile.py", "--out", prof],
                   cwd=tree, check=True, stdout=subprocess.DEVNULL)
    with open(path) as f:
        k3 = json.load(f)
    with open(prof) as f:
        profile = json.load(f)
    steps = {k: dict(wall_ms=v["wall_ms_per_step"],
                     device_ms=v["device_ms_per_step"],
                     idle=v["device_idle_share"],
                     launches=v["kernel_launches_per_step"],
                     by_class=v["device_ms_per_step_by_class"])
             for k, v in profile.items() if isinstance(v, dict)}
    return dict(k3=k3, steps=steps)


# (name, B, H, kv heads, L, window): the two shapes `--bwd-plans` times
BWD_PLAN_SHAPES = (("gpt2_causal", 8, 12, 12, 1024, None),
                   ("gpt_gqa_window", 8, 12, 3, 1024, 256))


def bwd_plans():
    """The bf16 backward at `BWD_PLAN_SHAPES` under each launch plan: the
    grid (one persistent block an SM, or one an item) and the key tile."""
    import torch
    sys.path.insert(0, HERE)
    from chip_smoke import time_ms
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(5)
    seed = torch.tensor([11], dtype=torch.int32, device=dev)
    rows = []
    for name, B, H, G, L, window in BWD_PLAN_SHAPES:
        D, rep = 64, H // G
        q, do = (torch.randn(B, G, rep * L, D, generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, G, L, D, generator=g).to(dev, torch.bfloat16)
                for _ in range(2))
        flags = (D ** -0.5, True, 0.1, False, False)
        kw = dict(window=window, lq=L)
        o, lse = fa._flash_fwd_cuda(q, k, v, None, seed, *flags, **kw)
        args = (q, k, v, None, seed, o, lse, do) + flags
        for bk in fa.BWD_KEY_TILES:
            plan = fa._bwd_plan(B, H, L, L, D, torch.bfloat16,
                                kernels.sm_count(dev), bk=bk, kv_heads=G)
            for grid, blocks in (("sm", min(plan.blocks,
                                             kernels.sm_count(dev))),
                                 ("item", plan.blocks)):
                p = plan._replace(grid=blocks)
                row = dict(shape=name, bk=bk, grid=grid, blocks=p.grid,
                           ms=time_ms(lambda: fa._flash_bwd_cuda(
                               *args, plan=p, **kw)))
                rows.append(row)
                print(f"[bwd plan] {json.dumps(row)}", flush=True)
        rows.append(dict(shape=name, default=fa._bwd_plan(
            B, H, L, L, D, torch.bfloat16, kernels.sm_count(dev),
            kv_heads=G)._asdict()))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None,
                    help="a second tree to run in the same call")
    ap.add_argument("--k3-only", action="store_true",
                    help="time the flash cases only, no training profile")
    ap.add_argument("--bwd-plans", action="store_true",
                    help="time the bf16 backward's launch plans instead")
    ap.add_argument("--out", default=os.path.join(
        HERE, "chiprun_out", "flash_profile.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_profile: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    if args.bwd_plans:
        with open(args.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0),
                       "bwd_plans": bwd_plans()}, f, indent=1)
        return 0
    order = ["this", "other", "other", "this"] if args.other else ["this"]
    trees = {"this": HERE, "other": os.path.abspath(args.other or HERE)}
    runs = []
    for i, which in enumerate(order):
        r = run_tree(trees[which], out_dir, i, args.k3_only)
        r["tree"] = which
        runs.append(r)
        for k, v in r["steps"].items():
            print(f"[run {i} {which}] {k} {json.dumps(v)}", flush=True)
    rows, ok = [], True
    for c in runs[0]["k3"]:
        k = (c["dtype"], c["case"])
        row = {"dtype": k[0], "case": k[1]}
        for which in ("this", "other"):
            got = [d for r in runs if r["tree"] == which for d in r["k3"]
                   if (d["dtype"], d["case"]) == k]
            for name in ("ms", "device_ms", "host_us", "library_ms",
                         "library_device_ms", "bwd_ms", "bwd_library_ms"):
                vals = [d[name] for d in got if name in d]
                if vals:    # a parent's phase 6 may time fewer of them
                    row[f"{which}_{name}"] = sum(vals) / len(vals)
        ok = ok and all(d["ok"] for r in runs if r["tree"] == "this"
                        for d in r["k3"] if (d["dtype"], d["case"]) == k)
        rows.append(row)
        print(f"[k3] {json.dumps(row)}", flush=True)
    with open(args.out, "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "order": order,
                   "other": args.other, "runs": runs, "cases": rows}, f,
                  indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
