#!/usr/bin/env python3
"""The fused norm, LAMB's phases and the BERT steps that run them, beside
another tree.

    python3 norm_profile.py [--other DIR] [--out profile_output/norm_profile.json]

Runs each tree in turns (this, other, other, this with ``--other``, an
earlier commit unpacked with ``git archive``; this alone without), each
run in fresh processes of that tree with its own package, kernels and
`chip_smoke.py`:
- `chip_smoke.k5_cases`: the fused norm's cases (LN / RMS, with and
  without a residual, f32 and bf16, at (8192, 768), (1280, 768) and
  (37, 200)) timed by the tree's `chip_smoke.time_ms` beside
  ``F.layer_norm`` / ``F.rms_norm`` and the bound;
- `chip_smoke.k6_cases` with LAMB alone: phases A and B over BERT-base's
  159 tensors, f32 and bf16 models, device times from ``torch.profiler``;
- the tree's ``train_profile.py`` for the bf16 Adam, bf16 LAMB and f32
  LAMB steps on the kernel route: traced wall, device time and device time
  by kernel class.
Prints every run's numbers and, per case, each tree's mean beside the
other's.  Needs a CUDA card.
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
dev = torch.device("cuda", 0)
k5 = chip_smoke.k5_cases(dev)
chip_smoke.OPT_RULES = tuple(r for r in chip_smoke.OPT_RULES
                             if r[0] == "lamb")
k6 = chip_smoke.k6_cases(dev)
json.dump({"k5": k5, "k6": k6}, open(sys.argv[1], "w"))
"""

_STEPS = """
import sys, train_profile
train_profile.RUNS = (("bfloat16", "Adam", "auto"),
                      ("bfloat16", "LAMB", "auto"),
                      ("float32", "LAMB", "auto"))
sys.exit(train_profile.main(["--out", sys.argv[1]]))
"""

K5_KEYS = ("ms", "device_ms", "host_us", "copy_ms", "library_ms",
           "library_device_ms", "plain_ms", "bound_ms")
K6_KEYS = ("phase_a_ms", "phase_b_ms", "device_ms", "call_ms",
           "phase_a_bound_ms", "phase_b_bound_ms")


def run_tree(tree, out_dir, i):
    path = os.path.join(out_dir, f"norm_run{i}.json")
    subprocess.run([sys.executable, "-c", _RUN, path], cwd=tree, check=True,
                   stdout=subprocess.DEVNULL)
    prof = os.path.join(out_dir, f"norm_run{i}_train_profile.json")
    subprocess.run([sys.executable, "-c", _STEPS, prof], cwd=tree,
                   check=True, stdout=subprocess.DEVNULL)
    with open(path) as f:
        kern = json.load(f)
    with open(prof) as f:
        profile = json.load(f)
    steps = {k: dict(wall_ms=v["wall_ms_per_step"],
                     device_ms=v["device_ms_per_step"],
                     idle=v["device_idle_share"],
                     launches=v["kernel_launches_per_step"],
                     by_class=v["device_ms_per_step_by_class"])
             for k, v in profile.items() if isinstance(v, dict)}
    return dict(k5=kern["k5"], k6=kern["k6"], steps=steps)


def _means(runs, phase, key_of, keys):
    """Per case of `phase`: each tree's mean of every key in `keys` that
    its runs recorded (a parent may time fewer of them)."""
    rows = []
    for c in runs[0][phase]:
        k = key_of(c)
        row = dict(zip(("dtype", "shape", "case"), k))
        for which in ("this", "other"):
            got = [d for r in runs if r["tree"] == which for d in r[phase]
                   if key_of(d) == k]
            for name in keys:
                vals = [d[name] for d in got if d.get(name) is not None]
                if vals:
                    row[f"{which}_{name}"] = sum(vals) / len(vals)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None,
                    help="a second tree to run in the same call")
    ap.add_argument("--out", default=os.path.join(
        HERE, "profile_output", "norm_profile.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("norm_profile: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    order = ["this", "other", "other", "this"] if args.other else ["this"]
    trees = {"this": HERE, "other": os.path.abspath(args.other or HERE)}
    runs = []
    for i, which in enumerate(order):
        r = run_tree(trees[which], out_dir, i)
        r["tree"] = which
        runs.append(r)
        for k, v in r["steps"].items():
            print(f"[run {i} {which}] {k} {json.dumps(v)}", flush=True)
    k5 = _means(runs, "k5", lambda c: (c["dtype"], (c["rows"], c["h"]),
                                       c["case"]), K5_KEYS)
    k6 = _means(runs, "k6", lambda c: (c["dtype"], c["tensors"], c["rule"]),
                K6_KEYS)
    for row in k5:
        print(f"[k5] {json.dumps(row)}", flush=True)
    for row in k6:
        print(f"[k6] {json.dumps(row)}", flush=True)
    ok = all(d["ok"] for r in runs if r["tree"] == "this"
             for d in r["k5"] + r["k6"])
    with open(args.out, "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "order": order,
                   "other": args.other, "runs": runs, "k5": k5, "k6": k6},
                  f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
