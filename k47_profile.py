#!/usr/bin/env python3
"""The cross-entropy kernels (rows 5-6), the MoE row gather (row 11) and
the bf16 MoE and GPT steps that run them, beside another tree.

    python3 k47_profile.py [--other DIR] [--quick] [--plans]
                           [--out profile_output/k47_profile.json]

Runs each tree in turns (this, other, other, this with ``--other``, an
earlier commit unpacked with ``git archive``; this alone without), each
run in fresh processes started in that tree, so that they import its
package, kernels and `chip_smoke.py`:
- `chip_smoke.k4_cases`: the cross-entropy forward and backward at every
  ``XENT_SHAPES`` shape (BERT's MLM head, GPT's and NMT's logits, f32 and
  bf16), timed by the tree's `chip_smoke.time_ms` beside
  ``F.cross_entropy`` and the bound;
- `chip_smoke.k7_cases`: the gather's dispatch and combine at the MoE
  slice's shapes, timed beside ``torch.index_select`` and the bound;
- the tree's ``train_profile.py --moe --gpt`` for the bf16 ``TrainStep``
  steps of the MoE layer and GPT-2 small: traced wall, device time and
  device time by kernel class;
- the same measurement in both trees (`measure`): the host µs a call of
  the cross-entropy forward's and the gather's wrappers
  (`chip_smoke.host_us`), and each kernel timed twice at the shapes
  above, by `chip_smoke.time_ms` (its L2 flush writes 256 MB and leaves
  the cache full of dirty lines, whose write-back a small kernel pays)
  and by `clean_ms` (the flush reads 256 MB, so it leaves clean lines),
  beside a same-bytes floor under both timers (a copy of the gather's
  output, a row max over the logits) and the library call.
``--quick`` runs only `measure` in each tree; ``--plans`` also times
this tree's gather at the slice's shapes over a menu of launch plans
(`gather_plans`).  Prints every run's numbers and, per case, each tree's
mean beside the other's.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

_STEPS = """
import sys, train_profile
train_profile.MOE_RUNS = (("bfloat16", "step"),)
train_profile.GPT_RUNS = ("bfloat16",)
sys.exit(train_profile.main(["--moe", "--gpt", "--out", sys.argv[1]]))
"""

K4_KEYS = ("ms", "host_us", "plain_ms", "library_ms", "bound_ms", "bwd_ms",
           "bwd_bound_ms")
K7_KEYS = ("ms", "host_us", "plain_ms", "library_ms", "bound_ms")
MEASURE_KEYS = ("ms", "clean_ms", "floor_ms", "floor_clean_ms",
                "library_ms", "library_clean_ms", "host_us")
GATHER_SHAPES = (("float32", 768), ("bfloat16", 768))   # 8192 tokens, E 8


def clean_ms(fn, iters=30, warm=3):
    """Median time of one call (CUDA events around it) after an L2 flush
    that reads 256 MB: the cache then holds clean lines, so the call pays
    no write-back of the flush's own."""
    import torch
    flush = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warm):
        fn()
    flush.sum()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.sum()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in evs)
    return ts[len(ts) // 2]


def _gather_inputs(dev, dtype, H):
    """The slice's dispatch and combine operands (k7's routing)."""
    import torch
    import chip_smoke
    from mxnet_tpu_torch.ops import moe_dispatch as md
    dt = getattr(torch, dtype)
    t, expert, gate, pos, kept, C = chip_smoke.skewed_routing(
        dev, 8192, 8, H, 1.25, seed=11)
    g = torch.Generator().manual_seed(12)
    down = torch.randn(8 * C, H, generator=g).to(dev, dt)
    inv = md.dispatch_index(expert, pos, kept, 8, C)
    slot, scale = md.combine_index(expert, pos, kept, gate, 8, C)
    return {"dispatch": (t.to(dev, dt), inv, None),
            "combine": (down, slot, scale)}


def _timed(fns):
    """Each of `fns` ({prefix: call}) under both timers."""
    import chip_smoke
    r = {}
    for pre, fn in fns.items():
        r[pre + "ms"] = chip_smoke.time_ms(fn)
        r[pre + "clean_ms"] = clean_ms(fn)
    return r


def measure(dev):
    """The tree's kernels under both timers, beside the floors and the
    library calls, and their wrappers' host µs a call."""
    import torch
    import torch.nn.functional as tF
    import chip_smoke
    from mxnet_tpu_torch.ops import moe_dispatch as md
    from mxnet_tpu_torch.ops import softmax_xent as sx
    rows = []
    g = torch.Generator().manual_seed(0)
    for dtype, N, V in chip_smoke.XENT_SHAPES:
        x = (2.0 * torch.randn(N, V, generator=g)).to(dev,
                                                      getattr(torch, dtype))
        lab = torch.randint(0, V, (N,), generator=g).to(dev, torch.int32)
        y64 = lab.long()
        fns = {"": lambda: sx._xent_fwd_cuda(x, lab),
               "floor_": lambda: torch.amax(x, dim=-1),
               "library_": lambda: tF.cross_entropy(x.float(), y64,
                                                    reduction="none")}
        rows.append(dict(kernel="xent_fwd", case=[dtype, N, V],
                         host_us=chip_smoke.host_us(fns[""]),
                         **_timed(fns)))
        del x
    for dtype, H in GATHER_SHAPES:
        for op, (src, idx, scale) in _gather_inputs(dev, dtype, H).items():
            out = md.gather_rows(src, idx, scale, counter=f"moe_{op}")
            ref = out.clone()
            n = src.shape[0]
            padded = torch.cat([src, src.new_zeros(1, H)])
            idx64 = torch.where((idx >= 0) & (idx < n), idx, n).long()
            # k7's yardstick: index_select, times the scale for the
            # combine (a second call)
            if scale is None:
                def lib():
                    return torch.index_select(padded, 0, idx64)
            else:
                mult = scale.to(src.dtype)[:, None]

                def lib():
                    return torch.index_select(padded, 0, idx64) * mult
            fns = {"": lambda: md.gather_rows(src, idx, scale,
                                              counter=f"moe_{op}"),
                   "floor_": lambda: out.copy_(ref), "library_": lib}
            rows.append(dict(kernel=f"moe_{op}", case=[dtype, op, 8192, H],
                             host_us=chip_smoke.host_us(fns[""]),
                             **_timed(fns)))
    return rows


def gather_plans(dev):
    """This tree's gather at the slice's shapes over a menu of launch
    plans (pieces a lane a pass, rows a block), under both timers."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import moe_dispatch as md
    sms = kernels.sm_count(dev)
    rows = []
    for dtype, H in GATHER_SHAPES:
        for op, (src, idx, scale) in _gather_inputs(dev, dtype, H).items():
            n_rows = idx.shape[0]
            base = md._plan(n_rows, H, src.element_size(), 16, sms)
            for per_lane in (1, 2, 4):
                for per_block in sorted({base.rows_per_block, 8, 16, 32,
                                         64}):
                    plan = base._replace(
                        per_lane=per_lane,
                        depth=min(md.MAX_DEPTH, md.UNITS // per_lane),
                        rows_per_block=per_block,
                        grid=-(-n_rows // per_block))
                    rows.append(dict(
                        case=[dtype, op, 8192, H], plan=plan._asdict(),
                        default=plan == base,
                        **_timed({"": lambda: md._gather_cuda(
                            src, idx, scale, f"moe_{op}", plan=plan)})))
    return rows


def _worker(path, full, plans):
    """One run inside a tree (the working directory), whose package goes
    first on the path."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {"measure": measure(dev), "k4": [], "k7": [], "plans": []}
    if full == "1":
        res["k4"] = chip_smoke.k4_cases(dev)
        res["k7"] = chip_smoke.k7_cases(dev)
    if plans == "1":
        res["plans"] = gather_plans(dev)
    with open(path, "w") as f:
        json.dump(res, f)


def run_tree(tree, out_dir, i, full, plans):
    path = os.path.join(out_dir, f"k47_run{i}.json")
    subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                    path, str(int(full)), str(int(plans))], cwd=tree,
                   check=True, stdout=subprocess.DEVNULL)
    with open(path) as f:
        res = json.load(f)
    profile = {}
    if full:
        prof = os.path.join(out_dir, f"k47_run{i}_train_profile.json")
        subprocess.run([sys.executable, "-c", _STEPS, prof], cwd=tree,
                       check=True, stdout=subprocess.DEVNULL)
        with open(prof) as f:
            profile = json.load(f)
    res["steps"] = {k: dict(wall_ms=v["wall_ms_per_step"],
                            device_ms=v["device_ms_per_step"],
                            idle=v["device_idle_share"],
                            launches=v["kernel_launches_per_step"],
                            by_class=v["device_ms_per_step_by_class"])
                    for k, v in profile.items() if isinstance(v, dict)}
    return res


def _means(runs, phase, key_of, keys):
    """Per case of `phase` in this tree's runs: each tree's mean of every
    key in `keys` that its runs recorded."""
    rows = []
    for c in next(r for r in runs if r["tree"] == "this")[phase]:
        k = key_of(c)
        row = {"case": k}
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
        HERE, "profile_output", "k47_profile.json"))
    ap.add_argument("--quick", action="store_true",
                    help="only `measure`, in each tree")
    ap.add_argument("--plans", action="store_true",
                    help="also this tree's gather over a menu of plans")
    ap.add_argument("--worker", nargs=3, metavar=("PATH", "FULL", "PLANS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(*args.worker)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("k47_profile: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    order = ["this", "other", "other", "this"] if args.other else ["this"]
    trees = {"this": HERE, "other": os.path.abspath(args.other or HERE)}
    runs = []
    for i, which in enumerate(order):
        r = run_tree(trees[which], out_dir, i, not args.quick,
                     args.plans and which == "this")
        r["tree"] = which
        runs.append(r)
        for k, v in r["steps"].items():
            print(f"[run {i} {which}] {k} {json.dumps(v)}", flush=True)
    summary = {
        "measure": _means(runs, "measure", lambda c: tuple(c["case"]),
                          MEASURE_KEYS),
        "k4": _means(runs, "k4", lambda c: (c["dtype"], c["N"], c["V"],
                                            c.get("edge", False)), K4_KEYS),
        "k7": _means(runs, "k7", lambda c: (c["dtype"], c["op"], c["T"],
                                            c["H"]), K7_KEYS)}
    for name, rows in summary.items():
        for row in rows:
            print(f"[{name}] {json.dumps(row)}", flush=True)
    for r in runs:
        for p in r["plans"]:
            print(f"[plans] {json.dumps(p)}", flush=True)
    ok = all(d["ok"] for r in runs if r["tree"] == "this"
             for d in r["k4"] + r["k7"])
    with open(args.out, "w") as f:
        json.dump(dict(card=torch.cuda.get_device_name(0), order=order,
                       other=args.other, runs=runs, **summary), f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
