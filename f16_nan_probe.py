#!/usr/bin/env python3
"""Where the float16 GPT-2 small first goes non-finite on the reference
route (``MXTPU_PALLAS=reference``).

    python3 f16_nan_probe.py [--steps 20] [--out chiprun_out/f16_nan_probe]

Builds `gpt_small(dtype="float16")` from seed 0 on the card and trains it
as the chip smoke's gpt phase does (`TrainStep`, AdamW lr 3e-4, weight
decay 0.1, the (8, 1024) token batch), with every LayerNorm on the
reference route.  Every module's output is checked after its forward, and
the gradient of that output as the backward pass reaches it; each
LayerNorm is replaced by a copy of `ops.fused_norm.layer_norm_reference`
that checks every op it runs (the residual sum, mean, variance, var + eps,
rsqrt, the centred input, the normalised rows, the affine map) in the
forward pass and the gradient of each of them in the backward pass; after
each backward every parameter gradient, and after each update every
weight, is checked.  The events are printed in the order they happened
(the first is the answer) and written to ``<out>.json``; the inputs of the
LayerNorm call whose backward first gave a non-finite value (its input,
gain, bias and the gradient of its output, f16) go to ``<out>.npz``, so
the same op can be run again on the CPU through both packages.  Each
step also records how many LayerNorm calls ran, and over those whose
statistics are f16 the least ``var + eps`` and the largest ``rsqrt(var +
eps)^3``, the factor rsqrt's backward multiplies by (inf in f16 past
65504).
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_EVENTS = 40


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "f16_nan_probe"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("f16_nan_probe: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ["MXTPU_PALLAS"] = "reference"
    sys.path.insert(0, HERE)
    import chip_smoke
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small
    from mxnet_tpu_torch.ops import fused_norm
    from mxnet_tpu_torch.optimizer import AdamW
    from mxnet_tpu_torch.parallel import TrainStep

    dev = torch.device("cuda", 0)
    print(f"[card] {chip_smoke.card_line()}", flush=True)
    cfg = gpt_small(dtype="float16")
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    V = cfg.vocab_size
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(out, ids, lab):
        return ce(out.reshape(-1, V), lab.reshape(-1)).mean()

    state = {"step": 0, "ln_call": 0}
    # per step: LayerNorm calls seen, and over the f16 ones the least
    # var + eps and the largest rsqrt(var + eps)^3 (rsqrt's backward
    # multiplies by it: past 65504 it is inf in f16)
    margins = []
    events = []
    saved = {}
    ln_inputs = {}

    def bad(t):
        return t is not None and t.is_floating_point() and \
            not bool(torch.isfinite(t).all())

    def record(kind, where, t):
        if len(events) >= MAX_EVENTS:
            return
        tf = t.detach().float()
        fin = torch.isfinite(tf)
        ev = dict(step=state["step"], pass_=kind, where=where,
                  dtype=str(t.dtype), shape=list(t.shape),
                  n_nan=int(torch.isnan(tf).sum()),
                  n_inf=int(torch.isinf(tf).sum()),
                  finite_absmax=float(tf[fin].abs().max()) if fin.any()
                  else None,
                  finite_absmin=float(tf[fin].abs().min()) if fin.any()
                  else None)
        events.append(ev)
        print(f"[event {len(events)}] {json.dumps(ev)}", flush=True)

    def check(kind, where, t):
        if bad(t):
            record(kind, where, t)

    def grad_hook(where, call=None):
        def hook(g):
            if call is not None and where.endswith(":y"):
                ln_inputs[call]["dy"] = g.detach()
            if bad(g):
                if call is not None and "ln_call" not in saved:
                    inp = ln_inputs[call]
                    saved.update(ln_call=call, op=where, step=state["step"])
                    for k in ("x", "residual", "gamma", "beta", "dy"):
                        if inp.get(k) is not None:
                            saved[k] = inp[k].detach().cpu().numpy()
                record("backward", where, g)
        return hook

    def probe_ln(x, gamma, beta, eps=1e-5, residual=None):
        call = state["ln_call"]
        state["ln_call"] += 1
        ln_inputs[call] = dict(x=x.detach(), gamma=gamma.detach(),
                               beta=beta.detach(),
                               residual=None if residual is None
                               else residual.detach())
        tag = f"ln{call}"
        ops = []
        s = residual + x if residual is not None else x
        ops.append(("s", s))
        mean = s.mean(dim=-1, keepdim=True)
        ops.append(("mean", mean))
        var = s.var(dim=-1, keepdim=True, correction=0)
        ops.append(("var", var))
        ve = var + eps
        ops.append(("var_eps", ve))
        r = torch.rsqrt(ve)
        ops.append(("rsqrt", r))
        m = margins[-1]
        m["ln_calls"] += 1
        if s.dtype == torch.float16:
            m["f16_calls"] += 1
            m["min_var_eps"] = min(m["min_var_eps"], float(ve.min()))
            m["max_rsqrt_cubed"] = max(m["max_rsqrt_cubed"],
                                       float(r.float().max()) ** 3)
        d = s - mean
        ops.append(("centred", d))
        yn = d * r
        ops.append(("normed", yn))
        y = yn * fused_norm._row(gamma, s.dim()) + \
            fused_norm._row(beta, s.dim())
        ops.append(("y", y))
        for name, t in ops:
            check("forward", f"{tag}:{name}", t)
            if t.requires_grad:
                t.register_hook(grad_hook(f"{tag}:{name}", call))
        return (y, s) if residual is not None else y

    fused_norm.layer_norm_reference = probe_ln

    def fwd_hook(name):
        def hook(mod, inp, out):
            outs = out if isinstance(out, tuple) else (out,)
            for i, o in enumerate(outs):
                if torch.is_tensor(o):
                    check("forward", f"{name}[{i}]", o)
                    if o.requires_grad:
                        o.register_hook(grad_hook(f"{name}[{i}].grad"))
        return hook

    for name, m in model.named_modules():
        m.register_forward_hook(fwd_hook(name or "model"))

    opt = AdamW(learning_rate=chip_smoke.GPT_LR, wd=chip_smoke.GPT_WD)
    step = TrainStep(model, opt, loss_fn, num_model_args=1)
    inner = step._compute

    def compute(batch):
        loss, grads = inner(batch)
        check("forward", "loss", loss)
        for n, g in grads.items():
            check("backward", f"param_grad:{n}", g)
        return loss, grads
    step._compute = compute
    batch = chip_smoke.gpt_batch(dev, V)
    losses = []
    for i in range(args.steps):
        state["step"] = i + 1
        state["ln_call"] = 0
        ln_inputs.clear()
        margins.append(dict(step=i + 1, ln_calls=0, f16_calls=0,
                            min_var_eps=float("inf"), max_rsqrt_cubed=0.0))
        losses.append(float(step.dispatch(*batch).loss))
        for n, p in model.named_parameters():
            check("update", f"weight:{n}", p)
        print(f"[step {i + 1}] loss {losses[-1]} {json.dumps(margins[-1])}",
              flush=True)
        if len(events) >= MAX_EVENTS:
            break
    out = dict(card=chip_smoke.card_line(), losses=losses, events=events,
               margins=margins,
               first=events[0] if events else None,
               saved={k: v for k, v in saved.items()
                      if not isinstance(v, np.ndarray)})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(out, f, indent=1)
    arrays = {k: v for k, v in saved.items() if isinstance(v, np.ndarray)}
    if arrays:
        np.savez_compressed(args.out + ".npz", **arrays)
    print(json.dumps({"first": out["first"], "saved": out["saved"],
                      "losses": losses, "margins": margins}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
