#!/usr/bin/env python3
"""Where a BERT-base pretraining step — or, with ``--moe``, a Switch-MoE
training step, or with ``--gpt`` a GPT-2-small causal-LM step, or with
``--gpt-gqa`` the gpt_gqa phase's step, or with ``--gpt-d256`` the
gpt_d256 phase's — of the PyTorch port spends its time, on the card.

    python3 train_profile.py [--moe | --gpt | --gpt-gqa | --gpt-d256 |
                              --resnet50]
                             [--out chiprun_out/train_profile.json]

Builds full-width BERT-base (seeded random weights) and wraps it in
``TrainStep`` exactly as ``chip_smoke.py``'s train phase does
(``bench.py``'s batch: 64 x 128 tokens, 20 masked positions, padded by
``valid_length``, dropout 0.1), once per run of ``RUNS`` — weight dtype,
optimizer and ``MXTPU_PALLAS`` route: the default kernel route in bf16 and
f32 with Adam and in bf16 with LAMB, and the reference route in bf16 —
runs warmup and three steps, and traces five steps with
``torch.profiler``.  It reports the host wall per step, the device time per
step (the sum of kernel durations), the device idle share (1 - device /
wall), kernel launches per step, the device time per class of kernel
(cuBLAS/CUTLASS products, the port's flash, cross-entropy, fused-norm and
optimizer kernels, everything else) and the kernels that take the most
device time.  With ``--moe`` the runs are ``chip_smoke.py``'s moe phase —
``MoEFeedForward(768, 3072, 8 experts)`` on 64 x 128 tokens, Adam lr 1e-4,
the default kernel route — through ``TrainStep`` in f32 and bf16 and
through the gluon ``Trainer`` in bf16, and the row gather is a class of
its own.  With ``--gpt`` the runs are ``chip_smoke.py``'s gpt phase —
``gpt_small()`` at full width and depth on 8 x 1024 tokens, dropout 0.1,
AdamW lr 3e-4, the default kernel route — through ``TrainStep`` in bf16
and f32 without remat; ``--gpt-gqa`` the same with ``chip_smoke.py``'s
``GQA_ARCH`` (RoPE, 3 kv heads, window 256), ``--gpt-d256`` with its
``D256_ARCH`` (RoPE, 3 heads of 256 over one kv head).  With
``--resnet50`` the run is ``chip_smoke.py``'s vision phase's step —
``resnet50_v1(classes=1000)`` on 32 x 3 x 224 x 224, f32, TF32 off,
cuDNN deterministic, ``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` ->
``loss.backward()`` -> ``Trainer(net.collect_params(), "nag")`` — and
cuDNN's convolutions and the pools are classes of their own.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = (("bfloat16", "Adam", "auto"), ("float32", "Adam", "auto"),
        ("bfloat16", "LAMB", "auto"), ("bfloat16", "Adam", "reference"))
MOE_RUNS = (("float32", "step"), ("bfloat16", "step"),
            ("bfloat16", "trainer"))
GPT_RUNS = ("bfloat16", "float32")
CLASSES = (("flash_fwd", ("flash_fwd_kernel",)),
           ("flash_bwd", ("flash_bwd_kernel", "flash_bwd_di_kernel")),
           ("xent", ("xent_fwd_kernel", "xent_bwd_kernel")),
           ("norm", ("norm_kernel",)),
           ("optimizer", ("chunk_kernel", "lamb_a_kernel", "lamb_b_kernel")),
           ("moe_gather", ("gather_rows_kernel",)),
           ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                     "winograd")),
           ("pool", ("pool",)),
           ("gemm", ("gemm", "sgemm", "cutlass", "cublas", "nvjet")))


def _dev_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _klass(name):
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def profile_steps(step, batch, n_steps):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step.dispatch(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
    dev_us = sum(_dev_us(e) for e in kern)
    by_class = {}
    for e in kern:
        k = _klass(e.key)
        by_class[k] = by_class.get(k, 0.0) + _dev_us(e) / 1e3 / n_steps
    top = sorted(kern, key=_dev_us, reverse=True)[:15]
    return {
        "steps": n_steps,
        "wall_ms_per_step": wall * 1e3 / n_steps,
        "device_ms_per_step": dev_us / 1e3 / n_steps,
        "device_idle_share": 1.0 - dev_us / 1e6 / wall,
        "kernel_launches_per_step": sum(e.count for e in kern) / n_steps,
        "device_ms_per_step_by_class": by_class,
        "top_kernels": [{"name": e.key[:90], "calls_per_step":
                         e.count / n_steps,
                         "ms_per_step": _dev_us(e) / 1e3 / n_steps}
                        for e in top],
    }


class TrainerStep:
    """``loss.backward(); trainer.step(tokens)`` on the batch's summed
    loss (chip_smoke's moe phase), behind `TrainStep`'s ``dispatch``."""

    def __init__(self, layer, trainer, loss_fn, tokens):
        self.layer, self.trainer = layer, trainer
        self.loss_fn, self.tokens = loss_fn, tokens

    def dispatch(self, x, y):
        loss = self.loss_fn(self.layer(x), x, y)
        (loss * self.tokens).backward()
        self.trainer.step(self.tokens)
        return loss.detach()


class VisionStep:
    """One step of ``examples/gluon/image_classification.py``'s loop
    behind `TrainStep`'s ``dispatch``."""

    def __init__(self, net, trainer, loss_fn):
        self.net, self.trainer, self.loss_fn = net, trainer, loss_fn

    def dispatch(self, x, y):
        from mxnet_tpu_torch import autograd
        with autograd.record():
            loss = self.loss_fn(self.net(x), y)
        loss.backward()
        self.trainer.step(x.shape[0])
        return loss


def moe_step(dev, dtype, entry):
    """The MoE layer of chip_smoke's moe phase behind `entry`."""
    from chip_smoke import MOE_CF, MOE_E, MOE_H, MOE_I, moe_loss
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import MoEFeedForward, TrainStep
    layer = MoEFeedForward(MOE_H, MOE_I, num_experts=MOE_E,
                           capacity_factor=MOE_CF, dtype=dtype, device=dev,
                           seed=0)
    opt = Adam(learning_rate=1e-4)
    if entry == "step":
        return TrainStep(layer, opt, moe_loss, num_model_args=1)
    return TrainerStep(layer, Trainer(dict(layer.named_parameters()), opt),
                       moe_loss, 64 * 128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "train_profile.json"))
    ap.add_argument("--moe", action="store_true",
                    help="profile the Switch-MoE step instead of BERT's")
    ap.add_argument("--gpt", action="store_true",
                    help="profile the GPT-2-small step instead of BERT's")
    ap.add_argument("--gpt-gqa", action="store_true",
                    help="profile the gpt_gqa phase's step instead")
    ap.add_argument("--gpt-d256", action="store_true",
                    help="profile the gpt_d256 phase's step instead")
    ap.add_argument("--resnet50", action="store_true",
                    help="profile the vision phase's ResNet-50 step")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import (D256_ARCH, GQA_ARCH, bert_batch,
                            bert_train_step,
                            gpt_batch, gpt_train_step, moe_batch,
                            pallas_mode)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products

    dev = torch.device("cuda", 0)
    out = {"card": torch.cuda.get_device_name(0)}
    if args.moe:
        for dtype, entry in MOE_RUNS:
            key = f"moe_{dtype}_{entry}"
            batch = moe_batch(dev, dtype)
            with pallas_mode("auto"):
                step = moe_step(dev, dtype, entry)
                for _ in range(3):
                    step.dispatch(*batch)
                out[key] = res = profile_steps(step, batch, 5)
            print(f"[{key}] {json.dumps(res)}", flush=True)
            del step
            torch.cuda.empty_cache()
    if args.resnet50:
        from chip_smoke import VISION_LR, resnet50, vision_batches
        from mxnet_tpu_torch import gluon
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        x, y = vision_batches(dev, 1)[0]
        with pallas_mode("auto"):
            net = resnet50(dev)
            step = VisionStep(net, gluon.Trainer(
                net.collect_params(), "nag", dict(VISION_LR)),
                gluon.loss.SoftmaxCrossEntropyLoss())
            for _ in range(3):
                step.dispatch(x, y)
            out["resnet50_v1_float32_nag"] = res = profile_steps(
                step, (x, y), 5)
        print(f"[resnet50_v1_float32_nag] {json.dumps(res)}", flush=True)
        del step, net
        torch.cuda.empty_cache()
    gpt = args.gpt or args.gpt_gqa or args.gpt_d256
    tag, arch = (("_gqa", GQA_ARCH) if args.gpt_gqa else
                 ("_d256", D256_ARCH) if args.gpt_d256 else ("", None))
    for dtype in GPT_RUNS if gpt else ():
        key = f"gpt{tag}_{dtype}_step"
        batch = gpt_batch(dev, 50257)
        with pallas_mode("auto"):
            _, step = gpt_train_step(dev, dtype, arch=arch)
            step.warmup(*batch)
            for _ in range(3):
                step.dispatch(*batch)
            out[key] = res = profile_steps(step, batch, 5)
        print(f"[{key}] {json.dumps(res)}", flush=True)
        del step
        torch.cuda.empty_cache()
    batch = tuple(torch.from_numpy(a).to(dev) for a in bert_batch(30522))
    for dtype, opt, route in () if args.moe or gpt or args.resnet50 \
            else RUNS:
        key = f"{dtype}_{opt.lower()}_{route}"
        with pallas_mode(route):
            step = bert_train_step(dev, dtype, opt=opt, route=route)
            step.warmup(*batch)
            for _ in range(3):
                step.dispatch(*batch)
            res = profile_steps(step, batch, 5)
        out[key] = res
        print(f"[{key}] {json.dumps(res)}", flush=True)
        del step
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
