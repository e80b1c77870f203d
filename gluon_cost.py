#!/usr/bin/env python3
"""Host cost of the models' Gluon blocks, this tree against another, on
the card.

    python3 gluon_cost.py --other <checkout> [--turns 2]
                          [--out chiprun_out/gluon_cost.json]

Times three host-bound steps of the PyTorch port at full width, each in a
fresh process per tree, in turns (this, other, other, this for two
turns): the gpt phase's bf16 `TrainStep` (GPT-2 small, 8 x 1024 tokens,
dropout 0.1, AdamW; `chip_smoke.gpt_train_step`), the train phase's bf16
Adam `TrainStep` (BERT-base, ``bench.py``'s 64 x 128 batch;
`chip_smoke.bert_train_step`) and an f32 serving decode step (GPT-2
small, ``ServeConfig(max_slots=8, max_len=512, page_size=16,
prefill_chunk=16)``, 8 slots decoding after 128-token prompts).  Each
tree's own ``chip_smoke.py`` builds its step, so each side runs its own
models.  A measurement is the wall time a step over `WINDOW` steps after
warmup (the device synchronised at both ends), taken `REPEATS` times in
the process; the per-tree spread is over every window of every turn.  A
tree with the ``mx.np`` front end also times the array facade: the
gluon_gpt phase's bf16 `Trainer` step (GPT-2 small, 8 x 1024, dropout
0.1, Adam through ``Trainer(collect_params())``, ``loss.backward()``) fed
``mx.np`` arrays against the same step fed raw tensors, in turns in one
process (raw, arrays, arrays, raw, `REPEATS` times).
Prints every window and a summary line per measurement.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW, REPEATS = 10, 3
SERVE_SC = dict(max_slots=8, max_len=512, page_size=16, prefill_chunk=16)


def _window(fn, sync):
    """Wall time a call over `WINDOW` calls of `fn`, ms."""
    sync()
    t0 = time.perf_counter()
    for _ in range(WINDOW):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / WINDOW


def _windows(fn, sync):
    """`REPEATS` wall times a call over `WINDOW` calls of `fn`, ms."""
    return [_window(fn, sync) for _ in range(REPEATS)]


def worker(path):
    """Measure the tree at `path` (its ``mxnet_tpu_torch`` and
    ``chip_smoke.py``); prints one JSON line."""
    sys.path.insert(0, path)
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig
    assert os.path.dirname(os.path.abspath(cs.__file__)) == path
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()
    sync = torch.cuda.synchronize
    res = {"path": path, "card": cs.card_line()}

    _, step = cs.gpt_train_step(dev, "bfloat16")
    batch = cs.gpt_batch(dev, 50257)
    with cs.pallas_mode("auto"):
        step.warmup(*batch)
        for _ in range(3):
            step.dispatch(*batch)
        res["gpt_bf16_step_ms"] = _windows(lambda: step.dispatch(*batch),
                                           sync)
    del step
    torch.cuda.empty_cache()

    step = cs.bert_train_step(dev, "bfloat16")
    bb = tuple(torch.from_numpy(a).to(dev) for a in cs.bert_batch(30522))
    with cs.pallas_mode("auto"):
        step.warmup(*bb)
        for _ in range(3):
            step.dispatch(*bb)
        res["bert_bf16_adam_step_ms"] = _windows(lambda: step.dispatch(*bb),
                                                 sync)
    del step
    torch.cuda.empty_cache()

    model = GPTForCausalLM(gpt_small(), device=dev, seed=0)
    eng = InferenceEngine(model, ServeConfig(**SERVE_SC), device=dev)
    eng.warmup()
    for p in cs.make_prompts(50257, n=8, lo=128, hi=128):
        eng.submit(p, max_new_tokens=200)
    for _ in range(20):        # past every prefill chunk: decode only
        eng.step()
    res["serve_f32_decode_step_ms"] = _windows(eng.step, sync)
    del eng, model
    torch.cuda.empty_cache()
    import mxnet_tpu_torch
    if hasattr(mxnet_tpu_torch, "np"):
        res.update(facade(cs, dev, sync))
    print("GLUON_COST " + json.dumps(res), flush=True)


def facade(cs, dev, sync):
    """The gluon_gpt bf16 `Trainer` step fed arrays against raw tensors,
    in turns: ``{"facade_raw_step_ms": [...], "facade_array_step_ms":
    [...]}``."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small
    mx.random.seed(0)
    model = GPTForCausalLM(gpt_small(dropout=0.1, dtype="bfloat16"))
    model.initialize()
    V = model.cfg.vocab_size
    trainer = gluon.Trainer(model.collect_params(), "adam",
                            {"learning_rate": 1e-4})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    ids_np = cs.grammar_batch(np.random.RandomState(2), 8, 1024, V)
    feeds = {"raw": torch.from_numpy(ids_np).to(dev),
             "array": mx.np.array(ids_np)}

    def step(ids):
        with autograd.record():
            logits = model(ids)
            loss = loss_fn(logits[:, :-1].reshape(-1, V),
                           ids[:, 1:].reshape(-1)).mean()
        loss.backward()
        trainer.step(1)

    with cs.pallas_mode("auto"):
        for key in ("raw", "array"):
            for _ in range(3):
                step(feeds[key])
        out = {"facade_raw_step_ms": [], "facade_array_step_ms": []}
        for _ in range(REPEATS):
            for key in ("raw", "array", "array", "raw"):
                out[f"facade_{key}_step_ms"].append(
                    _window(lambda k=key: step(feeds[k]), sync))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=False, default=None,
                    help="the checkout to compare with (e.g. the parent)")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "gluon_cost.json"))
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(os.path.abspath(args.worker))
        return 0
    trees = {"this": HERE}
    if args.other:
        trees["other"] = os.path.abspath(args.other)
    order = []
    for t in range(args.turns):
        names = list(trees)
        order += names if t % 2 == 0 else names[::-1]
    runs = []
    for name in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", trees[name]],
                             capture_output=True, text=True, timeout=1200)
        line = next((x for x in out.stdout.splitlines()
                     if x.startswith("GLUON_COST ")), None)
        if out.returncode or line is None:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        r = dict(json.loads(line[len("GLUON_COST "):]), tree=name)
        runs.append(r)
        print(json.dumps(r), flush=True)
    summary = {}
    for key in ("gpt_bf16_step_ms", "bert_bf16_adam_step_ms",
                "serve_f32_decode_step_ms", "facade_raw_step_ms",
                "facade_array_step_ms"):
        for name in trees:
            xs = [x for r in runs if r["tree"] == name for x in r.get(key, [])]
            if not xs:
                continue
            summary[f"{key}:{name}"] = dict(
                mean=sum(xs) / len(xs), min=min(xs), max=max(xs))
    print("SUMMARY " + json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
