"""Port parity: ``examples/gpt_generation.py``'s own ``mx.np`` code runs
unchanged on `mxnet_tpu_torch`.

The example module is loaded by path (it imports neither ``jax`` nor
``mxnet_tpu`` at its top) and its ``synthetic_batch`` and ``train(model,
mx, gluon, autograd, ...)`` run as written: once with the JAX package,
once with the port under ``with mx.cpu():``, on the example's classic
configuration for 3 steps, from the same seeded weights (``load_dict`` in
the JAX package, `load_jax_params` in the port).  Each step's loss (read
where the example reads it, ``float(loss.asnumpy())``) agrees within 1e-5.
"""
import builtins
import importlib.util
import os

import numpy as np
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models import gpt as jgpt
import mxnet_tpu_torch as tm
from mxnet_tpu_torch.models import gpt as tgpt

torch.set_num_threads(1)

_EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "gpt_generation.py")
V, SEQ, STEPS = 64, 24, 3
CLASSIC = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position=64, dropout=0.0)


def _example():
    spec = importlib.util.spec_from_file_location("gpt_generation_np",
                                                  _EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train(ex, model, pkg, gluon, autograd):
    """The example's ``train`` as written; every loss it reads through
    ``float(...)`` is kept."""
    seen = []

    def recording_float(v):
        seen.append(builtins.float(v))
        return seen[-1]

    ex.float = recording_float
    try:
        last = ex.train(model, pkg, gluon, autograd, STEPS,
                        np.random.RandomState(0), V, SEQ)
    finally:
        del ex.float
    assert seen and seen[-1] == last
    return seen


def test_example_module_imports_neither_jax_nor_the_jax_package():
    import re
    with open(_EXAMPLE) as f:
        head = f.read().split("\ndef ", 1)[0]
    assert not re.search(r"^\s*(import|from)\s+(jax|mxnet_tpu)\b", head,
                         re.M)


def _weights(model, rng):
    """Seeded weights for `model`'s parameters, by name: N(0, 0.04)
    matrices, unit norm scales, zero shifts and biases."""
    def one(name, shape):
        if name.endswith("gamma"):
            return np.ones(shape, np.float32)
        if name.endswith(("beta", "bias")):
            return np.zeros(shape, np.float32)
        return (0.04 * rng.standard_normal(shape)).astype(np.float32)
    return {k: one(k, p.shape) for k, p in model.collect_params().items()}


def test_gpt_generation_train_runs_unchanged_on_the_port():
    ex = _example()
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**CLASSIC))
    weights = _weights(jm, np.random.RandomState(4))
    jm.load_dict({k: mx.np.array(v) for k, v in weights.items()})
    with tm.cpu():
        tmodel = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CLASSIC),
                                     device="cpu")
        tm.load_jax_params(tmodel, weights, device="cpu")
        got = _train(ex, tmodel, tm, tm.gluon, tm.autograd)
    want = _train(ex, jm, mx, jgluon, jag)
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[-1] < got[0]
