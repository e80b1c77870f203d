"""Port parity: the gluon `Trainer` (mxnet_tpu_torch.gluon.Trainer) against
the JAX package's ``gluon/trainer.py``.

Five steps of ``loss.backward(); trainer.step(batch_size)`` on a small
Dense model (16 -> 32 -> 8, ReLU) and on the MoE layer (H 16, I 32, E 4,
loss MSE + 0.01 aux), from the same weights (`load_jax_params`), for Adam,
AdamW, SGD with momentum and LAMB, on the kernel route
(``MXTPU_PALLAS=kernel``: JAX's Pallas kernels in the interpreter, the
port's CUDA kernels' plain versions) and the reference route.  Tolerance:
rtol 1e-5 / atol 1e-6 on the losses and on every parameter after the
steps (f32; products and LAMB's norms summed in another order).

Also: gradients are cleared after each step (torch accumulates where
MXNet's ``grad_req="write"`` overwrites); `set_learning_rate` mid-run;
per-name rate multipliers take the per-leaf route on both sides; a
`save_states` / `load_states` round trip continues bit for bit; each
option that is not ported raises `MXNetError`.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.parallel import MoEFeedForward as JMoE

from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.models.layers import Dense
from mxnet_tpu_torch.optimizer import Adam
from mxnet_tpu_torch.parallel import MoEFeedForward

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 4
OPTS = {"adam": ("adam", {"learning_rate": 1e-2}),
        "adamw": ("adamw", {"learning_rate": 1e-2, "wd": 0.01}),
        "sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
        "lamb": ("lamb", {"learning_rate": 1e-2, "wd": 0.01})}


class MLP(torch.nn.Module):
    """The port's twin of Gluon's ``HybridSequential(Dense(32, relu),
    Dense(8))`` under the same parameter names."""

    def __init__(self):
        super().__init__()
        self.add_module("0", Dense(16, 32))
        self.add_module("1", Dense(32, 8))

    def forward(self, x):
        return getattr(self, "1")(torch.relu(getattr(self, "0")(x)))


def _models(kind):
    mx.random.seed(7)
    if kind == "dense":
        jm = jnn.HybridSequential()
        jm.add(jnn.Dense(32, activation="relu", in_units=16),
               jnn.Dense(8, in_units=16 * 2))
        jm.initialize(mx.init.Normal(0.2))
        tm = MLP()
    else:
        jm = JMoE(16, 32, num_experts=4, capacity_factor=1.5)
        jm.initialize()
        tm = MoEFeedForward(16, 32, num_experts=4, capacity_factor=1.5,
                            device="cpu")
    load_jax_params(tm, {k: p.data().asnumpy()
                         for k, p in jm.collect_params().items()},
                    device="cpu")
    return jm, tm


def _data(kind, seed=3):
    rng = np.random.RandomState(seed)
    shape = (BATCH, 16) if kind == "dense" else (2, BATCH, 16)
    oshape = (BATCH, 8) if kind == "dense" else shape
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(oshape).astype(np.float32))


def _loss(out, y):
    if isinstance(out, tuple):
        o, aux = out
        return ((o - y) ** 2).mean() + 0.01 * aux
    return ((out - y) ** 2).mean()


def _jax_run(jm, opt, kw, x, y, steps, lr_at=None, mults=None):
    tr = jgluon.Trainer(jm.collect_params(), opt, dict(kw))
    if mults:
        tr.optimizer.set_lr_mult(mults)
    jx, jy = mx.np.array(x), mx.np.array(y)
    losses = []
    for i in range(steps):
        if lr_at is not None and i == lr_at[0]:
            tr.set_learning_rate(lr_at[1])
        with autograd.record():
            loss = _loss(jm(jx), jy)
        loss.backward()
        tr.step(BATCH)
        losses.append(float(loss.asnumpy()))
    return losses


def _port_run(tm, tr, x, y, steps, lr_at=None):
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for i in range(steps):
        if lr_at is not None and i == lr_at[0]:
            tr.set_learning_rate(lr_at[1])
            assert tr.learning_rate == lr_at[1]
        loss = _loss(tm(tx), ty)
        loss.backward()
        tr.step(BATCH)
        # cleared after the update: the next backward writes afresh
        assert all(p.grad is None for p in tm.parameters())
        losses.append(float(loss.detach()))
    return losses


def _assert_same(jm, tm, jl, tl):
    np.testing.assert_allclose(tl, jl, **TOL)
    jp = jm.collect_params()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[n].data().asnumpy(),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("route", ["kernel", "reference"])
@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_five_steps_match_jax_trainer(monkeypatch, kind, name, route):
    monkeypatch.setenv("MXTPU_PALLAS", route)
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    opt, kw = OPTS[name]
    jm, tm = _models(kind)
    x, y = _data(kind)
    lr_at = (3, kw["learning_rate"] * 0.5)
    jl = _jax_run(jm, opt, kw, x, y, 5, lr_at=lr_at)
    tr = Trainer(dict(tm.named_parameters()), opt, dict(kw))
    tl = _port_run(tm, tr, x, y, 5, lr_at=lr_at)
    _assert_same(jm, tm, jl, tl)
    assert tl[-1] < tl[0]
    assert tr.optimizer.num_update == 5


def test_rate_multipliers_take_the_per_leaf_route(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "kernel")
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    jm, tm = _models("dense")
    x, y = _data("dense")
    mults = {"0.weight": 0.5, "1.bias": 2.0}
    jl = _jax_run(jm, "adam", {"learning_rate": 1e-2}, x, y, 3, mults=mults)
    tr = Trainer(dict(tm.named_parameters()), "adam",
                 {"learning_rate": 1e-2})
    tr.optimizer.set_lr_mult(mults)
    assert not tr._uniform_mults()
    tl = _port_run(tm, tr, x, y, 3)
    _assert_same(jm, tm, jl, tl)
    assert tr.optimizer._index_update_count["0.weight"] == 3


def test_save_and_load_states_continue_bit_for_bit(tmp_path):
    x, y = _data("moe")
    _, ref = _models("moe")
    tr = Trainer(dict(ref.named_parameters()), "adam",
                 {"learning_rate": 1e-2})
    full = _port_run(ref, tr, x, y, 5)
    _, a = _models("moe")
    ta = Trainer(dict(a.named_parameters()), "adam", {"learning_rate": 1e-2})
    first = _port_run(a, ta, x, y, 3)
    ta.save_states(str(tmp_path / "t.states"))
    b = MoEFeedForward(16, 32, num_experts=4, capacity_factor=1.5,
                       device="cpu")
    b.load_state_dict(a.state_dict())
    tb = Trainer(dict(b.named_parameters()), "adam", {"learning_rate": 1e-2})
    tb.load_states(str(tmp_path / "t.states"))
    assert tb.optimizer.num_update == 3
    rest = _port_run(b, tb, x, y, 2)
    assert first + rest == full
    for (n, p), q in zip(ref.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


def test_state_in_the_weights_dtype_and_unreached_parameters():
    """bf16 weights keep bf16 moments (``multi_precision=False``); a
    parameter the loss never reaches is stepped with a zero gradient, as
    JAX's zero-initialised gradient buffer is."""
    m = MLP().bfloat16()
    extra = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    params = dict(m.named_parameters(), extra=extra)
    tr = Trainer(params, "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 0.5})
    m(torch.ones(2, 16, dtype=torch.bfloat16)).sum().backward()
    tr.step(2)
    assert all(s.dtype == torch.bfloat16 for st in tr._states.values()
               for s in st)
    # wd * w is the whole gradient: mom = -0.1 * 0.5, w = 1 - 0.05
    assert torch.equal(extra.detach(),
                       torch.full((3,), 0.95).bfloat16())


def test_unported_options_raise():
    m = MLP()
    params = dict(m.named_parameters())
    for kw in ({"kvstore": "device"}, {"update_on_kvstore": True},
               {"compression_params": {"type": "2bit"}}):
        with pytest.raises(MXNetError, match="ROADMAP"):
            Trainer(params, "adam", {}, **kw)
    with pytest.raises(MXNetError, match="ROADMAP"):
        Trainer(params, "adam", {"multi_precision": True})
    assert Trainer(params, "adam", {}, kvstore=None).allreduce_grads() is None
    tr = Trainer(params, Adam(learning_rate=0.1))
    tr._amp_loss_scaler = object()
    with pytest.raises(MXNetError, match="ROADMAP"):
        tr.step(1)
    tr = Trainer(params, "adam", {})
    w0 = m.get_submodule("0").weight
    w0.grad = torch.zeros_like(w0).to_sparse()
    with pytest.raises(MXNetError, match="sparse"):
        tr.step(1)
    with pytest.raises(MXNetError, match="Parameter"):
        Trainer([torch.ones(2)], "adam", {})
    with pytest.raises(MXNetError, match="dict or a list"):
        Trainer(m, "adam", {})
