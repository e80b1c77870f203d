"""Port parity: the gluon `Trainer` (mxnet_tpu_torch.gluon.Trainer) against
the JAX package's ``gluon/trainer.py``.

Five steps of ``loss.backward(); trainer.step(batch_size)`` on a small
Dense model (16 -> 32 -> 8, ReLU) and on the MoE layer (H 16, I 32, E 4,
loss MSE + 0.01 aux), from the same weights (`load_jax_params`), for Adam,
AdamW, SGD with momentum, LAMB, NAG, AdaBelief, FTML, Nadam (per
parameter: not fused-safe) and LARS (per leaf), and NAG under a cosine
schedule with linear warmup, on the kernel route
(``MXTPU_PALLAS=kernel``: JAX's Pallas kernels in the interpreter, the
port's CUDA kernels' plain versions) and the reference route.  Tolerance:
rtol 1e-5 / atol 1e-6 on the losses and on every parameter after the
steps (f32; products and LAMB's norms summed in another order).

Also: gradients are cleared after each step (torch accumulates where
MXNet's ``grad_req="write"`` overwrites); `set_learning_rate` mid-run;
per-name rate multipliers take the per-leaf route on both sides; a
`save_states` / `load_states` round trip continues bit for bit; a JAX
run's optimizer state (FTML's three slots, DCASGD's momentum and previous
weight, the empty state of Signum and LARS without momentum) continues in
the port (`load_jax_optimizer_states`); each option that is not ported
raises `MXNetError`.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.optimizer import lr_scheduler as jsched
from mxnet_tpu.parallel import MoEFeedForward as JMoE

from mxnet_tpu_torch import load_jax_optimizer_states, load_jax_params
from mxnet_tpu_torch.amp import LossScaler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.optimizer import Adam
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched
from mxnet_tpu_torch.parallel import MoEFeedForward

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 4
OPTS = {"adam": ("adam", {"learning_rate": 1e-2}),
        "adamw": ("adamw", {"learning_rate": 1e-2, "wd": 0.01}),
        "sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
        "lamb": ("lamb", {"learning_rate": 1e-2, "wd": 0.01}),
        "nag": ("nag", {"learning_rate": 0.05, "momentum": 0.9,
                        "wd": 1e-3}),
        "adabelief": ("adabelief", {"learning_rate": 1e-2}),
        "ftml": ("ftml", {"learning_rate": 1e-2, "wd": 1e-3}),
        # epsilon 1e-6: an expert's near-zero gradients would turn round-off
        # into steps under Nadam's 1e-8 (as under Adam's, test_torch_train)
        "nadam": ("nadam", {"learning_rate": 1e-2, "epsilon": 1e-6}),
        "lars": ("lars", {"learning_rate": 1.0, "momentum": 0.9,
                          "wd": 1e-3}),
        "nag_cosine": ("nag", {"learning_rate": 0.05, "momentum": 0.9})}
# per-case learning-rate schedulers, built afresh for each package
SCHEDS = {"nag_cosine": ("CosineScheduler", dict(
    max_update=6, base_lr=0.05, final_lr=0.005, warmup_steps=2,
    warmup_begin_lr=0.01))}


def _kw(name, sched_module):
    """The case's optimizer parameters, with its scheduler from
    `sched_module` (JAX's or the port's)."""
    opt, kw = OPTS[name]
    kw = dict(kw)
    if name in SCHEDS:
        cls, skw = SCHEDS[name]
        kw["lr_scheduler"] = getattr(sched_module, cls)(**skw)
    return opt, kw


class MLP(torch.nn.Module):
    """The port's twin of Gluon's ``HybridSequential(Dense(32, relu),
    Dense(8))`` under the same parameter names."""

    def __init__(self):
        super().__init__()
        self.add_module("0", tnn.Dense(32, in_units=16, flatten=False))
        self.add_module("1", tnn.Dense(8, in_units=32, flatten=False))
        for layer in self.children():
            layer.initialize(device="cpu")

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
    opt, kw = _kw(name, jsched)
    jm, tm = _models(kind)
    x, y = _data(kind)
    # a scheduler owns the rate: `set_learning_rate` would change nothing
    lr_at = None if name in SCHEDS else (3, kw["learning_rate"] * 0.5)
    jl = _jax_run(jm, opt, kw, x, y, 5, lr_at=lr_at)
    _, tkw = _kw(name, tsched)
    tr = Trainer(dict(tm.named_parameters()), opt, tkw)
    tl = _port_run(tm, tr, x, y, 5, lr_at=lr_at)
    _assert_same(jm, tm, jl, tl)
    assert tl[-1] < tl[0]
    assert tr.optimizer.num_update == 5
    if name in SCHEDS:
        # step k ran at the scheduler's rate for update count k
        assert tr.learning_rate == tkw["lr_scheduler"](5) == \
            kw["lr_scheduler"](5)


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


JAX_STATE_CASES = {
    "ftml": ("ftml", {"learning_rate": 1e-2}),
    "dcasgd": ("dcasgd", {"learning_rate": 0.05}),
    "signum": ("signum", {"learning_rate": 1e-2, "momentum": 0.0}),
    "lars": ("lars", {"learning_rate": 1.0})}


@pytest.mark.parametrize("name", sorted(JAX_STATE_CASES))
def test_a_jax_run_continues_in_the_port(name):
    """Three steps in JAX, then the weights (`load_jax_params`) and the
    optimizer state and counts (`load_jax_optimizer_states`) go to the
    port, which takes two more steps: losses and weights equal JAX's own
    five-step run."""
    opt, kw = JAX_STATE_CASES[name]
    jm, tm = _models("dense")
    x, y = _data("dense")
    tr_j = jgluon.Trainer(jm.collect_params(), opt, dict(kw))
    # DCASGD's state holds the weight itself, which JAX's whole-tree update
    # (donating both) refuses: a rate multiplier sends JAX's `Trainer`
    # through its per-parameter route, and the port's with it
    mults = {"0.weight": 1.0} if name == "dcasgd" else {}
    tr_j.optimizer.set_lr_mult(mults)
    jx, jy = mx.np.array(x), mx.np.array(y)
    jl = []
    for i in range(5):
        if i == 3:
            w3 = {k: p.data().asnumpy()
                  for k, p in jm.collect_params().items()}
            s3 = {k: tuple(s.asnumpy() for s in (st or ()))
                  for k, st in tr_j._states.items()}
            n3 = (tr_j.optimizer.num_update,
                  dict(tr_j.optimizer._index_update_count))
        with autograd.record():
            loss = _loss(jm(jx), jy)
        loss.backward()
        tr_j.step(BATCH)
        jl.append(float(loss.asnumpy()))
    load_jax_params(tm, w3, device="cpu")
    tr = Trainer(dict(tm.named_parameters()), opt, dict(kw))
    tr.optimizer.set_lr_mult(mults)
    load_jax_optimizer_states(tr, s3, n3[0], n3[1])
    if name == "ftml":
        assert all(len(st) == 3 for st in tr._states.values())
    if name == "dcasgd":       # JAX made the 0-d momentum the weight's shape
        own = dict(tm.named_parameters())
        assert all(st[0].shape == own[n].shape
                   for n, st in tr._states.items())
    if name in ("signum", "lars"):
        assert all(st == () for st in tr._states.values())
    tl = _port_run(tm, tr, x, y, 2)
    assert tr.optimizer.num_update == 5
    _assert_same(jm, tm, jl[3:], tl)


def test_jax_optimizer_states_are_checked():
    _, tm = _models("dense")
    tr = Trainer(dict(tm.named_parameters()), "ftml", {})
    good = {n: tuple(np.zeros(p.shape, np.float32) for _ in range(3))
            for n, p in tm.named_parameters()}
    with pytest.raises(MXNetError, match="missing"):
        load_jax_optimizer_states(tr, dict(list(good.items())[1:]), 1)
    bad = dict(good, **{"0.bias": good["0.bias"][:2]})
    with pytest.raises(MXNetError, match="keeps 3"):
        load_jax_optimizer_states(tr, bad, 1)
    bad = dict(good, **{"0.bias": (np.zeros(3, np.float32),) * 3})
    with pytest.raises(MXNetError, match="state 0"):
        load_jax_optimizer_states(tr, bad, 1)
    assert tr._states == {}
    load_jax_optimizer_states(tr, good, 4)
    assert tr.optimizer.num_update == 4
    assert tr.optimizer._index_update_count["1.weight"] == 4


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
    # multi_precision and AMP's loss scaler are ported: both construct and
    # step (tests/test_torch_amp.py holds them to JAX)
    assert Trainer(params, "adam", {"multi_precision": True}) \
        .optimizer.multi_precision
    assert Trainer(params, "adam", {}, kvstore=None).allreduce_grads() is None
    tr = Trainer(params, Adam(learning_rate=0.1))
    tr._amp_loss_scaler = LossScaler(init_scale=4.0)
    for p in params.values():
        p.grad = torch.ones_like(p)
    tr.step(1)
    assert tr._amp_loss_scaler.loss_scale == 4.0
    tr = Trainer(params, "adam", {})
    w0 = m.get_submodule("0").weight.data()
    w0.grad = torch.zeros_like(w0).to_sparse()
    with pytest.raises(MXNetError, match="sparse"):
        tr.step(1)
    with pytest.raises(MXNetError, match="Parameter"):
        Trainer([torch.ones(2)], "adam", {})
    with pytest.raises(MXNetError, match="dict or a list"):
        Trainer(m, "adam", {})
