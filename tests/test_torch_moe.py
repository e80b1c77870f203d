"""Port parity: the Switch MoE layer (mxnet_tpu_torch.parallel.moe) against
the JAX package's ``parallel/moe.py``.

`switch_moe`'s output, aux loss and every gradient (x, router, expert_up,
expert_down) are held against JAX's at JAX's test size (B 2, L 8, H 16,
I 32, E 4) with capacity factor 4.0 (no drop) and 0.25 (most tokens
drop), with GELU (tanh form on both sides) and ReLU, on each route with
the same ``MXTPU_PALLAS`` on both sides: ``auto`` (the reference scatter
and gather on the CPU), ``kernel`` (the row gather: JAX's Pallas kernel in
the interpreter, the port's plain version of the CUDA kernel) and ``off``
(the dense one-hot einsums).  Tolerance: rtol 1e-4, atol 1e-5 — f32
products and reductions summed in another order, GELU's tanh rounded
apart; a token routed to another expert or slot would land far outside.

`MoEFeedForward` is loaded from a JAX layer through `load_jax_params` and
trained five steps by `TrainStep` against JAX's `make_sharded_train_step`
on a one-device mesh: losses and parameters within rtol/atol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import MoEFeedForward as JMoE
from mxnet_tpu.parallel import make_mesh, make_sharded_train_step
from mxnet_tpu.parallel import switch_moe as jswitch

from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.optimizer import Adam
from mxnet_tpu_torch.parallel import MoEFeedForward, TrainStep, switch_moe

torch.set_num_threads(1)

B, L, H, I, E = 2, 8, 16, 32, 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, L, H)).astype(np.float32),
            rng.standard_normal((E, H)).astype(np.float32),
            (rng.standard_normal((E, I, H)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, H, I)) * 0.1).astype(np.float32),
            rng.standard_normal((B, L, H)).astype(np.float32))


@pytest.mark.parametrize("mode", ["auto", "kernel", "off"])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_switch_moe_and_gradients_match_jax(monkeypatch, mode, activation,
                                            cf):
    monkeypatch.setenv("MXTPU_PALLAS", mode)
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    x, rw, wu, wd, cot = _weights(seed=1)

    def f_jax(xv, a, b, c):
        out, aux = jswitch(xv, a, b, c, capacity_factor=cf,
                           activation=activation)
        return jnp.sum(out * cot) + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(
        f_jax, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, rw, wu, wd)))
    tw = [torch.from_numpy(a).requires_grad_() for a in (x, rw, wu, wd)]
    out, aux = switch_moe(*tw, capacity_factor=cf, activation=activation)
    (torch.sum(out * torch.from_numpy(cot)) + 3.0 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    for name, t, j in zip(("x", "router", "expert_up", "expert_down"), tw,
                          jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL,
                                   err_msg=name)
    rows = np.abs(out.detach().numpy().reshape(-1, H)).sum(-1)
    if cf < 1:       # capacity 1 an expert: at most E tokens kept
        assert (rows == 0).sum() >= B * L - E and (rows == 0).sum() < B * L
    else:
        assert (rows > 0).all()


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_dense_route_equals_blockwise_route(monkeypatch, cf):
    """``MXTPU_PALLAS=off`` (dense einsums) and the blockwise routes give
    the same layer output, overflow included (atol 1e-5: the einsum sums
    zero products in another order)."""
    rng = np.random.RandomState(18)
    b, l, h, i, e = 2, 16, 32, 48, 4
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(b, l, h), rng.randn(e, h), 0.1 * rng.randn(e, i, h),
        0.1 * rng.randn(e, h, i))]
    outs = {}
    for mode in ("off", "reference", "kernel"):
        monkeypatch.setenv("MXTPU_PALLAS", mode)
        outs[mode], _ = switch_moe(*args, capacity_factor=cf)
    for mode in ("reference", "kernel"):
        np.testing.assert_allclose(outs[mode].numpy(), outs["off"].numpy(),
                                   rtol=0, atol=1e-5)
    assert (outs["kernel"].reshape(-1, h).abs().sum(-1) == 0).any()


def _jax_layer(cf=2.0):
    mx.random.seed(3)
    layer = JMoE(H, I, num_experts=E, capacity_factor=cf)
    layer.initialize()
    return layer


def _port_layer(jlayer, cf=2.0):
    layer = MoEFeedForward(H, I, num_experts=E, capacity_factor=cf,
                           device="cpu")
    return load_jax_params(layer, {k: p.data().asnumpy() for k, p in
                                   jlayer.collect_params().items()},
                           device="cpu")


def test_layer_loads_jax_params_and_initialises_like_jax():
    jl = _jax_layer()
    tl = _port_layer(jl)
    assert sorted(dict(tl.named_parameters())) == \
        sorted(jl.collect_params())
    x = _weights()[0]
    jout, jaux = jl(mx.np.array(x))
    tout, taux = tl(torch.from_numpy(x))
    np.testing.assert_allclose(tout.detach().numpy(), jout.asnumpy(), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux.asnumpy()), **TOL)
    # the port's own init: JAX's Uniform(0.07), from the seed
    a = MoEFeedForward(H, I, E, device="cpu", seed=5)
    b = MoEFeedForward(H, I, E, device="cpu", seed=5)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        assert float(p.abs().max()) <= 0.07 and float(p.std()) > 0.03, n
    with pytest.raises(MXNetError, match="num_experts >= 2"):
        MoEFeedForward(H, I, 1, device="cpu")
    assert MoEFeedForward(H, I, E, dtype="bfloat16",
                          device="cpu").expert_up.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_train_step_matches_jax_sharded_step(monkeypatch, mode):
    """Five steps of loss = MSE + 0.01 aux through `TrainStep` against
    JAX's `make_sharded_train_step` at dp=1, Adam lr 5e-3."""
    monkeypatch.setenv("MXTPU_PALLAS", mode)
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(3)
    x = rng.standard_normal((4, L, H)).astype(np.float32)
    y = rng.standard_normal((4, L, H)).astype(np.float32)
    jl = _jax_layer()
    jl(mx.np.array(x))
    tl = _port_layer(jl)

    def jloss(out, xx, yy):
        o, aux = out
        return jnp.mean((o - yy) ** 2) + 0.01 * aux

    def tloss(out, xx, yy):
        o, aux = out
        return torch.mean((o - yy) ** 2) + 0.01 * aux

    mesh = make_mesh({"dp": 1}, jax.devices()[:1])
    jstep = make_sharded_train_step(jl, jopt.Adam(learning_rate=5e-3), jloss,
                                    mesh, num_model_args=1)
    tstep = TrainStep(tl, Adam(learning_rate=5e-3), tloss, num_model_args=1)
    assert tstep._fused_opt_kernel == (mode == "kernel")
    jx, jy = mx.np.array(x), mx.np.array(y)
    jl_, tl_ = [], []
    for _ in range(5):
        jl_.append(float(jstep(jx, jy)))
        tl_.append(float(tstep(x, y)))
    np.testing.assert_allclose(tl_, jl_, rtol=1e-4, atol=1e-4)
    assert tl_[-1] < tl_[0]
    jstep.sync_params_to_block()
    assert jstep._fused_opt_kernel == tstep._fused_opt_kernel
    jp = jl.collect_params()
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[n].data().asnumpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=n)
