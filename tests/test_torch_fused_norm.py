"""Port parity: the fused LayerNorm / RMSNorm (mxnet_tpu_torch.ops.fused_norm)
against the JAX package's ``ops/pallas/fused_norm.py``.

The port's kernel route (``MXTPU_PALLAS=kernel``: on the CPU, the CUDA
kernel's plain version) is held against JAX's kernel route run in the
Pallas interpreter (``use_kernel=True`` under ``MXTPU_PALLAS_INTERPRET=1``),
at the JAX kernel test's shapes; the reference routes against each other.
Tolerances: atol 1e-5 in f32 and 3e-2 in bf16 on the outputs (the JAX
kernel test's own, ``tests/unittest/test_pallas_kernels.py``; bf16 outputs
of magnitude up to 4 round in steps of 1/64), 1e-4 on the gradients (f32
summation order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import numpy_extension as npx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops.pallas import fused_norm as jfn

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.layers import LayerNorm, RMSNorm
from mxnet_tpu_torch.ops import fused_norm as tfn
from mxnet_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

SHAPES = [(5, 37), (9, 200), (64, 256)]
ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "kernel")
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _inputs(rows, h, dtype, pdtype=None, seed=1):
    """x, residual, gamma, beta as numpy f32 (the values both sides get)."""
    rng = np.random.RandomState(seed)
    x, res = rng.randn(rows, h), rng.randn(rows, h)
    g, b = rng.rand(h) + 0.5, rng.randn(h)
    arrs = [a.astype(np.float32) for a in (x, res, g, b)]
    pdtype = pdtype or dtype
    return arrs, (dtype, dtype, pdtype, pdtype)


def _both(arrs, dtypes):
    j = [jnp.asarray(a, getattr(jnp, d)) for a, d in zip(arrs, dtypes)]
    t = [torch.from_numpy(a).to(getattr(torch, d)) for a, d in zip(arrs,
                                                                    dtypes)]
    return j, t


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().detach().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("rows,h", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_route_matches_jax_kernel(kernel_route, rows, h, dtype):
    arrs, dts = _inputs(rows, h, dtype)
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _both(arrs, dts)
    atol = ATOL[dtype]
    pairs = [
        (tfn.fused_layer_norm(tx, tg, tb),
         jfn.fused_layer_norm(jx, jg, jb, use_kernel=True)),
        (tfn.fused_rms_norm(tx, tg),
         jfn.fused_rms_norm(jx, jg, use_kernel=True))]
    for tout, jout in ((tfn.layer_norm_residual(tx, tr, tg, tb),
                        jfn.layer_norm_residual(jx, jr, jg, jb,
                                                use_kernel=True)),
                       (tfn.rms_norm_residual(tx, tr, tg),
                        jfn.rms_norm_residual(jx, jr, jg, use_kernel=True))):
        pairs += list(zip(tout, jout))
    for t, j in pairs:
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        _close(t, j, atol)


@pytest.mark.parametrize("rows,h", SHAPES)
def test_reference_route_matches_jax_reference(rows, h):
    """f32 only: in bf16 this route rounds its statistics to bf16 at
    places that differ between the two frameworks."""
    arrs, dts = _inputs(rows, h, "float32", seed=2)
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _both(arrs, dts)
    atol = ATOL["float32"]
    _close(tfn.fused_layer_norm(tx, tg, tb, use_kernel=False),
           jfn.layer_norm_reference(jx, jg, jb), atol)
    _close(tfn.fused_rms_norm(tx, tg, use_kernel=False),
           jfn.rms_norm_reference(jx, jg), atol)
    for t, j in zip(tfn.layer_norm_residual(tx, tr, tg, tb,
                                            use_kernel=False),
                    jfn.layer_norm_reference(jx, jg, jb, residual=jr)):
        _close(t, j, atol)


def test_output_dtypes_follow_the_route(monkeypatch):
    """bf16 x with f32 gamma and beta: x's dtype on the kernel route, the
    promoted f32 on the reference route — on both sides."""
    arrs, dts = _inputs(4, 32, "bfloat16", pdtype="float32")
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _both(arrs, dts)
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    for mode, want in (("kernel", "bfloat16"), ("reference", "float32")):
        monkeypatch.setenv("MXTPU_PALLAS", mode)
        j = jfn.fused_layer_norm(jx, jg, jb)
        t = tfn.fused_layer_norm(tx, tg, tb)
        assert str(j.dtype) == want
        assert t.dtype == getattr(torch, want)
        assert tnn.layer_norm(tx, tg, tb).dtype == getattr(torch, want)
        assert tnn.rms_norm(tx, tg).dtype == getattr(torch, want)
        _close(t, j, ATOL["bfloat16"])


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_gradients_match_jax_kernel_route(kernel_route, rms, residual):
    arrs, _ = _inputs(6, 40, "float32", seed=5)
    x, res, g, b = arrs
    b = 0.1 * b

    def jloss(xv, rv, gv, bv):
        if residual:
            y, s = (jfn.rms_norm_residual(xv, rv, gv, use_kernel=True) if rms
                    else jfn.layer_norm_residual(xv, rv, gv, bv,
                                                 use_kernel=True))
            return jnp.sum(y ** 2) + jnp.sum(s * 0.3)
        y = (jfn.fused_rms_norm(xv, gv, use_kernel=True) if rms
             else jfn.fused_layer_norm(xv, gv, bv, use_kernel=True))
        return jnp.sum(y ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                      (x, res, g, b)))
    tx, tr, tg, tb = (torch.from_numpy(a).requires_grad_()
                      for a in (x, res, g, b))
    if residual:
        y, s = (tfn.rms_norm_residual(tx, tr, tg) if rms
                else tfn.layer_norm_residual(tx, tr, tg, tb))
        loss = (y ** 2).sum() + (s * 0.3).sum()
    else:
        y = tfn.fused_rms_norm(tx, tg) if rms else \
            tfn.fused_layer_norm(tx, tg, tb)
        loss = (y ** 2).sum()
    loss.backward()
    for t, j in zip((tx, tr, tg, tb), want):
        got = np.zeros_like(np.asarray(j)) if t.grad is None else \
            t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(j), atol=1e-4, rtol=0)


def test_residual_variant_takes_a_cotangent_on_one_output(kernel_route):
    """Only y (or only s) reaching the loss: the other cotangent is None."""
    arrs, _ = _inputs(3, 16, "float32", seed=6)
    x, res, g, b = (torch.from_numpy(a).requires_grad_() for a in arrs)
    y, s = tfn.layer_norm_residual(x, res, g, b)
    y.sum().backward()
    assert torch.equal(x.grad, res.grad)
    x.grad = None
    y, s = tfn.layer_norm_residual(x, res, g, b)
    s.sum().backward()
    assert torch.allclose(x.grad, torch.ones_like(x))


def test_nn_entry_points_and_rmsnorm_match_npx():
    arrs, _ = _inputs(24, 32, "float32", seed=8)
    x, res, g, b = (a.reshape(4, 6, 32) if a.size == 768 else a
                    for a in arrs)
    jx, jr, jg, jb = map(jnp.asarray, (x, res, g, b))
    tx, tr, tg, tb = map(torch.from_numpy, (x, res, g, b))
    for t, j in zip(tnn.layer_norm_residual(tx, tr, tg, tb),
                    npx.layer_norm_residual(jx, jr, jg, jb)):
        _close(t, np.asarray(j), 1e-5)
    _close(tnn.rms_norm(tx, tg), npx.rms_norm(jx, jg), 1e-5)
    for t, j in zip(tnn.rms_norm_residual(tx, tr, tg),
                    npx.rms_norm_residual(jx, jr, jg)):
        _close(t, np.asarray(j), 1e-5)
    _close(tnn.layer_norm(tx, tg, tb), npx.layer_norm(jx, jg, jb), 1e-5)
    blk = jnn.RMSNorm(in_channels=32)
    blk.initialize()
    tblk = RMSNorm(32)
    _close(tblk(tx), blk(mx.np.array(x)).asnumpy(), 1e-5)
    for fn, args in ((tnn.rms_norm, (tx, tg)),
                     (tnn.layer_norm_residual, (tx, tr, tg, tb))):
        with pytest.raises(ValueError, match="last axis"):
            fn(*args, axis=0)


@pytest.mark.parametrize("axis", [0, 1, -2, -1])
def test_ops_layer_norm_over_any_axis_matches_npx(axis):
    rng = np.random.RandomState(11)
    x = rng.randn(4, 6, 32).astype(np.float32)
    h = x.shape[axis]
    g, b = rng.randn(h).astype(np.float32), rng.randn(h).astype(np.float32)
    got = tnn.layer_norm(*map(torch.from_numpy, (x, g, b)), axis=axis,
                         eps=1e-12)
    want = npx.layer_norm(*map(jnp.asarray, (x, g, b)), axis=axis, eps=1e-12)
    _close(got, want, 1e-5)


def test_layers_check_in_channels_and_swap_their_norm():
    ln, rn = LayerNorm(8), RMSNorm(8)
    for m in (ln, rn):
        with pytest.raises(MXNetError, match="expected 8"):
            m(torch.zeros(2, 7))
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    ln.norm = tfn.fused_layer_norm_reference
    rn.norm = tfn.fused_rms_norm_reference
    # the plain kernel route on any device and under any policy: x's dtype
    assert ln(x).dtype == rn(x).dtype == torch.bfloat16


def test_kernel_eligible_follows_the_policy(monkeypatch):
    x = torch.zeros(4, 8)
    monkeypatch.setenv("MXTPU_PALLAS", "kernel")
    assert tfn.kernel_eligible(x)
    assert not tfn.kernel_eligible(x, axis=0)
    assert not tfn.kernel_eligible(torch.zeros(8))
    assert not tfn.kernel_eligible(torch.zeros(4, 8, dtype=torch.float64))
    for mode in ("auto", "reference", "off"):
        monkeypatch.setenv("MXTPU_PALLAS", mode)
        assert not tfn.kernel_eligible(x)     # a CPU tensor
