"""The float16 LayerNorm on the reference route (``MXTPU_PALLAS=reference``:
mean and variance in the input dtype, as ``npx.layer_norm``), the port's
`ops.fused_norm.layer_norm_reference` against the JAX package's
``mxnet_tpu/ops/pallas/fused_norm.py`` ``layer_norm_reference``, forward
and backward (``jax.vjp`` / torch autograd), with f32 gain and bias as
the f16 models keep them.

rsqrt's backward multiplies by ``rsqrt(var + eps)^3``, which passes f16's
65504 once ``var + eps`` falls below about 6.2e-4: rows of N(0, 0.02^2)
(one GPT-2 embedding's statistics) overflow there to inf and NaN, in both
packages and in the same rows -- a property of the reference's math, not a
fault of the port (ROADMAP.md §C).  GPT-2 small's first LayerNorm sees the
sum of two such embeddings (var ~8e-4; on the card its least ``var + eps``
over 20 steps was 7.2e-4, `f16_nan_probe.py`), where both packages are
finite and agree: the output within 2e-3 of its scale (an f16 ulp: the
packages round mean and variance in other orders), the gradients within
f16's 5e-3 of their scale.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops.pallas import fused_norm as jfn

from mxnet_tpu_torch.ops import fused_norm as tfn

torch.set_num_threads(1)


def _both(std, seed=0, rows=64, h=768):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, h) * std).astype(np.float16)
    g = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    dy = (rng.randn(rows, h) * 1e-3).astype(np.float32)
    y, vjp = jax.vjp(lambda x_, g_, b_: jfn.layer_norm_reference(
        x_, g_, b_, eps=1e-5), jnp.asarray(x), jnp.asarray(g),
        jnp.asarray(b))
    jgrads = [np.asarray(a, np.float32) for a in vjp(jnp.asarray(dy))]
    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    yt = tfn.layer_norm_reference(xt, gt, bt, eps=1e-5)
    yt.backward(torch.from_numpy(dy))
    tgrads = [t.grad.float().numpy() for t in (xt, gt, bt)]
    var_eps = x.astype(np.float64).var(-1) + 1e-5
    return (np.asarray(y, np.float32), yt.detach().numpy(), jgrads, tgrads,
            var_eps)


@pytest.mark.parametrize("std", [0.02, 0.0245, 0.025])
def test_f16_reference_backward_overflows_in_the_same_rows_as_jax(std):
    jy, ty, jg, tg, var_eps = _both(std)
    assert np.isfinite(jy).all() and np.isfinite(ty).all()
    jbad = ~np.isfinite(jg[0]).all(-1)
    tbad = ~np.isfinite(tg[0]).all(-1)
    np.testing.assert_array_equal(tbad, jbad)
    assert jbad.any()                       # the overflow is there
    assert not jbad[var_eps >= 6.5e-4].any()
    assert jbad[var_eps <= 5.5e-4].all()


def test_f16_reference_matches_jax_at_gpt2_first_norm_statistics():
    jy, ty, jg, tg, var_eps = _both(0.02 * np.sqrt(2.0))
    assert var_eps.min() > 6.5e-4
    scale = np.abs(jy).max()
    np.testing.assert_allclose(ty, jy, rtol=0, atol=2e-3 * scale)
    for j, t in zip(jg, tg):
        assert np.isfinite(j).all() and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=5e-3 * np.abs(j).max())
