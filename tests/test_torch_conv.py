"""Port parity: ``npx.convolution``, ``npx.deconvolution`` and
``npx.pooling`` of `mxnet_tpu_torch` (torch's convolutions and pooling
over a tensor padded as JAX pads it, `ops.nn`) against the JAX package's
(``lax.conv_general_dilated`` / ``lax.reduce_window``) on the CPU.

Every case compares the output and, for the differentiable inputs, the
gradients of ``sum(out ** 2)``: 1-D, 2-D and 3-D; stride, dilation,
padding, groups, bias; deconvolution's ``adj`` inside and past torch's
``output_padding`` range and a padding past the kernel's reach; every
pool type, both conventions, both ``count_include_pad``, global pools,
and max windows whose largest elements tie (the gradient goes where
JAX's goes).  Tolerances: values rtol 1e-4 / atol 1e-5, gradients rtol
and atol 1e-4 (f32; sums in another order).
"""
import functools

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tm
from mxnet_tpu_torch.base import MXNetError
from torch_np_common import jax_results, run_npx, want as _want

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)

_R = np.random.RandomState(31)


def _u(*shape):
    return _R.uniform(-1.0, 1.0, shape).astype(np.float32)


def _ties(*shape):
    """ReLU'd data in steps of 0.5: many zeros and equal maxima."""
    return np.maximum(np.round(_R.uniform(-1.0, 1.5, shape) * 2) / 2,
                      0).astype(np.float32)


INPUTS = {
    "x1": _u(2, 4, 11), "w1": _u(6, 4, 3), "b6": _u(6),
    "x2": _u(2, 4, 7, 9), "w2g": _u(6, 2, 3, 3), "w2": _u(5, 4, 2, 3),
    "x3": _u(1, 2, 5, 6, 4), "w3": _u(3, 2, 2, 3, 2), "b3": _u(3),
    "dw1": _u(4, 3, 4), "b3d": _u(3), "dw2g": _u(4, 3, 3, 2),
    "b6d": _u(6), "dw3": _u(2, 2, 2, 3, 2), "b2": _u(2),
    "p1": _u(2, 3, 10), "p2": _u(2, 3, 8, 8), "p3": _u(1, 2, 6, 5, 7),
    "t2": _ties(2, 3, 8, 8), "t1": _ties(2, 3, 12),
}

# name:variant -> (args, kwargs, gradients checked)
CASES = {}


def _case(key, *args, grad=True, **kwargs):
    CASES[key] = (args, kwargs, grad)


_case("convolution:1d", "x1", "w1", "b6", kernel=(3,), stride=2, pad=1,
      dilate=2, num_filter=6)
_case("convolution:2d_groups", "x2", "w2g", "b6", kernel=(3, 3),
      stride=(2, 1), dilate=(1, 2), pad=(1, 2), num_filter=6, num_group=2)
_case("convolution:2d_no_bias", "x2", "w2", None, kernel=(2, 3),
      pad=(0, 1), num_filter=5, no_bias=True)
_case("convolution:3d", "x3", "w3", "b3", kernel=(2, 3, 2),
      stride=(1, 2, 1), pad=(1, 0, 1), num_filter=3)
_case("deconvolution:1d", "x1", "dw1", "b3d", kernel=(4,), stride=2,
      pad=1, adj=1, num_filter=3, no_bias=False)
_case("deconvolution:2d_groups", "x2", "dw2g", "b6d", kernel=(3, 2),
      stride=(2, 3), pad=(1, 0), adj=(1, 2), num_filter=6, num_group=2,
      no_bias=False)
_case("deconvolution:2d_adj_past_stride", "x2", "dw2g", "b6d",
      kernel=(3, 2), stride=(2, 2), dilate=(1, 2), pad=(1, 1), adj=(3, 1),
      num_filter=6, num_group=2, no_bias=False)
_case("deconvolution:2d_pad_past_kernel", "x2", "dw2g", None,
      kernel=(3, 2), pad=(3, 0), num_filter=6, num_group=2)
_case("deconvolution:3d", "x3", "dw3", "b2", kernel=(2, 3, 2),
      stride=(2, 1, 2), pad=(0, 1, 1), adj=(1, 0, 0), num_filter=2,
      no_bias=False, target_shape=(9, 9, 9))
for _conv in ("valid", "full"):
    for _pt in ("max", "avg", "sum", "lp"):
        _case(f"pooling:2d_{_pt}_{_conv}", "p2", kernel=(3, 3),
              stride=(2, 2), pad=(1, 1), pool_type=_pt,
              pooling_convention=_conv)
    _case(f"pooling:2d_avg_{_conv}_real_count", "p2", kernel=(3, 2),
          stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention=_conv, count_include_pad=False)
    _case(f"pooling:1d_max_{_conv}", "p1", kernel=(3,), stride=(2,),
          pad=(2,), pool_type="max", pooling_convention=_conv)
    _case(f"pooling:3d_avg_{_conv}", "p3", kernel=(2, 3, 2),
          stride=(2, 2, 3), pad=(1, 1, 0), pool_type="avg",
          pooling_convention=_conv)
_case("pooling:1d_lp3", "p1", kernel=(4,), stride=(3,), pool_type="lp",
      p_value=3)
_case("pooling:3d_max_no_pad", "p3", kernel=(2, 2, 2), stride=(2, 2, 2),
      pool_type="max")
for _pt in ("max", "avg", "lp"):
    for _x in ("p1", "p2", "p3"):
        _case(f"pooling:global_{_pt}_{_x}", _x, global_pool=True,
              pool_type=_pt)
_case("pooling:ties_2d_overlapping", "t2", kernel=(3, 3), stride=(2, 2),
      pad=(1, 1), pool_type="max")
_case("pooling:ties_2d_full", "t2", kernel=(3, 3), stride=(1, 1),
      pool_type="max", pooling_convention="full")
_case("pooling:ties_1d", "t1", kernel=(4,), stride=(2,), pool_type="max")
_case("pooling:ties_global", "t2", global_pool=True, pool_type="max")


def _run(pkg, key):
    args, kwargs, grad = CASES[key]
    return run_npx(pkg, key.split(":")[0], args, kwargs, INPUTS, grad)


@pytest.fixture(scope="module")
def jax_want():
    return jax_results({k: functools.partial(_run, mx, k) for k in CASES})


def _close(got, want, tol):
    g, w = got.asnumpy(), np.asarray(want.asnumpy())
    assert g.shape == w.shape, (g.shape, w.shape)
    assert str(got.dtype) == str(want.dtype)
    np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("key", sorted(CASES))
def test_matches_jax(key, jax_want):
    want, wgrads = _want(jax_want, key)
    with tm.cpu():
        got, ggrads = _run(tm, key)
    _close(got, want, VAL)
    assert len(ggrads) == len(wgrads)
    for g, w in zip(ggrads, wgrads):
        _close(g, w, GRAD)


def test_tied_maxima_take_the_first_element_in_each_window():
    """Two equal maxima in a window: the whole gradient goes to the first
    in row-major window order, as ``lax.reduce_window`` puts it; a global
    max shares it among ties, as ``jnp.max`` does."""
    x = np.zeros((1, 1, 2, 4), np.float32)
    x[0, 0, 0, 1] = x[0, 0, 1, 0] = 3.0

    def grads(pkg, **kw):
        a = pkg.np.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.npx.pooling(a, **kw)
        y.backward()
        return a.grad.asnumpy()[0, 0]

    window = dict(kernel=(2, 2), stride=(2, 2))
    with tm.cpu():
        got, got_g = grads(tm, **window), grads(tm, global_pool=True)
    # the left window's maxima tie at 3, the right window's at 0
    np.testing.assert_array_equal(got, [[0, 1, 1, 0], [0, 0, 0, 0]])
    np.testing.assert_array_equal(got_g, [[0, .5, 0, 0], [.5, 0, 0, 0]])
    np.testing.assert_array_equal(got, grads(mx, **window))
    np.testing.assert_array_equal(got_g, grads(mx, global_pool=True))


def test_pooling_pads_past_torchs_limits():
    """A max pad wider than half the kernel (torch's own padding refuses
    it) pads with -inf; ``full`` adds a last window starting inside the
    data that ``ceil_mode`` would keep or drop by its own rule."""
    x = _u(1, 2, 5, 5)
    got = tm.npx.pooling(tm.np.array(x, device="cpu"), kernel=(2, 2),
                         stride=(2, 2), pad=(2, 2), pool_type="max")
    want = mx.npx.pooling(mx.np.array(x), kernel=(2, 2), stride=(2, 2),
                          pad=(2, 2), pool_type="max")
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert np.isneginf(got.asnumpy()[0, 0, 0, 0])
    with pytest.raises(MXNetError, match="unknown pool_type"):
        tm.npx.pooling(tm.np.array(x, device="cpu"), kernel=(2, 2),
                       pool_type="median")
