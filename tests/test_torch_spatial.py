"""Port parity: the spatial ops of `mxnet_tpu_torch` (`ops.spatial`, through
``npx``) against the JAX package's ``ops/spatial.py`` on the CPU:
``grid_generator`` (affine and warp), ``bilinear_sampler`` (samples past
the border: the in-range taps are kept, the others count zero),
``spatial_transformer``, ``correlation`` (product and absolute
difference, kernel 1 and 3, strides), ``im2col`` / ``col2im`` and
``deformable_convolution`` (one and two deformable groups, with and
without bias).  Each case compares the output and the gradients of
``sum(out ** 2)`` with respect to every float input.  Tolerances: values
rtol 1e-4 / atol 1e-5, gradients rtol and atol 1e-4 (f32; sums in another
order).
"""
import functools

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tm
from mxnet_tpu_torch.ops import spatial
from torch_np_common import jax_results, run_npx, want as _want

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)

_R = np.random.RandomState(41)


def _u(*shape, lo=-1.0, hi=1.0):
    return _R.uniform(lo, hi, shape).astype(np.float32)


INPUTS = {
    "theta": _u(2, 6), "flow": _u(2, 2, 5, 4, lo=-2.0, hi=2.0),
    "img": _u(2, 3, 6, 7), "grid": _u(2, 2, 4, 5, lo=-1.3, hi=1.3),
    "loc": _u(2, 6, lo=-0.6, hi=0.6), "img2": _u(2, 3, 6, 7),
    "col": _u(2, 3 * 6, 21), "img4": _u(2, 4, 6, 7),
    "off1": _u(2, 2 * 9, 6, 7, lo=-1.5, hi=1.5),
    "off2": _u(2, 2 * 2 * 9, 6, 7, lo=-1.5, hi=1.5),
    "dw": _u(5, 4, 3, 3), "db": _u(5),
    "off_s2": _u(2, 2 * 4, 3, 3, lo=-1.0, hi=1.0), "dw2": _u(3, 4, 2, 2),
}
# near the identity, off it: a sample exactly on a pixel sits on the kink
# of the bilinear weights, where the one-sided gradient depends on the
# grid's last bit (``linspace`` rounds differently in the two packages)
INPUTS["near_identity"] = np.tile(
    np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1)) + _u(2, 6, lo=-0.05,
                                                           hi=0.05)

CASES = {}


def _case(key, *args, **kwargs):
    CASES[key] = (args, kwargs)


_case("grid_generator:affine", "theta", target_shape=(5, 4))
_case("grid_generator:warp", "flow", transform_type="warp")
_case("bilinear_sampler", "img", "grid")
_case("spatial_transformer", "img", "loc", target_shape=(4, 5))
_case("spatial_transformer:input_size", "img", "near_identity")
_case("correlation:k3_s2", "img", "img2", kernel_size=3,
      max_displacement=2, stride2=2, pad_size=2)
_case("correlation:abs_s1", "img", "img2", kernel_size=1,
      max_displacement=1, stride1=2, pad_size=1, is_multiply=False)
_case("im2col", "img", kernel=(3, 2), stride=(2, 1), dilate=(1, 2),
      pad=(1, 1))
_case("col2im", "col", output_size=(6, 7), kernel=(3, 2), stride=(2, 1),
      dilate=(1, 2), pad=(1, 1))
_case("deformable_convolution:one_group", "img4", "off1", "dw", "db",
      kernel=(3, 3), pad=(1, 1), num_filter=5)
_case("deformable_convolution:two_groups", "img4", "off2", "dw", None,
      kernel=(3, 3), pad=(1, 1), num_deformable_group=2)
_case("deformable_convolution:strided", "img4", "off_s2", "dw2", None,
      kernel=(2, 2), stride=(2, 2), dilate=(1, 1), pad=(0, 0))


def _run(pkg, key):
    args, kwargs = CASES[key]
    return run_npx(pkg, key.split(":")[0], args, kwargs, INPUTS, True)


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


def test_bilinear_gather_keeps_the_in_range_taps_at_the_border():
    """A sample half a pixel past the right edge keeps its left taps'
    weights (0.5 of the last column); one a whole pixel past reads zero."""
    data = torch.arange(1, 7, dtype=torch.float32).reshape(1, 1, 2, 3)
    x = torch.tensor([[[2.5, 3.0, -0.5]]])
    y = torch.zeros(1, 1, 3)
    got = spatial.bilinear_gather(data, x, y)[0, 0, 0]
    np.testing.assert_allclose(got.numpy(), [1.5, 0.0, 0.5])


def test_col2im_is_the_adjoint_of_im2col():
    x = torch.from_numpy(INPUTS["img"])
    c = torch.from_numpy(_u(2, 3 * 6, 21))
    kw = dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2), pad=(1, 1))
    lhs = (spatial.im2col(x, **kw) * c).sum()
    rhs = (x * spatial.col2im(c, (6, 7), **kw)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)


def test_bad_arguments_raise_as_jax():
    img = torch.from_numpy(INPUTS["img"])
    with pytest.raises(ValueError, match="target_shape"):
        spatial.grid_generator(torch.zeros(1, 6), "affine", (0, 0))
    with pytest.raises(ValueError, match="transform_type"):
        spatial.grid_generator(torch.zeros(1, 6), "shear", (2, 2))
    with pytest.raises(ValueError, match="odd"):
        spatial.correlation(img, img, kernel_size=2)
    with pytest.raises(ValueError, match="empty"):
        spatial.correlation(img, img, max_displacement=4)
    with pytest.raises(ValueError, match="num_group"):
        spatial.deformable_convolution(img, None, None, num_group=2)
    with pytest.raises(ValueError, match="divisible"):
        spatial.deformable_convolution(img, None, torch.zeros(2, 3, 3, 3),
                                       num_deformable_group=2)
