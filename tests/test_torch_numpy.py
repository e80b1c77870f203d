"""Port parity: ``mx.np`` of `mxnet_tpu_torch` against the JAX package's,
on the CPU.

One parametrised test runs every name of JAX's ``_DELEGATE`` table that
the port has, and the creation, joining and splitting functions, on the
same seeded inputs in both packages: values within 1e-6 (elementwise) or
1e-5 (reductions and products), equal shapes and dtypes.  Gradients are
checked for the differentiable core.  The names the port raises on are
listed (ROADMAP.md A16), and a test holds that every JAX name is either
ported with a parity case here or raises by name.  ``mx.np.random`` is
tested for shapes, dtypes, seeding and moments (the two packages'
generators differ).
"""
import functools

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import numpy as jnp_mod
import mxnet_tpu_torch as tm
from mxnet_tpu_torch.base import MXNetError
from torch_np_common import jax_results, want as _want

torch.set_num_threads(1)

_R = np.random.RandomState(2025)


def _u(shape, lo=-2.0, hi=2.0):
    return _R.uniform(lo, hi, shape).astype(np.float32)


def _nans(shape):
    a = _u(shape)
    a[0, 1] = a[2, 3] = np.nan
    return a


INPUTS = {
    "x": _u((3, 4)), "y": _u((3, 4)), "xp": _u((3, 4), 0.1, 2.0),
    "yp": _u((3, 4), 0.1, 2.0), "x01": _u((3, 4), -0.9, 0.9),
    "xg1": _u((3, 4), 1.1, 3.0), "xn": _nans((3, 4)),
    "xinf": np.array([[np.inf, -np.inf, 1.0, np.nan]], np.float32),
    "i": _R.randint(1, 10, (3, 4)).astype(np.int32),
    "i2": _R.randint(1, 5, (3, 4)).astype(np.int32),
    "iz": _R.randint(0, 3, (3, 4)).astype(np.int32),
    "b": _R.rand(3, 4) > 0.5, "b2": _R.rand(3, 4) > 0.5,
    "v": _u(5), "w": _u(5), "v3": _u(3), "w3": _u(3), "a4": _u(4),
    "v6": _u(6, 0.1, 1.0),
    "vs": np.sort(_u(6)), "m": _u((4, 4)), "t3": _u((2, 3, 4)),
    "xs1": _u((1, 3, 1, 4)),
    "iv": np.array([3, 1, 4, 1, 0, 3], np.int32),
    "ia": np.array([1, 2, 5], np.int32),
    "ib": np.array([0, 2], np.int32),
    "ix": np.array([2, 0, 3], np.int32),
    "idx": _R.randint(0, 4, (3, 4)).astype(np.int32),
    "c2": _R.randint(0, 2, (3, 4)).astype(np.int32),
    "ri": np.array([0, 2, 1], np.int32), "ci": np.array([3, 0, 1], np.int32),
    "ii": np.array([0, 5, 11, 7], np.int32),
    "vz": np.array([0, 0, 1.5, 0, 2.5, 0], np.float32),
    "cond3": np.array([True, False, True]),
    "ph": np.cumsum(_u(8, 0.0, 3.0)).astype(np.float32),
    "bins": np.array([-1.0, 0.0, 0.5, 1.5], np.float32),
    "xq": np.array([-0.5, 0.25, 1.0, 2.5], np.float32),
}

EW, RED = 1e-6, 1e-5

# name[:variant] -> (args, kwargs, tol); a string arg that names an input
# is that array, a list of such strings a list of arrays, anything else
# is passed as it is
CASES = {}


def _case(key, *args, tol=EW, **kwargs):
    CASES[key] = (args, kwargs, tol)


for _n, _in in (
        ("negative", "x"), ("positive", "x"), ("absolute", "x"), ("abs", "x"),
        ("fabs", "x"), ("sign", "x"), ("rint", "x"), ("conj", "x"),
        ("conjugate", "x"), ("exp", "x"), ("expm1", "x"), ("exp2", "x"),
        ("log", "xp"), ("log2", "xp"), ("log10", "xp"), ("log1p", "xp"),
        ("sqrt", "xp"), ("cbrt", "x"), ("square", "x"), ("reciprocal", "xp"),
        ("sin", "x"), ("cos", "x"), ("tan", "x01"), ("arcsin", "x01"),
        ("arccos", "x01"), ("arctan", "x"), ("sinh", "x"), ("cosh", "x"),
        ("tanh", "x"), ("arcsinh", "x"), ("arccosh", "xg1"),
        ("arctanh", "x01"), ("degrees", "x"), ("radians", "x"),
        ("deg2rad", "x"), ("rad2deg", "x"), ("ceil", "x"), ("floor", "x"),
        ("trunc", "x"), ("fix", "x"), ("i0", "x"), ("sinc", "x"),
        ("isfinite", "xinf"), ("isinf", "xinf"), ("isnan", "xinf"),
        ("isneginf", "xinf"), ("isposinf", "xinf"), ("signbit", "x"),
        ("logical_not", "b"), ("bitwise_not", "i"), ("invert", "i"),
        ("real", "x"), ("imag", "x"), ("angle", "x"), ("spacing", "x"),
        ("frexp", "x"), ("modf", "x"), ("isreal", "x"), ("iscomplex", "x"),
        ("nan_to_num", "xinf"), ("iscomplexobj", "x"), ("isrealobj", "x")):
    _case(_n, _in)
_case("round", "x", 1)
_case("around", "x")
for _n, _a, _b in (
        ("add", "x", "y"), ("subtract", "x", "y"), ("multiply", "x", "y"),
        ("divide", "x", "yp"), ("true_divide", "i", "i2"),
        ("floor_divide", "x", "yp"), ("mod", "x", "yp"),
        ("remainder", "i", "i2"), ("fmod", "x", "yp"), ("power", "xp", "y"),
        ("float_power", "xp", "y"), ("arctan2", "x", "y"),
        ("hypot", "x", "y"), ("maximum", "x", "y"), ("minimum", "x", "y"),
        ("fmax", "xn", "y"), ("fmin", "xn", "y"), ("copysign", "x", "y"),
        ("nextafter", "x", "y"), ("logaddexp", "x", "y"),
        ("logaddexp2", "x", "y"), ("ldexp", "x", "i2"), ("gcd", "i", "i2"),
        ("lcm", "i", "i2"), ("heaviside", "x", "y"), ("equal", "i", "i2"),
        ("not_equal", "i", "i2"), ("less", "x", "y"),
        ("less_equal", "i", "i2"), ("greater", "x", "y"),
        ("greater_equal", "i", "i2"), ("logical_and", "b", "b2"),
        ("logical_or", "b", "b2"), ("logical_xor", "b", "b2"),
        ("bitwise_and", "i", "i2"), ("bitwise_or", "i", "i2"),
        ("bitwise_xor", "i", "i2"), ("left_shift", "i", "i2"),
        ("right_shift", "i", "i2"), ("divmod", "x", "yp"),
        ("isclose", "x", "y"), ("allclose", "x", "x"),
        ("array_equal", "x", "x"), ("array_equiv", "x", "a4")):
    _case(_n, _a, _b)
_case("add:scalar", "x", 2.5)
_case("multiply:int_scalar", "i", 3)
_case("subtract:left_scalar", 1.5, "x")
_case("clip", "x", -1.0, 1.0)
# reductions
for _k, _a, _kw in (
        ("sum", "x", dict(axis=0)), ("sum:all", "x", {}),
        ("sum:int", "i", {}),
        ("prod", "x", dict(axis=1)), ("mean", "x", {}),
        ("mean:int", "i", dict(axis=0)), ("std", "x", dict(axis=0)),
        ("var", "x", dict(axis=1, ddof=1)), ("min", "x", dict(axis=1)),
        ("max", "x", {}), ("amin", "x", dict(axis=0)),
        ("amax", "x", dict(axis=(0, 1))), ("nansum", "xn", {}),
        ("nanprod", "xn", dict(axis=0)), ("nanmean", "xn", dict(axis=1)),
        ("nanstd", "xn", {}), ("nanvar", "xn", dict(axis=0)),
        ("nanmin", "xn", dict(axis=1)), ("nanmax", "xn", {}),
        ("all", "b", dict(axis=0)), ("any", "b", {}),
        ("ptp", "x", dict(axis=1)), ("median", "x", dict(axis=0)),
        ("nanmedian", "xn", dict(axis=1)),
        ("average:weights", "x", dict(axis=1, weights="a4")),
        ("count_nonzero", "iz", {}),
        ("argmax", "x", dict(axis=1)),
        ("argmin", "x", dict(axis=0)), ("nanargmax", "xn", dict(axis=1)),
        ("nanargmin", "xn", {}), ("cumsum", "x", dict(axis=1)),
        ("cumsum:int", "i", dict(axis=0)),
        ("cumprod", "x01", dict(axis=0)), ("nancumsum", "xn", dict(axis=1)),
        ("nancumprod", "xn", {}), ("diff", "x", dict(axis=0)),
        ("ediff1d", "v", {}),
        ("gradient", "v", {}),
        ("trapezoid", "x", dict(axis=1))):
    _case(_k, _a, tol=RED, **_kw)
_case("quantile", "x", 0.3, axis=0, tol=RED)
_case("percentile", "x", np.array([25.0, 75.0], np.float32), axis=1,
      tol=RED)
_case("nanquantile", "xn", 0.5, tol=RED)
_case("nanpercentile", "xn", 40.0, axis=0, tol=RED)
# products
for _k, _args in (("dot", ("m", "m")), ("dot:3d", ("t3", "m")),
                  ("vdot", ("v", "w")), ("inner", ("x", "y")),
                  ("outer", ("v", "w")), ("tensordot", ("x", "m", 1)),
                  ("kron", ("v3", "w3")), ("trace", ("m",)),
                  ("cross", ("v3", "w3")), ("matmul", ("x", "m")),
                  ("einsum", ("ij,jk->ik", "x", "m")),
                  ("convolve", ("v", "w3")), ("correlate", ("v", "w3"))):
    _case(_k, *_args, tol=RED)
_case("correlate:full", "v", "w3", mode="full", tol=RED)
# shapes
_case("reshape", "x", (4, 3))
_case("ravel", "x")
_case("transpose", "x")
_case("swapaxes", "t3", 0, 2)
_case("moveaxis", "t3", 0, -1)
_case("rollaxis", "t3", 2)
_case("expand_dims", "x", 1)
_case("squeeze", "xs1")
_case("broadcast_to", "a4", (3, 4))
_case("broadcast_arrays", "x", "a4")
_case("atleast_1d", "v")
_case("atleast_2d", "v")
_case("atleast_3d", "x")
_case("flip", "x")
_case("fliplr", "x")
_case("flipud", "x")
_case("rot90", "x")
_case("roll", "x", 2)
_case("repeat", "x", 2, axis=0)
_case("tile", "v3", (2, 2))
_case("append", "x", "y", axis=0)
_case("trim_zeros", "vz")
_case("tril", "m")
_case("triu", "m", 1)
_case("diag", "m")
_case("diagflat", "v3")
_case("diagonal", "m", 1)
_case("extract", "b", "x")
# indexing and selection
_case("take", "x", "ix", axis=1)
_case("take_along_axis", "x", "idx", axis=1)
_case("choose", "c2", ["x", "y"])
_case("compress", "cond3", "x", axis=0)
_case("searchsorted", "vs", "v3")
_case("digitize", "xq", "bins")
_case("select", ["b", "b2"], ["x", "y"])
_case("indices", (2, 3))
_case("unravel_index", "ii", (3, 4))
_case("ravel_multi_index", ["ri", "ci"], (3, 4))
_case("tril_indices", 4)
_case("triu_indices", 4, 1)
_case("diag_indices", 3)
_case("tril_indices_from", "m")
# sorting and sets
_case("sort", "x", axis=1)
_case("sort:flat", "x", axis=None)
_case("argsort", "x")
_case("argsort:ties", "iv")
_case("lexsort", ["v6", "iv"])
_case("setdiff1d", "iv", "ia")
_case("union1d", "iv", "ia")
_case("intersect1d", "iv", "ia")
_case("setxor1d", "iv", "ia")
_case("isin", "i", "ia")
_case("in1d", "iv", "ia")
# statistics
_case("bincount", "iv")
_case("bincount:weights", "iv", weights="v6", tol=RED)
_case("histogram", "v", 4, tol=RED)
_case("histogram_bin_edges", "v", 5, tol=RED)
_case("corrcoef", "x", tol=RED)
_case("cov", "x", tol=RED)
# the rest
_case("interp", "xq", "vs", "v6")
_case("pad", "x", 1)
_case("pad:constant", "x", ((1, 2), (0, 1)), constant_values=3.0)
for _mode in ("reflect", "symmetric"):
    _case(f"pad:{_mode}", "x", ((1, 2), (2, 1)), mode=_mode)
_case("flatnonzero", "iz")
_case("vander", "v3", 4)
_case("shape", "t3")
_case("ndim", "t3")
_case("size", "t3")
_case("delete", "x", 1, axis=1)
_case("delete:flat", "v", np.array([0, 2], np.int32))
_case("resize", "v3", (2, 4))
_case("ix_", "ia", "ib")
_case("polyval", "v3", "x", tol=RED)
_case("unwrap", "ph", tol=RED)
_case("result_type", "i", "x")
_case("promote_types", "int32", "float32")

# the creation, joining and splitting functions
CREATION = {
    "array": lambda p, a: p.np.array(a["x"]),
    "array:int": lambda p, a: p.np.array(a["i"], dtype="int32"),
    "asarray": lambda p, a: p.np.asarray(a["x"]),
    "zeros": lambda p, a: p.np.zeros((2, 3)),
    "ones": lambda p, a: p.np.ones((2, 3)),
    "empty": lambda p, a: p.np.empty((2, 3)),
    "full": lambda p, a: p.np.full((2, 3), 2.5),
    "full:int": lambda p, a: p.np.full((2,), 7),
    "zeros_like": lambda p, a: p.np.zeros_like(p.np.array(a["x"])),
    "ones_like": lambda p, a: p.np.ones_like(p.np.array(a["i"])),
    "full_like": lambda p, a: p.np.full_like(p.np.array(a["x"]), 4.0),
    "empty_like": lambda p, a: p.np.empty_like(p.np.array(a["x"])),
    "arange": lambda p, a: p.np.arange(5),
    "arange:step": lambda p, a: p.np.arange(1, 4, 0.5),
    "arange:int": lambda p, a: p.np.arange(2, 9, 3, dtype="int32"),
    "linspace": lambda p, a: p.np.linspace(0, 1, 7),
    "logspace": lambda p, a: p.np.logspace(0, 2, 4),
    "eye": lambda p, a: p.np.eye(3, 4, k=1),
    "identity": lambda p, a: p.np.identity(3),
    "tri": lambda p, a: p.np.tri(3, 4, -1),
    "meshgrid": lambda p, a: p.np.meshgrid(p.np.array(a["v3"]),
                                           p.np.array(a["a4"])),
    "meshgrid:ij": lambda p, a: p.np.meshgrid(
        p.np.array(a["v3"]), p.np.array(a["a4"]), indexing="ij"),
    "concatenate": lambda p, a: p.np.concatenate(
        [p.np.array(a["x"]), p.np.array(a["y"])], axis=1),
    "concatenate:none": lambda p, a: p.np.concatenate(
        [p.np.array(a["x"]), p.np.array(a["v"])], axis=None),
    "stack": lambda p, a: p.np.stack([p.np.array(a["x"]),
                                      p.np.array(a["y"])], axis=1),
    "vstack": lambda p, a: p.np.vstack([p.np.array(a["x"]),
                                        p.np.array(a["y"])]),
    "hstack": lambda p, a: p.np.hstack([p.np.array(a["x"]),
                                        p.np.array(a["y"])]),
    "dstack": lambda p, a: p.np.dstack([p.np.array(a["x"]),
                                        p.np.array(a["y"])]),
    "column_stack": lambda p, a: p.np.column_stack(
        [p.np.array(a["v"]), p.np.array(a["w"])]),
    "split": lambda p, a: p.np.split(p.np.array(a["x"]), 2, axis=1),
    "split:indices": lambda p, a: p.np.split(p.np.array(a["x"]), [1, 3],
                                             axis=1),
    "array_split": lambda p, a: p.np.array_split(p.np.array(a["v"]), 3),
    "hsplit": lambda p, a: p.np.hsplit(p.np.array(a["x"]), 2),
    "vsplit": lambda p, a: p.np.vsplit(p.np.array(a["t3"]), 2),
    "dsplit": lambda p, a: p.np.dsplit(p.np.array(a["t3"]), [1]),
    "where": lambda p, a: p.np.where(p.np.array(a["b"]), p.np.array(a["x"]),
                                     p.np.array(a["y"])),
    "where:scalar": lambda p, a: p.np.where(p.np.array(a["b"]),
                                            p.np.array(a["x"]), 0.0),
    "unique": lambda p, a: p.np.unique(p.np.array(a["iv"]),
                                       return_counts=True),
    "unique:all": lambda p, a: p.np.unique(
        p.np.array(a["iv"]), return_index=True, return_inverse=True,
        return_counts=True),
    "unique:axis": lambda p, a: p.np.unique(
        p.np.array(a["iz"]), return_index=True, return_inverse=True,
        return_counts=True, axis=1),
    "nonzero": lambda p, a: p.np.nonzero(p.np.array(a["iz"])),
    "argwhere": lambda p, a: p.np.argwhere(p.np.array(a["iz"])),
    "copy": lambda p, a: p.np.copy(p.np.array(a["x"])),
    "trapz": lambda p, a: p.np.trapz(p.np.array(a["x"])),
    "msort": lambda p, a: p.np.msort(p.np.array(a["x"])),
    "alltrue": lambda p, a: p.np.alltrue(p.np.array(a["b"]), axis=0),
    "hamming": lambda p, a: p.np.hamming(6),
    "hanning": lambda p, a: p.np.hanning(6),
    "blackman": lambda p, a: p.np.blackman(6),
    "diag_indices_from": lambda p, a: p.np.diag_indices_from(
        p.np.array(a["m"])),
    "triu_indices_from": lambda p, a: p.np.triu_indices_from(
        p.np.array(a["m"]), 1),
    "broadcast_to:codes": lambda p, a: p.np.broadcast_to(
        p.np.array(a["a4"]), (3, -2)),
    "acos": lambda p, a: p.np.acos(p.np.array(a["x01"])),
    "pow": lambda p, a: p.np.pow(p.np.array(a["xp"]), 2),
    "concat": lambda p, a: p.np.concat([p.np.array(a["v"]),
                                        p.np.array(a["w"])]),
    "finfo": lambda p, a: float(p.np.finfo(p.np.float32).eps),
    "reshape:method": lambda p, a: p.np.array(a["x"]).reshape(2, 6),
}


def _arg(a, pkg):
    if isinstance(a, str) and a in INPUTS:
        return pkg.np.array(INPUTS[a])
    if isinstance(a, list) and a and all(isinstance(v, str) and v in INPUTS
                                         for v in a):
        return [pkg.np.array(INPUTS[v]) for v in a]
    return a


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _flat(o)]
    return [out]


def _host(v):
    if hasattr(v, "asnumpy"):
        return np.asarray(v.asnumpy()), str(v.dtype)
    return v, None


def _compare(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        gv, gd = _host(g)
        wv, wd = _host(w)
        if gd is None and wd is None:
            if isinstance(wv, (int, float, bool, np.generic)):
                np.testing.assert_allclose(float(gv), float(wv), rtol=tol)
            else:
                assert str(gv) == str(wv) and gv == wv, (gv, wv)
            continue
        assert gd == wd, (gd, wd)
        assert gv.shape == wv.shape, (gv.shape, wv.shape)
        if gv.dtype.kind in "fc":
            np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(gv, wv)


def _call(pkg, key):
    name = key.split(":")[0]
    args, kwargs, _ = CASES[key]
    kw = {k: _arg(v, pkg) for k, v in kwargs.items()}
    return getattr(pkg.np, name)(*[_arg(a, pkg) for a in args], **kw)


@pytest.fixture(scope="module")
def jax_want():
    """The JAX package's result of every case, one compile for most."""
    fns = {("case", k): functools.partial(_call, mx, k) for k in CASES}
    fns.update({("creation", k): functools.partial(CREATION[k], mx, INPUTS)
                for k in CREATION})
    fns.update({("grad", k): functools.partial(_grads, mx, k)
                for k in GRADS})
    return jax_results(fns)


@pytest.mark.parametrize("key", sorted(CASES))
def test_delegate_matches_jax(key, jax_want):
    want = _want(jax_want, ("case", key))
    with tm.cpu():
        got = _call(tm, key)
    _compare(got, want, CASES[key][2])


@pytest.mark.parametrize("key", sorted(CREATION))
def test_creation_joining_splitting_match_jax(key, jax_want):
    want = _want(jax_want, ("creation", key))
    with tm.cpu():
        got = CREATION[key](tm, INPUTS)
    _compare(got, want, RED)


def test_in_place_scatters_match_jax():
    outs = []
    for pkg in (mx, tm):
        with (tm.cpu() if pkg is tm else mx.cpu()):
            a = pkg.np.array(INPUTS["x"])
            pkg.np.put_along_axis(a, pkg.np.array(np.array(
                [[1], [0], [3]], np.int32)), pkg.np.array(np.array(
                    [[9.0], [8.0], [7.0]], np.float32)), axis=1)
            m = pkg.np.array(INPUTS["m"])
            pkg.np.fill_diagonal(m, 5.0)
            outs.append((a.asnumpy(), m.asnumpy()))
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, np.asarray(w))


#: the names of JAX's table the port raises on, waiting for ROADMAP.md A16
UNPORTED = {
    "apply_along_axis", "apply_over_axes", "argpartition", "histogram2d",
    "histogramdd", "insert", "packbits", "partition", "piecewise", "poly",
    "polyadd", "polyder", "polydiv", "polyfit", "polyint", "polymul",
    "polysub", "roots", "unpackbits",
}


def test_every_jax_name_is_ported_with_a_case_or_raises_by_name():
    jax_names = set(jnp_mod._DELEGATE)
    assert set(tm.np.UNPORTED) == UNPORTED
    tested = {k.split(":")[0] for k in CASES} | {
        k.split(":")[0] for k in CREATION} | {"put_along_axis",
                                                "fill_diagonal"}
    missing = sorted(jax_names - UNPORTED - tested)
    assert not missing, f"ported without a parity case: {missing}"
    assert set(tm.np._DELEGATE) == jax_names
    for name in sorted(UNPORTED):
        with pytest.raises(MXNetError, match="A16"):
            getattr(tm.np, name)(None)
    for mod in ("linalg", "fft"):
        with pytest.raises(MXNetError, match="A16"):
            getattr(tm.np, mod).norm


# ---------------------------------------------------------------------------
# gradients of the differentiable core
# ---------------------------------------------------------------------------

GRADS = {
    "multiply": ("x", "y"), "divide": ("x", "yp"), "power": ("xp", "y"),
    "maximum": ("x", "y"), "exp": ("x",), "tanh": ("x",), "sum": ("x",),
    "mean": ("x",), "max": ("x",), "std": ("x",), "dot": ("x", "m"),
    "where": ("b", "x", "y"), "concatenate": (["x", "y"],),
    "take": ("x", "ix"),
}


def _grads(pkg, name):
    args = [_arg(a, pkg) for a in GRADS[name]]
    leaves = [a for a in _flat(args) if hasattr(a, "attach_grad")
              and str(a.dtype) == "float32"]
    for a in leaves:
        a.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.np, name)(*args)
        out = (out * out).sum()
    out.backward()
    return [a.grad for a in leaves]


@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradient_matches_jax(name, jax_want):
    want = _want(jax_want, ("grad", name))
    with tm.cpu():
        got = _grads(tm, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), np.asarray(w.asnumpy()),
                                   rtol=RED, atol=RED)


# ---------------------------------------------------------------------------
# mx.np.random
# ---------------------------------------------------------------------------

SAMPLERS = {
    "uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    "normal": (dict(loc=1.0, scale=2.0), 1.0, 4.0),
    "exponential": (dict(scale=2.0), 2.0, 4.0),
    "gamma": (dict(shape=3.0, scale=2.0), 6.0, 12.0),
    "beta": (dict(a=2.0, b=3.0), 0.4, 0.04),
    "poisson": (dict(lam=4.0), 4.0, 4.0),
    "lognormal": (dict(mean=0.0, sigma=0.5), np.exp(0.125),
                  (np.exp(0.25) - 1) * np.exp(0.25)),
    "laplace": (dict(loc=1.0, scale=2.0), 1.0, 8.0),
    "gumbel": (dict(loc=0.0, scale=1.0), np.euler_gamma, np.pi ** 2 / 6),
    "logistic": (dict(loc=1.0, scale=1.0), 1.0, np.pi ** 2 / 3),
    "weibull": (dict(a=2.0), np.sqrt(np.pi) / 2, 1 - np.pi / 4),
    "pareto": (dict(a=5.0), 0.25, 5 / (16 * 3)),
    "rayleigh": (dict(scale=2.0), 2 * np.sqrt(np.pi / 2),
                 (4 - np.pi) / 2 * 4),
    "chisquare": (dict(df=4.0), 4.0, 8.0),
    "f": (dict(dfnum=5.0, dfden=10.0), 10 / 8, None),
    "standard_normal": ({}, 0.0, 1.0),
    "standard_exponential": ({}, 1.0, 1.0),
    "standard_gamma": (dict(shape=2.0), 2.0, 2.0),
    "standard_t": (dict(df=10.0), 0.0, 10 / 8),
    "binomial": (dict(n=10, p=0.3), 3.0, 2.1),
    "negative_binomial": (dict(n=3, p=0.5), 3.0, 6.0),
    "geometric": (dict(p=0.25), 4.0, 12.0),
    "vonmises": (dict(mu=0.5, kappa=4.0), 0.5, None),
    "power": (dict(a=3.0), 0.75, 3 / 80),
}


#: the samplers whose JAX package draws are not float32
SAMPLER_DTYPES = {"poisson": "int32", "negative_binomial": "int32",
                  "geometric": "int32"}


def test_sampler_dtypes_are_the_jax_packages():
    for name in sorted(SAMPLERS):
        kw = SAMPLERS[name][0]
        with tm.cpu():
            got = getattr(tm.np.random, name)(size=(2,), **kw).dtype
        assert str(got) == SAMPLER_DTYPES.get(name, "float32"), name
    for name in ("poisson", "binomial", "geometric", "gamma"):
        kw = SAMPLERS[name][0]
        want = getattr(mx.np.random, name)(size=(2,), **kw).dtype
        assert str(want) == SAMPLER_DTYPES.get(name, "float32"), name


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_shape_dtype_seed_and_moments(name):
    kw, mean, var = SAMPLERS[name]
    fn = getattr(tm.np.random, name)
    with tm.cpu():
        tm.np.random.seed(5)
        a = fn(size=(20000,), **kw)
        tm.np.random.seed(5)
        b = fn(size=(20000,), **kw)
        c = fn(size=(20000,), **kw)
    assert a.shape == (20000,) and str(a.dtype) == SAMPLER_DTYPES.get(
        name, "float32")
    assert np.array_equal(a.asnumpy(), b.asnumpy())
    assert not np.array_equal(a.asnumpy(), c.asnumpy())
    x = a.asnumpy().astype(np.float64)
    sd = np.sqrt(var if var is not None else x.var())
    assert abs(x.mean() - mean) < 5 * sd / np.sqrt(x.size), x.mean()
    if var is not None:
        assert abs(x.var() - var) < 0.1 * var, x.var()


def test_random_surface_shapes_and_dtypes():
    with tm.cpu():
        tm.np.random.seed(3)
        r = tm.np.random
        assert r.rand(2, 3).shape == (2, 3) and r.randn(4).shape == (4,)
        i = r.randint(2, 9, size=(100,))
        assert str(i.dtype) == "int32" and int(i.min()) >= 2 and \
            int(i.max()) < 9
        assert r.randint(5).shape == ()
        ch = r.choice(10, size=(6,), replace=False)
        assert len(set(ch.tolist())) == 6
        pool = tm.np.array(np.arange(5.0))
        assert set(r.choice(pool, size=(8,)).tolist()) <= set(range(5))
        p = r.choice(3, size=(2000,), p=[0.0, 0.2, 0.8]).asnumpy()
        assert (p != 0).all() and abs((p == 2).mean() - 0.8) < 0.05
        perm = r.permutation(7)
        assert sorted(perm.tolist()) == list(range(7))
        x = tm.np.array(np.arange(6.0).reshape(3, 2))
        r.shuffle(x)
        assert sorted(x[:, 0].tolist()) == [0.0, 2.0, 4.0]
        m = r.multinomial(10, [0.2, 0.3, 0.5], size=(4,))
        assert m.shape == (4, 3) and (m.sum(axis=1).asnumpy() == 10).all()
        cat = r.categorical(tm.np.array([[0.0, 1.0], [1.0, 0.0]]),
                            shape=(3,))
        assert cat.asnumpy().tolist() == [[1, 1, 1], [0, 0, 0]]
        assert r.bernoulli(prob=0.3, size=(5,)).shape == (5,)
        assert r.bernoulli(logit=tm.np.zeros((2, 2))).shape == (2, 2)
        mv = r.multivariate_normal(tm.np.zeros(2), tm.np.eye(2), size=(3,))
        assert mv.shape == (3, 2)
        d = r.dirichlet([1.0, 2.0, 3.0], size=(4,))
        np.testing.assert_allclose(d.sum(axis=1).asnumpy(), 1.0, rtol=1e-5)
        assert r.standard_cauchy(size=(3,)).shape == (3,)
        assert r.normal_n(tm.np.zeros(2), 1.0, batch_shape=(3,)).shape == \
            (3, 2)
        assert r.uniform_n(0.0, 1.0, batch_shape=(2, 2)).shape == (2, 2)
        assert str(r.uniform(size=(2,), dtype="float16").dtype) == "float16"
        for name in tm.np.random.UNPORTED:
            with pytest.raises(MXNetError, match="A16"):
                getattr(r, name)(1.0)
