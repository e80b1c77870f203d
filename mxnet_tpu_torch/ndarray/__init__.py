"""`mx.nd` — MXNet 1.x's array namespace (counterpart of
``mxnet_tpu/ndarray/__init__.py``): `mx.np`'s names over the same
`ndarray`, plus `save`, `load`, `waitall` and `NDArray`.

The JAX package's ``legacy_ops`` tail overrides many of those names with
1.x semantics (``split``'s axis 1, ``reshape``'s special codes,
``argmax`` returning float32, the ``broadcast_*`` and layer operators,
the update kernels).  The port has none of them yet: each name of that
list (`LEGACY_NAMES`) raises `MXNetError` naming ROADMAP.md A16 rather
than give NumPy's semantics quietly, except `zeros`, `ones`, `empty` and
`full`, whose 1.x forms are NumPy's with ``ctx`` and a float32 default.
``nd.sparse``, ``nd.random``, ``nd.op`` and ``nd.contrib`` wait for A16,
``nd.image`` for A11 part 2.
"""
from .ndarray import NDArray, ndarray, from_torch  # noqa: F401
from ..base import MXNetError, UnportedModule, unported


def waitall():
    """Wait for all work queued on the card (`engine.waitall`)."""
    from ..engine import waitall as _w
    _w()


def save(fname, data):
    """Save an array, a list or a dict of arrays to `fname` as ``.npz``
    (a list as ``arr_0`` ...), which the JAX package's `nd.load` and
    `npx.load` read.  MXNet's binary NDArray format waits for ROADMAP.md
    A16."""
    from ..util import save_arrays
    if isinstance(data, ndarray):
        data = [data]
    if not isinstance(data, dict):
        data = {f"arr_{i}": a for i, a in enumerate(data)}
    save_arrays(fname, {k: (v._data if isinstance(v, ndarray) else v)
                        for k, v in data.items()})


def load(fname):
    """Load an ``.npz`` written by `save`, `npx.save` or either of the JAX
    package's: a dict of arrays, or a list where the names are exactly
    ``arr_0`` .. ``arr_{n-1}``; the arrays go to the current device.
    MXNet's binary NDArray files raise (ROADMAP.md A16)."""
    from ..numpy import asarray
    from ..util import load_arrays
    with open(fname, "rb") as f:
        head = f.read(8)
    if head[:2] != b"PK":
        raise MXNetError(f"{fname} is not an .npz file; MXNet's binary "
                         "NDArray format is not ported yet (ROADMAP.md A16)")
    out = {k: asarray(v.to(_current())) for k, v in load_arrays(
        fname).items()}
    if out and set(out) == {f"arr_{i}" for i in range(len(out))}:
        return [out[f"arr_{i}"] for i in range(len(out))]
    return out


def _current():
    from ..device import current_device, resolve_device
    return resolve_device(current_device())


def _populate():
    from .. import numpy as _mnp
    g = globals()
    for name in dir(_mnp):
        if not name.startswith("_") and name not in g:
            g[name] = getattr(_mnp, name)


_populate()
del _populate

#: the JAX package's ``legacy_ops.__all__``: MXNet 1.x's operators
LEGACY_NAMES = (
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "broadcast_add", "broadcast_plus", "broadcast_sub", "broadcast_minus",
    "broadcast_mul", "broadcast_div", "broadcast_mod", "broadcast_power",
    "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
    "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
    "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal",
    "broadcast_logical_and", "broadcast_logical_or",
    "broadcast_logical_xor", "broadcast_axis", "broadcast_axes", "add_n",
    "ElementWiseSum", "Flatten", "flatten", "Reshape", "reshape",
    "transpose", "SwapAxis", "swapaxes", "expand_dims", "Concat", "concat",
    "SliceChannel", "split", "slice", "slice_axis", "slice_like", "reverse",
    "flip", "tile", "repeat", "Pad", "pad", "stack", "squeeze", "take",
    "batch_take", "one_hot", "pick", "gather_nd", "scatter_nd", "where",
    "Embedding", "sum", "sum_axis", "nansum", "prod", "nanprod", "mean",
    "max", "min", "max_axis", "min_axis", "norm", "argmax", "argmin",
    "argmax_channel", "sort", "argsort", "topk", "shuffle", "dot",
    "batch_dot", "khatri_rao", "L2Normalization", "smooth_l1", "identity",
    "BlockGrad", "stop_gradient", "make_loss", "MakeLoss", "clip", "Cast",
    "cast", "negative", "reciprocal", "rsqrt", "rcbrt", "square_root",
    "Activation", "LeakyReLU", "FullyConnected", "Convolution",
    "Deconvolution", "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm",
    "Pooling", "Dropout", "RNN", "SoftmaxOutput", "softmax", "log_softmax",
    "SoftmaxActivation", "UpSampling", "SequenceMask", "SequenceLast",
    "SequenceReverse", "Custom", "softmax_cross_entropy",
    "SpatialTransformer", "BilinearSampler", "GridGenerator", "Correlation",
    "im2col", "col2im", "random_uniform", "random_normal", "random_gamma",
    "random_exponential", "random_poisson", "random_negative_binomial",
    "random_randint", "sample_uniform", "sample_normal", "sample_gamma",
    "sample_multinomial", "uniform", "normal", "sgd_update",
    "sgd_mom_update", "adam_update", "rmsprop_update", "rmspropalex_update",
    "ftrl_update", "signsgd_update", "signum_update", "nag_mom_update",
    "mp_sgd_update", "mp_sgd_mom_update", "mp_nag_mom_update",
    "ftml_update", "lamb_update_phase1", "lamb_update_phase2",
    "mp_lamb_update_phase1", "mp_lamb_update_phase2", "multi_sgd_update",
    "multi_sgd_mom_update", "multi_mp_sgd_update",
    "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
    "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
    "preloaded_multi_mp_sgd_mom_update", "multi_sum_sq", "multi_lars",
    "reset_arrays", "all_finite", "multi_all_finite", "LRN", "ROIPooling",
    "CTCLoss", "depth_to_space", "space_to_depth", "moments", "softmin",
    "size_array", "cast_storage", "IdentityAttachKLSparseReg",
    "linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_trsm",
    "linalg_trmm", "linalg_syrk", "linalg_sumlogdiag", "linalg_extractdiag",
    "linalg_makediag", "zeros", "ones", "empty", "full", "split_v2",
    "ravel_multi_index", "unravel_index", "diag",
)


def zeros(shape=None, ctx=None, dtype=None, out=None, **kwargs):
    from ..numpy import zeros as _z
    from .ndarray import _write_out
    return _write_out(_z(shape, dtype=dtype or "float32", ctx=ctx), out)


def ones(shape=None, ctx=None, dtype=None, out=None, **kwargs):
    from ..numpy import ones as _o
    from .ndarray import _write_out
    return _write_out(_o(shape, dtype=dtype or "float32", ctx=ctx), out)


def empty(shape=None, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def full(shape=None, val=None, ctx=None, dtype=None, out=None, **kwargs):
    from ..numpy import full as _f
    return _f(shape, val, dtype=dtype or "float32", ctx=ctx, out=out)


#: the 1.x names ported: `zeros`, `ones`, `empty`, `full`
LEGACY_PORTED = ("zeros", "ones", "empty", "full")
for _name in LEGACY_NAMES:
    if _name not in LEGACY_PORTED:
        globals()[_name] = unported(f"mx.nd.{_name}", "A16")
del _name

sparse = UnportedModule("mx.nd.sparse", "A16")
random = UnportedModule("mx.nd.random", "A16")
op = UnportedModule("mx.nd.op", "A16")
contrib = UnportedModule("mx.nd.contrib", "A16")
image = UnportedModule("mx.nd.image", "A11 part 2")
