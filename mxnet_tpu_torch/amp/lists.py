"""AMP op lists (counterpart of ``mxnet_tpu/amp/lists.py``: the same names
and the same five lists, kept here because the port imports nothing of
the JAX package; parity: `python/mxnet/amp/lists/symbol_fp16.py` /
`symbol_bf16.py`).

The lists drive the port's cast hook, `amp.cast_inputs(name, *tensors)`,
which the op entry points call under the JAX package's ``apply_op`` names
(`ops.nn`, `ops.attention`) once `amp.init()` has run: each call is
classified by name and its float inputs are cast accordingly before the
op computes.

Categories (reference naming):
- TARGET_DTYPE_OPS: run in the AMP dtype (bf16/fp16) — matmul/conv-class
  ops where reduced precision is the point.
- FP32_OPS: always compute in fp32 — exponentials, logs, losses,
  normalisation statistics, reductions whose accumulation order matters.
- WIDEST_TYPE_CASTS: multi-input ops cast to the widest float dtype among
  their inputs (the reference's `widest_type_cast` list).
- CONDITIONAL_FP32_OPS: fp32 only for specific attribute values
  (e.g. softrelu's exp overflows fp16).
- FP16_FP32_OPS: safe in either precision — run in whatever dtype arrives
  (listed for documentation/completeness; the hook leaves them untouched).

The names are the JAX package's exported surface (``mx.np``, ``mx.npx``,
``mx.nd`` CamelCase tail, contrib), kept whole so `list_*` answer as
JAX's do; the port's entry points call the hook under the names of this
surface they implement.
"""

# -- run in the AMP target dtype (MXU-bound) --------------------------------
TARGET_DTYPE_OPS = [
    "fully_connected", "FullyConnected", "convolution", "Convolution",
    "deconvolution", "Deconvolution", "dot", "batch_dot", "matmul",
    "einsum", "tensordot", "inner", "outer", "kron", "vdot",
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
    "multi_head_attention", "sldwin_atten_score", "sldwin_atten_context",
    "rnn", "RNN", "correlation", "Correlation",
    "deformable_convolution", "DeformableConvolution",
    "im2col", "col2im", "khatri_rao",
]
FP16_FUNCS = TARGET_DTYPE_OPS  # back-compat alias

# -- always fp32 (numerics-sensitive) ---------------------------------------
FP32_OPS = [
    # softmax / probability chains
    "softmax", "log_softmax", "masked_softmax", "masked_log_softmax",
    "SoftmaxActivation", "SoftmaxOutput",
    # exponentials / logs / powers
    "exp", "expm1", "log", "log1p", "log2", "log10", "power", "sqrt",
    "rsqrt", "cbrt", "rcbrt", "square", "reciprocal", "broadcast_power",
    "logaddexp", "square_root",
    # special functions
    "gamma", "gammaln", "erf", "erfinv", "sinh", "cosh",
    "arcsinh", "arccosh", "arctanh",
    # losses
    "ctc_loss", "smooth_l1", "MakeLoss", "make_loss", "quadratic",
    # activations whose exp() path overflows fp16 (the reference keeps
    # these on its conditional list; activation() dispatches per act-type
    # name, so they are routed here by name)
    "softrelu", "selu",
    # normalisation statistics
    "batch_norm", "BatchNorm", "layer_norm", "LayerNorm", "group_norm",
    "GroupNorm", "instance_norm", "InstanceNorm", "l2_normalization",
    "L2Normalization", "batch_norm_with_relu",
    # reductions (accumulation-order sensitive)
    "sum", "nansum", "prod", "nanprod", "mean", "norm", "var", "std",
    "cumsum", "cumprod", "average", "trace", "sum_axis",
    # linalg
    "cholesky", "det", "slogdet", "svd", "eig", "eigh", "inv", "pinv",
    "solve", "lstsq", "qr", "tensorinv", "tensorsolve", "matrix_rank",
    # trig / misc numerics
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2",
    "hypot", "broadcast_hypot", "fft", "ifft",
]
FP32_FUNCS = FP32_OPS  # back-compat alias

# -- cast multi-input ops to the widest input float dtype -------------------
WIDEST_TYPE_CASTS = [
    "add", "subtract", "multiply", "divide", "true_divide", "mod",
    "fmod", "remainder", "maximum", "minimum", "fmax", "fmin",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "broadcast_add", "broadcast_plus", "broadcast_sub", "broadcast_minus",
    "broadcast_mul", "broadcast_div", "broadcast_mod",
    "broadcast_maximum", "broadcast_minimum",
    "add_n", "ElementWiseSum", "where", "concatenate", "concat", "Concat",
    "stack", "dstack", "hstack", "vstack", "column_stack", "append",
    "interp",
]

# -- fp32 only for particular attribute values ------------------------------
# NOTE: the built-in activation front ends dispatch each act_type under its
# OWN op name with empty kwargs (npx.activation -> name="softrelu" etc.), so
# their fp16-unsafe variants are routed by the "softrelu"/"selu" entries in
# FP32_OPS above — not through this table. This table is merged with the
# user's `amp.init(conditional_fp32_ops=...)` entries and applies to ops
# whose apply_op call carries the attribute in kwargs.
CONDITIONAL_FP32_OPS = {}

# -- safe in either precision (documented; hook passes through) -------------
FP16_FP32_OPS = [
    "relu", "sigmoid", "tanh", "softsign", "gelu", "silu",
    "elu", "prelu", "Activation", "LeakyReLU",
    "pooling", "Pooling", "UpSampling", "dropout", "Dropout",
    "embedding", "Embedding", "one_hot", "pick", "take", "take_along_axis",
    "gather_nd", "scatter_nd", "topk", "sort", "argsort", "shuffle",
    "reshape", "Reshape", "flatten", "Flatten", "transpose", "swapaxes",
    "SwapAxis", "expand_dims", "squeeze", "split", "SliceChannel",
    "slice", "slice_axis", "slice_like", "reverse", "flip", "tile",
    "repeat", "pad", "Pad", "roll", "rot90", "broadcast_like",
    "broadcast_to", "broadcast_axis", "broadcast_axes", "clip", "abs",
    "sign", "negative", "floor", "ceil", "round", "rint", "trunc", "fix",
    "max", "min", "amax", "amin", "max_axis", "min_axis", "argmax",
    "argmin", "argmax_channel", "sequence_mask", "SequenceMask",
    "SequenceLast", "SequenceReverse", "identity", "BlockGrad",
    "stop_gradient", "Cast", "cast", "amp_cast", "amp_multicast",
    "arange_like", "shape_array", "reshape_like", "diag", "diagonal",
    "tril", "triu", "eye", "spatial_transformer", "SpatialTransformer",
    "bilinear_sampler", "BilinearSampler", "grid_generator",
    "GridGenerator", "BilinearResize2D", "AdaptiveAvgPooling2D",
    "ROIAlign", "roi_align", "box_iou", "box_nms", "sldwin_atten_mask_like",
    "batch_take", "softmax_cross_entropy",
]
FP16_FP32_FUNCS = FP16_FP32_OPS  # back-compat alias
