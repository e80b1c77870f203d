"""Operators of the port: each kernel module holds a hand-written CUDA
kernel (``csrc/``) beside its plain PyTorch version, and a dispatcher that
launches the kernel on a CUDA tensor and runs the plain version on a CPU
tensor; `policy` (``MXTPU_PALLAS``) decides the route of the ops whose JAX
counterparts consult it (the fused norm, the fused optimizer, the
dequant-matmul, the MoE dispatch and combine); `autotune` picks and keeps
block sizes.  ``ops.quantized_matmul`` names the module; its
dispatcher of the same name is ``ops.quantized_matmul.quantized_matmul``
(likewise ``ops.flash_attention`` and ``ops.softmax_xent``).  ``ops.nn``
holds the ``numpy_extension`` ops of the training path, convolution and
pooling among them; ``ops.spatial`` the spatial and warping ops."""
from .paged_attention import (  # noqa: F401
    ragged_paged_attention, paged_attention_reference, gather_pages,
    MASK_VALUE)
from .quantized_matmul import (  # noqa: F401
    QuantizedTensor, quantize_weight, dequantize_weight, pack_int4,
    unpack_int4, quantized_matmul_reference, matmul_nt,
    matmul_nt_reference, gather_rows, weight_nbytes, int8_act_matmul,
    act_quant_enabled)
from .attention import (  # noqa: F401
    rope_rotate, multi_head_attention, dot_product_attention,
    reference_attention, band_bias)
from .softmax_xent import softmax_cross_entropy  # noqa: F401
from . import policy, autotune, fused_norm, fused_optimizer, nn  # noqa: F401
from . import moe_dispatch, spatial  # noqa: F401

__all__ = ["ragged_paged_attention", "paged_attention_reference",
           "gather_pages", "MASK_VALUE", "QuantizedTensor",
           "quantize_weight", "dequantize_weight", "pack_int4",
           "unpack_int4", "quantized_matmul_reference",
           "matmul_nt", "matmul_nt_reference", "gather_rows",
           "weight_nbytes", "int8_act_matmul", "act_quant_enabled",
           "rope_rotate", "multi_head_attention",
           "dot_product_attention", "reference_attention", "band_bias",
           "softmax_cross_entropy", "policy", "autotune", "fused_norm",
           "fused_optimizer", "moe_dispatch", "nn", "spatial"]
