"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

Written in PyTorch for one NVIDIA H100.  Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas for the TPU becomes a kernel
written by hand for Hopper under ``csrc/`` (built at first use by
`kernels`).  The package never imports JAX or ``mxnet_tpu``; it keeps its
own copy of what it needs.  Entry points run on the card unless the caller
passes ``device="cpu"``.

Ported so far (ROADMAP.md): GPT-2-style serving — `models.GPTForCausalLM`
with dense-cache `generate`, and `serve.InferenceEngine` (continuous
batching over a paged KV pool) through the ragged paged-attention kernel
and the int8/int4 dequant-matmul kernel — and BERT pretraining —
`models.BertForPretraining` trained by `parallel.TrainStep` with Adam,
through the flash-attention and streaming cross-entropy kernels.
"""
from .base import MXNetError  # noqa: F401
from .device import resolve_device  # noqa: F401
from . import kernels, ops, models, serve, gluon, optimizer, parallel  # noqa: F401,E501
from .convert import load_jax_params  # noqa: F401

__all__ = ["MXNetError", "resolve_device", "kernels", "ops", "models",
           "serve", "gluon", "optimizer", "parallel", "load_jax_params"]
