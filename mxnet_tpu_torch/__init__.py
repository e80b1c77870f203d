"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

Written in PyTorch for one NVIDIA H100.  Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas for the TPU becomes a kernel
written by hand for Hopper under ``csrc/`` (built at first use by
`kernels`).  The package never imports JAX or ``mxnet_tpu``; it keeps its
own copy of what it needs.  Entry points run on the card unless the caller
passes ``device="cpu"``.

Ported so far (ROADMAP.md), slice by slice:

1. GPT-2-style serving — `models.GPTForCausalLM` with dense-cache
   `generate`, and `serve.InferenceEngine` (continuous batching over a
   paged KV pool) through the ragged paged-attention kernel and the
   int8/int4 dequant-matmul kernel;
2. BERT pretraining — `models.BertForPretraining` trained by
   `parallel.TrainStep` through the flash-attention and streaming
   cross-entropy kernels;
3. the same step on the default kernel route (`ops.policy`,
   ``MXTPU_PALLAS``): the fused-norm kernel and the multi-tensor
   optimizer kernels (the chunk kernel, LAMB's phases A and B);
4. Switch-MoE training — `parallel.MoEFeedForward` trained by
   `TrainStep` or `gluon.Trainer` through the MoE row-gather kernel, with
   `ops.autotune` choosing kernel blocks;
5. GPT-2-small causal-LM training (`TrainStep`, `gluon.Trainer`), remat
   (`ops.nn.remat_call`) and `generate(use_cache=False)`;
6. sliding windows and grouped K/V (GQA, MQA) inside the flash kernels,
   with RoPE: Mistral-style attention;
7. speculative decoding (`serve.spec`), the cross-request prefix cache,
   beam search and the Transformer translation model
   (`models.TransformerNMT`);
8. attention heads up to 256 wide (Gemma-style) in the flash kernels and
   the paged-attention kernel;
9. the rest of MXNet's optimizer family (`optimizer`: SGD, NAG, Signum,
   SGLD, DCASGD, LARS, Adam, AdamW, AdaBelief, Adamax, Nadam, AdaDelta,
   FTML, AdaGrad, GroupAdaGrad, RMSProp, Ftrl, LAMB, LANS) and its
   learning-rate schedulers, the chunk kernel taking all nine of JAX's
   chunked rules, and JAX optimizer state carried over
   (`load_jax_optimizer_states`);
10. quantized serving: the int8 KV pool read by the paged-attention
    kernel's int8 variant, int8 activations (``MXTPU_QUANT_ACT``) and
    MXNet's int8 workflow with calibration (`contrib.quantization`);
11. mixed precision (`amp`): float16 AMP with its dynamic loss scaler,
    bfloat16 AMP, the `Trainer`'s ``multi_precision`` f32 master copies,
    and float16 inside the flash-attention and cross-entropy kernels;
12. the Gluon front end: `autograd`, devices (`cpu`, `gpu`), `random`,
    `initializer` (``init``), `gluon.Block` / `HybridBlock` over
    ``torch.nn.Module`` with `gluon.Parameter`, the layers of `gluon.nn`,
    every loss of `gluon.loss` (CTC through `ops.nn.ctc_loss`),
    `gluon.metric`, `gluon.utils`, and `contrib.quantization.quantize_net`
    over ``nn.Dense`` through the dequant-matmul kernel;
13. the operations plane on the training path: `resilience` (fault
    points, ``MXTPU_FAULT_SPEC``), `telemetry`, `tracing`, `health`
    (``MXTPU_HEALTH``: probes, anomaly rules, hang watchdog, crash
    bundles), `recovery` (``MXTPU_RECOVERY``: the on-device non-finite
    skip, rollback, budgets), `utils.CheckpointManager`, `elastic`
    (`ElasticLoop`) and `profiler`, with `TrainStep`'s probes, skip and
    ``save`` / ``save_async`` / ``load``;
14. the tensor front end: `ndarray` (``NDArray``) over a torch tensor,
    `numpy` (``np``), `numpy_extension` (``npx``) — whose norm,
    cross-entropy and attention ops reach the kernels — and `nd`, with
    `engine`, `runtime`, `dlpack` and `util`'s NumPy-semantics switches;
    the Gluon, model and training entry points take and return arrays;
15. the data plane: `recordio` (with the native reader, `_native`),
    `data` (the deterministic, checkpointable `DataPipeline` over record
    shards), `gluon.data` (datasets, samplers, batchify, the
    `DataLoader` with thread or process workers, `vision`'s MNIST /
    CIFAR and transforms) and `parallel.DevicePrefetcher`, wired into
    `ElasticLoop` and `CheckpointManager`;
16. convolution and vision: `npx.convolution`, `deconvolution`,
    `pooling` and the spatial ops (`ops.spatial`), `gluon.nn`'s
    convolution and pooling layers, `gluon.model_zoo.vision` (ResNet v1 /
    v2, AlexNet, VGG, SqueezeNet, MobileNet v1 / v2, DenseNet,
    Inception-v3) and `io` (MXNet's 1.x iterators, `ImageRecordIter` and
    `MNISTIter` among them).  `image` (the host image codec) waits for
    ROADMAP.md A11 part 2.
"""
from .base import MXNetError  # noqa: F401
from . import device  # noqa: F401
from .device import (  # noqa: F401
    resolve_device, Device, Context, cpu, gpu, tpu, current_device,
    current_context, num_gpus)
from . import autograd, random, initializer  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .ndarray.ndarray import NDArray  # noqa: F401
from . import numpy  # noqa: F401
from . import numpy as np  # noqa: F401
from . import initializer as init  # noqa: F401
from . import kernels, ops, models, serve, gluon, optimizer, parallel  # noqa: F401,E501
from . import amp, benchmark, contrib  # noqa: F401
from . import resilience, telemetry, tracing, health, recovery  # noqa: F401
from . import elastic, profiler, utils  # noqa: F401
from . import numpy_extension  # noqa: F401
from . import numpy_extension as npx  # noqa: F401
from . import engine, runtime, dlpack, util  # noqa: F401
from . import recordio, data, io  # noqa: F401
from .util import (  # noqa: F401
    np_shape, np_array, use_np, use_np_shape, use_np_array,
    use_np_default_dtype, set_np, reset_np, set_np_shape, is_np_shape,
    is_np_array)
from .optimizer import lr_scheduler  # noqa: F401
from .convert import load_jax_optimizer_states, load_jax_params  # noqa: F401
from .base import UnportedModule as _Unported

image = _Unported("mx.image", "A11 part 2")

__all__ = ["MXNetError", "device", "resolve_device", "Device", "Context",
           "cpu", "gpu", "tpu", "current_device",
           "current_context", "num_gpus", "autograd", "random",
           "initializer", "init", "kernels", "ops", "models", "serve",
           "gluon", "optimizer", "parallel", "amp", "benchmark", "contrib",
           "resilience", "telemetry", "tracing", "health", "recovery",
           "elastic", "profiler", "utils", "ndarray", "nd", "NDArray",
           "numpy", "np", "numpy_extension", "npx", "engine", "runtime",
           "dlpack", "util", "recordio", "data", "io", "image",
           "np_shape", "np_array", "use_np",
           "use_np_shape", "use_np_array", "use_np_default_dtype",
           "set_np", "reset_np", "set_np_shape", "is_np_shape",
           "is_np_array",
           "lr_scheduler", "load_jax_params", "load_jax_optimizer_states"]
