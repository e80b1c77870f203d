"""Build and load the port's hand-written CUDA kernels.

Every ``mxnet_tpu_torch/csrc/*.cu`` file is compiled at first use by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, one library per source, all sources compiled in parallel.  The
libraries land in ``build/mxnet_tpu_torch/<hash>/`` beside the package
(``MXTPU_TORCH_BUILD_DIR`` overrides the root), keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is.  Nothing here includes PyTorch's C++ headers: a build
takes seconds, not minutes.

The libraries are loaded with `ctypes`; each kernel's Python wrapper (in
``mxnet_tpu_torch/ops``) declares its C signature, checks its tensors,
launches on ``torch.cuda.current_stream()`` and raises when the C entry
point returns a CUDA error.  A missing ``nvcc`` or a failed build raises
`MXNetError` with the compiler's output — the card is never skipped.

Each wrapper also counts its launches here (`LAUNCHES`): a run can then
show that its main path really went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

from ..base import MXNetError

__all__ = ["load", "build_all", "LAUNCHES", "reset_launch_counts",
           "launch_counts", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> launches since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {"ragged_paged_attention": 0,
                            "quantized_matmul": 0,
                            "flash_attention_fwd": 0,
                            "flash_attention_bwd": 0,
                            "softmax_xent_fwd": 0,
                            "softmax_xent_bwd": 0,
                            "fused_norm": 0,
                            "fused_optimizer_chunk": 0,
                            "lamb_phase_a": 0,
                            "lamb_phase_b": 0,
                            "moe_dispatch": 0,
                            "moe_combine": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _sources():
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _build_dir() -> str:
    root = os.environ.get("MXTPU_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "mxnet_tpu_torch")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(root, h.hexdigest()[:16])


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise MXNetError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from mxnet_tpu_torch/csrc at first use and need the "
        "CUDA toolkit")


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every source that has no library yet, all in parallel;
    returns ``{name: library path}``.  ``verbose`` adds ``-Xptxas -v``
    and prints each kernel's register and shared-memory report."""
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths = {n: os.path.join(out_dir, f"lib{n}.so") for n in _sources()}
    todo = [n for n, p in paths.items() if not os.path.isfile(p)]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, n + ".cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if verbose and log:
            print(f"[nvcc {n}]\n{log}", flush=True)
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use, every source at once)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            paths = build_all()
            if name not in paths:
                raise MXNetError(f"no kernel source csrc/{name}.cu")
            _libs[name] = ctypes.CDLL(paths[name])
        return _libs[name]
