"""Build and load the port's hand-written CUDA kernels.

Every ``mxnet_tpu_torch/csrc/*.cu`` file (with the ``*.cuh`` headers it
includes) is compiled at first use by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, one library per source, all sources compiled in parallel.  A
source listed in `SPLITS` is compiled once per part instead, each part a
library of its own built beside the others (the flash kernels, one part
an input type; ragged paged attention, one part for f32 queries and one
for 16-bit ones: their instantiations are the longest builds).  The
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
import time
from typing import Dict

from ..base import MXNetError

__all__ = ["load", "build_all", "LAUNCHES", "reset_launch_counts",
           "launch_counts", "sm_count", "stream_scratch", "NVCC_FLAGS",
           "SPLITS", "BUILD_SECONDS", "count_launch", "DTYPE_LAUNCHES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> launches since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {"ragged_paged_attention": 0,
                            "ragged_paged_attention_int8": 0,
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

#: (kernel name, input dtype) -> launches since the last
#: `reset_launch_counts()`, beside `LAUNCHES` for the kernels whose input
#: type matters to a run (which of them ran in f16, say)
DTYPE_LAUNCHES: Dict[tuple, int] = {}

#: source -> {part: extra nvcc flags}: the source is built once per part,
#: into the library ``<source>_<part>``
SPLITS = {"flash_attention": {"f32": ("-DMXT_FLASH_TYPES=1",),
                              "bf16": ("-DMXT_FLASH_TYPES=2",),
                              "f16": ("-DMXT_FLASH_TYPES=4",)},
          # K1's `types` codes as bits: 0, 2, 3, 5 (f32 queries) and 1, 4,
          # 6 (bf16 or f16 queries)
          "paged_attention": {"q32": ("-DMXT_RPA_TYPES=45",),
                              "q16": ("-DMXT_RPA_TYPES=82",)}}

#: library -> seconds its last build took (the compiler's start to its
#: output file's last write)
BUILD_SECONDS: Dict[str, float] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_sm_counts: Dict[object, int] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    DTYPE_LAUNCHES.clear()


def count_launch(name: str, dtype) -> None:
    """One launch of kernel `name` on inputs of `dtype` (a wrapper calls
    it where it launches, and nowhere else)."""
    LAUNCHES[name] += 1
    key = (name, str(dtype).replace("torch.", ""))
    DTYPE_LAUNCHES[key] = DTYPE_LAUNCHES.get(key, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def sm_count(device) -> int:
    """The card's SM count, read once per device (the launch plans size
    their grids by it)."""
    n = _sm_counts.get(device)
    if n is None:
        import torch
        n = _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def stream_scratch(store, device, stream: int, tickets: int, *floats: int):
    """The split-reduction scratch of one (device, stream), kept in
    `store`: at least `tickets` zeroed uint32 ticket counters (as int32),
    then one f32 buffer of at least each of `floats` elements.  Launches on
    one stream run in order and each leaves its tickets zeroed, so a stream
    keeps one set, grown when a launch needs more; a launch on another
    stream never shares its tickets."""
    import torch
    key = (device.index, stream)
    got = store.get(key)
    want = (tickets,) + floats
    if got is None or any(t.numel() < n for t, n in zip(got, want)):
        have = [0] * len(want) if got is None else [t.numel() for t in got]
        got = store[key] = (
            torch.zeros(max(tickets, have[0], 1024), dtype=torch.int32,
                        device=device),
            *(torch.empty(max(n, h), dtype=torch.float32, device=device)
              for n, h in zip(floats, have[1:])))
    return got


def _sources():
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _libraries() -> Dict[str, tuple]:
    """library -> (source, extra nvcc flags): one a source, or one a part
    of a source in `SPLITS`."""
    out = {}
    for n in _sources():
        for part, flags in SPLITS.get(n, {None: ()}).items():
            out[n if part is None else f"{n}_{part}"] = (n, flags)
    return out


def _build_root() -> str:
    """The port's build root: ``MXTPU_TORCH_BUILD_DIR``, else
    ``build/mxnet_tpu_torch/`` beside the package (the kernels and the
    native record reader build under it, never in the package)."""
    return os.environ.get("MXTPU_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "mxnet_tpu_torch")


def _build_dir() -> str:
    """The libraries' directory, keyed by the flags and every file under
    ``csrc/`` (sources and the headers they include), so an edited header
    rebuilds too."""
    root = _build_root()
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(SPLITS)).encode())
    for name in sorted(f for f in os.listdir(CSRC)
                       if f.endswith((".cu", ".cuh"))):
        with open(os.path.join(CSRC, name), "rb") as f:
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
    libs = _libraries()
    paths = {n: os.path.join(out_dir, f"lib{n}.so") for n in libs}
    todo = [n for n, p in paths.items() if not os.path.isfile(p)]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        src, flags = libs[n]
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *flags,
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, src + ".cu")]
        procs[n] = (tmp, time.time(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, t0, p) in procs.items():
        log, _ = p.communicate()
        if verbose and log:
            print(f"[nvcc {n}]\n{log}", flush=True)
        if p.returncode != 0:
            failed.append(f"--- nvcc {n} (exit {p.returncode}) ---\n{log}")
        else:
            BUILD_SECONDS[n] = os.path.getmtime(tmp) - t0
            os.replace(tmp, paths[n])
    if failed:
        raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built from ``csrc/<name>.cu`` or from a
    part of a `SPLITS` source (built on first use, every library at
    once)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            paths = build_all()
            if name not in paths:
                raise MXNetError(f"no kernel library {name!r}: built are "
                                 f"{sorted(paths)}")
            _libs[name] = ctypes.CDLL(paths[name])
        return _libs[name]
