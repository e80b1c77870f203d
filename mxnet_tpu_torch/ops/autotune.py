"""Block-size autotuner (counterpart of ``mxnet_tpu/ops/pallas/autotune.py``).

Search then persist: each tunable op registers a candidate grid of
`BlockConfig`s, an analytic cost model (`predict_s`: the roofline plus a
per-block overhead) prunes the grid to ``top_k``, the survivors are timed
through `benchmark.opperf.time_callable` (CUDA events after an L2 flush on
a card, the host clock on the CPU), and the winner is kept in memory
and in a JSON file keyed ``op|shape bucket|dtype|device kind``, so a warm
start runs no timed trial.

`tune()` runs timed work: call it from host code (a warmup, a benchmark,
the chip smoke), never inside a step.  `cached_config()` is a dictionary
(and, once per key, file) lookup that kernel wrappers consult to pick
their block sizes; with nothing tuned it returns None and the wrapper
keeps its static default.  A wrapper that memoises its answers keeps them
while `generation()` stays the same.

Registered so far: ``fused_optimizer`` (the chunk kernel's elements per
block, `ops.fused_optimizer`), ``moe_dispatch`` (kernel against the
plain scatter, `ops.moe_dispatch`; nothing on the path consults it, as in
JAX), ``quantized_matmul`` (K2's variant and split-K factor,
`ops.quantized_matmul`), ``paged_attention`` (the KV pool's page size,
`ops.paged_attention`, which `serve.ServeConfig` takes when
``MXTPU_SERVE_PAGE_SIZE`` is unset), ``flash_attention`` (the flash
forward's block_q and block_k, `ops.flash_attention.resolve_blocks`) and
``fused_norm`` (the norm kernel's rows a block,
`ops.fused_norm.resolve_block_rows`).  With `telemetry` enabled, `tune()`
counts ``autotune_hits`` / ``autotune_misses``, observes
``autotune_search_ms`` and journals an ``autotune`` event, as JAX's does;
a search also records the winner's roofline and measured time with
`tracing.CostAccountant.record_features` (key ``autotune/<op>/<key>``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["BlockConfig", "TuneResult", "register_tunable", "tunables",
           "tune", "cached_config", "lookup_any", "cache_dir",
           "clear_memory_cache", "shape_bucket", "device_kind",
           "predict_s", "dtype_name", "generation"]


class BlockConfig(dict):
    """One block-size choice for a kernel launch: a str -> int mapping
    with attribute access (``BlockConfig(chunk=8192).chunk``), shared by
    the tuner, the JSON cache and the kernel wrappers."""

    def __getattr__(self, name: str) -> int:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def key(self) -> Tuple[Tuple[str, int], ...]:
        return tuple(sorted(self.items()))

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in sorted(self.items()))
        return f"BlockConfig({inner})"


@dataclasses.dataclass
class TuneResult:
    """Outcome of one `tune()` call."""

    config: BlockConfig
    cache_hit: bool          # True: no search ran (memory or disk hit)
    source: str              # "memory" | "search"
    trials: int              # timed candidates (0 on a warm start)
    search_ms: float
    timings_ms: Dict[Tuple[Tuple[str, int], ...], float]


@dataclasses.dataclass
class _Tunable:
    name: str
    # candidates(shapes, dtype) -> [BlockConfig, ...]
    candidates: Callable[[Sequence[int], str], List[BlockConfig]]
    # build(config, shapes, dtype) -> zero-argument thunk running ONE
    # launch (the thunk owns its inputs; opperf times it)
    build: Callable[[BlockConfig, Sequence[int], str], Callable[[], Any]]
    # roofline(config, shapes, dtype) -> {"flops", "bytes", "steps"}
    roofline: Callable[[BlockConfig, Sequence[int], str], Dict[str, float]]


_REGISTRY: Dict[str, _Tunable] = {}
_MEM: Dict[str, BlockConfig] = {}
# keys known to be absent on disk, so an untuned key does not re-read the
# JSON file at every launch; a search in this process clears its key
_MEM_MISS: set = set()
_LOCK = threading.Lock()
# bumped whenever `cached_config` may answer differently in this process
_GEN = 0


def register_tunable(name: str, candidates, build, roofline) -> None:
    """Register one tunable op (the last registration wins)."""
    _REGISTRY[name] = _Tunable(name, candidates, build, roofline)


def tunables() -> List[str]:
    _ensure_builtin()
    return sorted(_REGISTRY)


def _ensure_builtin() -> None:
    """Import the kernel modules that register tunables."""
    from . import (flash_attention, fused_norm,  # noqa: F401
                   fused_optimizer, moe_dispatch, paged_attention,
                   quantized_matmul)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

# (device-kind substring, peak FLOP/s, memory bytes/s, per-block overhead
# s).  The Hopper row holds the H100 SXM's spec-sheet values (dense bf16
# tensor-core peak, HBM3 bandwidth) and a nominal block cost; the CPU row
# nominal values.  They only RANK candidates, they predict no time.
_DEVICE_MODEL = (
    ("h100", 989e12, 3.35e12, 2e-8),
    ("cpu", 1e11, 5e10, 2e-6),
)


def device_kind() -> str:
    """``torch.cuda.get_device_name()`` on a card, else ``"cpu"``."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


def _device_of(kind: str):
    """The device that `device_kind()` answered `kind` for: the current
    card, or the CPU."""
    import torch
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _model_for(kind: str) -> Tuple[float, float, float]:
    k = kind.lower()
    for sub, flops, bw, ovh in _DEVICE_MODEL:
        if sub in k:
            return flops, bw, ovh
    return _DEVICE_MODEL[-1][1:]


def predict_s(tunable: _Tunable, config: BlockConfig,
              shapes: Sequence[int], dtype: str,
              kind: Optional[str] = None) -> float:
    """Analytic score: max(compute roofline, memory roofline) plus the
    per-block overhead."""
    peak, bw, overhead = _model_for(kind or device_kind())
    r = tunable.roofline(config, shapes, dtype)
    return max(r.get("flops", 0.0) / peak, r.get("bytes", 0.0) / bw) \
        + r.get("steps", 1.0) * overhead


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def cache_dir() -> Optional[str]:
    """``MXTPU_AUTOTUNE_CACHE``, else ``MXTPU_COMPILE_CACHE``/autotune,
    else None (memory only)."""
    d = os.environ.get("MXTPU_AUTOTUNE_CACHE")
    if d:
        return d
    cc = os.environ.get("MXTPU_COMPILE_CACHE")
    if cc:
        return os.path.join(cc, "autotune")
    return None


def shape_bucket(shapes: Sequence[int]) -> Tuple[int, ...]:
    """Every dim rounded up to the next power of two: one tuned config
    serves the bucket."""
    out = []
    for s in shapes:
        s = int(s)
        out.append(s if s <= 1 else 1 << (s - 1).bit_length())
    return tuple(out)


def dtype_name(dtype) -> str:
    """The key's dtype spelling: ``torch.bfloat16`` -> ``"bfloat16"``, as
    the JAX package spells ``str(jnp.bfloat16)``."""
    return str(dtype).replace("torch.", "")


def _key(op: str, shapes: Sequence[int], dtype: str, kind: str) -> str:
    b = "x".join(str(s) for s in shape_bucket(shapes))
    return f"{op}|{b}|{dtype_name(dtype)}|{kind.replace(' ', '_')}"


def _disk_path(op: str) -> Optional[str]:
    d = cache_dir()
    return None if d is None else os.path.join(d, f"autotune_{op}.json")


def _disk_load(op: str) -> Dict[str, dict]:
    path = _disk_path(op)
    if path is None:
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _disk_store(op: str, key: str, config: BlockConfig,
                extra: Optional[dict] = None) -> None:
    path = _disk_path(op)
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = _disk_load(op)
        data[key] = {"config": dict(config), **(extra or {})}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)   # atomic: concurrent tuners race benignly
    except OSError:
        pass                    # persistence is best effort, never fatal


def clear_memory_cache() -> None:
    """Drop the in-process cache (disk entries survive)."""
    global _GEN
    with _LOCK:
        _MEM.clear()
        _MEM_MISS.clear()
        _GEN += 1


def generation():
    """A token that changes whenever `cached_config` may answer
    differently in this process: a search kept a config, `lookup_any`
    loaded one, the memory cache was cleared, or ``MXTPU_AUTOTUNE`` was
    switched."""
    return _GEN, _autotune_enabled()


# ---------------------------------------------------------------------------
# lookup and search
# ---------------------------------------------------------------------------

def _autotune_enabled() -> bool:
    v = os.environ.get("MXTPU_AUTOTUNE", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def _config(entry) -> Optional[BlockConfig]:
    if isinstance(entry, dict) and isinstance(entry.get("config"), dict):
        return BlockConfig({k: int(v) for k, v in entry["config"].items()})
    return None


def cached_config(op: str, shapes: Sequence[int],
                  dtype="float32") -> Optional[BlockConfig]:
    """The tuned config of this key (memory, then disk), or None when
    nothing was tuned or ``MXTPU_AUTOTUNE=0``."""
    if not _autotune_enabled():
        return None
    key = _key(op, shapes, dtype, device_kind())
    with _LOCK:
        hit = _MEM.get(key)
        if hit is not None:
            return hit
        if key in _MEM_MISS:
            return None
    cfg = _config(_disk_load(op).get(key))
    with _LOCK:
        if cfg is not None:
            _MEM[key] = cfg
        else:
            _MEM_MISS.add(key)
    return cfg


def lookup_any(op: str) -> Optional[BlockConfig]:
    """Any tuned config of `op` on this device kind, whatever its shape
    bucket and dtype — for knobs that belong to the device rather than the
    shape.  Memory first, then disk."""
    if not _autotune_enabled():
        return None
    kind = device_kind().replace(" ", "_")

    def match(key: str) -> bool:
        parts = key.split("|")
        return len(parts) == 4 and parts[0] == op and parts[3] == kind

    with _LOCK:
        for key, cfg in _MEM.items():
            if match(key):
                return cfg
    global _GEN
    for key, entry in sorted(_disk_load(op).items()):
        cfg = _config(entry)
        if match(key) and cfg is not None:
            with _LOCK:
                _MEM[key] = cfg
                _GEN += 1
            return cfg
    return None


def tune(op: str, shapes: Sequence[int], dtype="float32", warmup: int = 1,
         runs: int = 5, top_k: int = 4) -> TuneResult:
    """Pick, keep and persist the best `BlockConfig` of one (op, shapes,
    dtype, device kind) key.

    Warm: a memory or disk hit returns at once with 0 trials.  Cold: the
    op's candidates are ranked by `predict_s`, the best `top_k` are timed
    (`time_callable` on the device of the key's kind, median of `runs`:
    CUDA events on a card, the host clock on the CPU), and the fastest is
    kept.  A
    survivor that fails to build or run loses; when every survivor fails,
    nothing is kept, so a later healthy process searches again."""
    _ensure_builtin()
    if op not in _REGISTRY:
        raise MXNetError(f"unknown tunable op {op!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    tunable = _REGISTRY[op]
    from .. import telemetry as _tele
    kind = device_kind()
    key = _key(op, shapes, dtype, kind)
    hit = cached_config(op, shapes, dtype)
    if hit is not None:
        if _tele.enabled():
            _tele.counter(
                "autotune_hits",
                "tune() calls served from the persisted/in-memory "
                "config cache (zero timed trials)").inc()
        return TuneResult(hit, True, "memory", 0, 0.0, {})

    t0 = time.perf_counter()
    cands = [c for c in tunable.candidates(shapes, dtype) if c]
    if not cands:
        raise MXNetError(f"tunable {op!r} produced no candidates for "
                         f"shapes={tuple(shapes)} dtype={dtype}")
    ranked = sorted(cands, key=lambda c: predict_s(tunable, c, shapes,
                                                   dtype, kind))
    survivors = ranked[:max(1, top_k)]

    from ..benchmark.opperf import time_callable
    dev = _device_of(kind)
    timings: Dict[Tuple[Tuple[str, int], ...], float] = {}
    best, best_ms = survivors[0], math.inf
    for cfg in survivors:
        try:
            thunk = tunable.build(cfg, shapes, dtype)
            ms = time_callable(thunk, warmup=warmup, runs=runs,
                               device=dev)["median_ms"]
        except Exception:
            continue    # an unbuildable survivor loses, it does not abort
        timings[cfg.key()] = ms
        if ms < best_ms:
            best, best_ms = cfg, ms
    search_ms = (time.perf_counter() - t0) * 1e3
    if not timings:
        # every survivor failed: nothing is pinned, the key stays cold
        if _tele.enabled():
            _tele.counter(
                "autotune_misses",
                "tune() calls that ran a timed search").inc()
            _tele.event("autotune", op=op, key=key, config=None,
                        trials=0, failed=True,
                        search_ms=round(search_ms, 2))
        return TuneResult(best, False, "search", 0, search_ms, {})
    global _GEN
    with _LOCK:
        _MEM[key] = best
        _MEM_MISS.discard(key)
        _GEN += 1
    _disk_store(op, key, best, extra={"dtype": dtype_name(dtype),
                                      "device_kind": kind,
                                      "median_ms": round(best_ms, 4)})
    # performance attribution (tracing): the winner's analytic roofline
    # beside its measured time, one labeled row per tuned key
    try:
        from .. import tracing as _trace
        rf = tunable.roofline(best, shapes, dtype)
        _trace.account().record_features(
            f"autotune/{op}/{key}",
            {"flops": float(rf.get("flops", 0.0)),
             "bytes_accessed": float(rf.get("bytes", 0.0))},
            kind="autotune_trial", op=op, config=dict(best),
            measured_ms=round(best_ms, 4), source="roofline")
    except Exception:   # attribution must never fail a search
        pass
    if _tele.enabled():
        _tele.counter(
            "autotune_misses",
            "tune() calls that ran a timed search").inc()
        _tele.histogram(
            "autotune_search_ms",
            "Wall time of one autotune search (prune + timed trials)"
        ).observe(search_ms)
        _tele.event("autotune", op=op, key=key, config=dict(best),
                    trials=len(timings), search_ms=round(search_ms, 2))
    return TuneResult(best, False, "search", len(timings), search_ms,
                      timings)
