"""Optimizer update over a whole parameter tree: the multi-tensor CUDA
kernels and their plain versions (counterpart of
``mxnet_tpu/ops/pallas/fused_optimizer.py``).

`apply_updates` has two routes, as in the JAX package:

- ``use_kernel=False`` (the reference route) runs the optimizer's
  elementwise `_rule` leaf by leaf (`_reference_leaf`), casts the new
  weight and state back to their stored dtypes and returns new tensors; a
  `skip` flag turns the whole update into the identity.  The rule sees the
  weight's stored dtype (``hp["stored_dtype"]``), so LAMB rounds its trust
  ratio to a bf16 weight's dtype, as JAX's reference route does.
- ``use_kernel=True`` (the kernel route, for the rules `kernel_supported`
  names) updates weights and state **in place** and returns the same
  tensors — the port updates in place where JAX returns new arrays, which
  saves a second copy of the weights and the optimizer state and the
  copy back.  On a CUDA tensor it launches ``csrc/fused_optimizer.cu``:
  for the nine elementwise rules the JAX package chunks (Adam, AdamW,
  SGD, NAG, Signum, AdaBelief, Adamax, AdaDelta and FTML; `_chunk_rule`)
  one chunk-kernel launch per group of leaves
  with the same (weight dtype, state dtypes, state structure), over a
  device table of per-leaf pointers (no packing copy), at the elements per
  block the autotuner chose for the group (`_group_chunk`, ``CHUNK`` when
  nothing was tuned; `last_chunk` records it); for LAMB phase A once per
  such group (moments, the update direction r into a per-stream scratch
  and each tensor's trust ratio from deterministically reduced norms, over
  the same kind of leaf table, `_lamb_layout`), then phase B (the bounded
  update) once per group too, over phase A's own device table (each
  launch's grid and path split in `last_lamb_plans`).  The kernels take
  f32, bf16 or f16 weights with f32 state or state in the weight's dtype
  (`TrainStep` keeps f32 state for 16-bit weights, the gluon `Trainer`
  the weight's dtype); a float64 or integer leaf raises by name.  Each
  launch counts under its group's weight dtype
  (`kernels.DTYPE_LAUNCHES`).  The hyperparameters and the skip flag stay
  on the device.  On a CPU tensor it runs the kernels' plain version,
  `kernel_plain` (the same math, the same order of operations: LAMB's
  trust ratio stays f32), and writes the results in place.

`kernel_route` applies the policy of `ops.policy` (``MXTPU_PALLAS``).  Every
other fused-safe rule (LARS, DCASGD, LANS, AdaGrad, GroupAdaGrad,
RMSProp, Ftrl, ``Test``, and any subclass of a kernel rule) takes the
per-leaf reference route on either setting: that is the port of JAX's
own per-leaf (XLA) update for them, not a fallback.  Rules that are not
fused-safe (SGLD, Nadam) run per parameter through `Optimizer.update`
(the `Trainer`) and are refused by `parallel.TrainStep`.

The chunk kernel's block size is tunable (``tune("fused_optimizer",
(group elements,), dtype)``, `ops.autotune`): `_candidates`, `_roofline`
and `_build` (one Adam chunk launch over a seeded leaf, the autotuner's
trial launch) are registered at import.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .. import kernels as _kernels
from ..optimizer import (FTML, LAMB, NAG, SGD, AdaBelief, AdaDelta, Adam,
                         Adamax, AdamW, Signum)
from . import autotune
from .policy import kernel_active

__all__ = ["apply_updates", "supported", "kernel_supported", "kernel_route",
           "kernel_plain", "HpScalarCache", "CHUNK", "last_chunk",
           "last_lamb_plans"]

CHUNK = 8192           # elements of one leaf per block: the static default
LAMB_CHUNK = 8192      # elements of one leaf per LAMB chunk (both phases)
# the kernels' dtype codes (csrc/fused_optimizer.cu; ops/fused_norm.py's)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: weight dtype name -> elements per block of that dtype group's latest
#: chunk launch (on the CPU: the chunk the launch would have used)
last_chunk: Dict[str, int] = {}
# (group elements, weight dtype, device) -> elements per block, valid for
# the autotuner generation in `_chunk_memo_gen`
_chunk_memo: Dict[Any, int] = {}
_chunk_memo_gen = None


# ---------------------------------------------------------------------------
# support predicates
# ---------------------------------------------------------------------------

# the chunk kernel's rule codes (``enum Rule`` in csrc/fused_optimizer.cu)
# and the state slots each takes
_RULES = {Adam: 0, AdamW: 1, NAG: 4, AdaBelief: 7, Adamax: 8, AdaDelta: 9,
          FTML: 10}
_SLOTS = {0: 2, 1: 2, 2: 0, 3: 1, 4: 1, 5: 0, 6: 1, 7: 2, 8: 2, 9: 2, 10: 3}


def _chunk_rule(optimizer) -> int:
    """The chunk kernel's rule code for `optimizer` (its exact class: a
    subclass may change the rule), or -1.  SGD and Signum split on
    momentum."""
    kind = type(optimizer)
    if kind is SGD:
        return 3 if optimizer.momentum != 0.0 else 2
    if kind is Signum:
        return 6 if optimizer.momentum != 0.0 else 5
    return _RULES.get(kind, -1)


def _chunk_consts(optimizer) -> Tuple:
    """The rule's host constants as the kernel takes them: b1, b2, eps,
    1 - b1, 1 - b2, momentum, 1 - momentum, wd_lh, correct_bias (each
    ``1 - x`` in Python's double, as JAX's weak scalars, rounded to f32
    once); AdaDelta's rho rides in b1."""
    o = optimizer
    b1 = getattr(o, "rho", getattr(o, "beta1", 0.0))
    b2 = getattr(o, "beta2", 0.0)
    mu = getattr(o, "momentum", 0.0)
    return (b1, b2, getattr(o, "epsilon", 0.0), 1 - b1, 1 - b2, mu, 1 - mu,
            getattr(o, "wd_lh", 0.0), int(getattr(o, "correct_bias", True)))


def _is_lamb(optimizer) -> bool:
    return type(optimizer) is LAMB


def supported(optimizer) -> bool:
    """Can `apply_updates` run this optimizer at all (a pure rule)?"""
    return bool(getattr(optimizer, "fused_safe", True))


def kernel_supported(optimizer) -> bool:
    """Do the CUDA kernels write this optimizer's math out?  The chunk
    kernel takes the nine rules JAX chunks (every ``fused_elementwise``
    rule: Adam, AdamW, SGD, NAG, Signum, AdaBelief, Adamax, AdaDelta,
    FTML, each by its exact class) and LAMB's phases A and B take LAMB.
    Every other rule runs per leaf (JAX's own per-leaf update for it)."""
    if not supported(optimizer):
        return False
    return (_chunk_rule(optimizer) >= 0 and
            bool(getattr(optimizer, "fused_elementwise", False))) or \
        _is_lamb(optimizer)


def kernel_route(optimizer, device) -> bool:
    """Should a caller on `device` (a `torch.device` or a tensor) ask for
    the kernel route?  The policy says kernels are active there AND the
    kernels cover the optimizer."""
    return kernel_active(device) and kernel_supported(optimizer)


# ---------------------------------------------------------------------------
# the reference route, and the kernels' plain version
# ---------------------------------------------------------------------------

def _cast_like(new, old):
    return new.to(old.dtype) if new.dtype != old.dtype else new


def _reference_leaf(optimizer, w, g, s_old, hp, skip, kernel_math=False):
    # the hyperparameters are f32 tensors; in JAX they promote a 16-bit
    # leaf's update math to f32 (torch's 0-dim tensors would not), so the
    # rule runs on f32 views of the weight and gradient.  The reference
    # route names the stored dtype (where JAX's rule rounds to it); the
    # kernels' math (`kernel_math`) keeps f32, as the kernels do.
    dt = torch.promote_types(w.dtype, torch.float32)
    if not kernel_math:
        hp = dict(hp, stored_dtype=w.dtype)
    nw, ns = optimizer._rule(w.to(dt), g.to(dt), s_old, hp)
    nw = _cast_like(nw, w)
    ns = tuple(_cast_like(n, o) for n, o in zip(ns, s_old))
    if skip is not None:
        # the whole update becomes the identity: weight and state keep
        # their pre-step values
        nw = torch.where(skip, w, nw)
        ns = tuple(torch.where(skip, o, n) for n, o in zip(ns, s_old))
    return nw, ns


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/fused_optimizer.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {"mxt_fused_chunk": [_P, _I, _I, _I, _I, _I, _I] + [_F] * 8
         + [_I] + [_P] * 7,
         "mxt_lamb_phase_a": [_P, _I, _I, _I] + [_P] * 4 + [_I, _I]
         + [_F] * 5 + [_I, _F, _F, _I, _I] + [_P] * 8,
         "mxt_lamb_phase_b": [_P, _I, _I, _I, _P, _P, _I] + [_P] * 4}
_fns = {}


def _kernel_fn(name):
    f = _fns.get(name)
    if f is None:
        f = getattr(_kernels.load("fused_optimizer"), name)
        f.argtypes = _SIGS[name]
        f.restype = _I
        _fns[name] = f
    return f


def _launched(name, err, counter, dtype):
    """Raise on a refused launch, else count it under the group's weight
    dtype (`kernels.count_launch`)."""
    if err:
        raise MXNetError(f"{name} kernel launch failed (cudaError_t {err})")
    _kernels.count_launch(counter, dtype)


class HpScalarCache:
    """The f32 device scalars of lr, wd, rescale_grad and clip_gradient,
    uploaded again only when the optimizer's host values change (JAX's
    ``HpScalarCache``, shared by `parallel.TrainStep` and
    `gluon.Trainer`).  `get` returns a fresh dict with the step count
    ``t`` filled on the device."""

    def __init__(self, device):
        self.device = device
        self._key = None
        self._dev = None

    def get(self, optimizer, t) -> Dict[str, Any]:
        cg = optimizer.clip_gradient
        key = (float(optimizer.learning_rate), float(optimizer.wd),
               float(optimizer.rescale_grad),
               None if cg is None else float(cg))
        if key != self._key:
            self._dev = {"lr": self._scalar(key[0]),
                         "wd": self._scalar(key[1]),
                         "rescale_grad": self._scalar(key[2]),
                         "clip_gradient": None if key[3] is None
                         else self._scalar(key[3])}
            self._key = key
        return dict(self._dev, t=self._scalar(float(t)))

    def _scalar(self, x):
        return torch.full((), x, dtype=torch.float32, device=self.device)


def _device_hp(hp, skip, dev):
    """Device pointers of the f32 hyperparameter scalars and the bool skip
    flag (None for an absent clip or skip).  Device scalars of the right
    type pass through; anything else is copied to the card."""
    def f32(v):
        t = torch.as_tensor(v, dtype=torch.float32, device=dev)
        if t.numel() != 1:
            raise MXNetError(f"hyperparameter must be a scalar, got shape "
                             f"{tuple(t.shape)}")
        return t.reshape(()).contiguous()
    keep = [f32(hp["lr"]), f32(hp["wd"]), f32(hp["rescale_grad"]),
            f32(hp.get("t", 0.0))]
    clip = hp.get("clip_gradient")
    keep.append(None if clip is None else f32(clip))
    keep.append(None if skip is None else torch.as_tensor(
        skip, dtype=torch.bool, device=dev).reshape(()).contiguous())
    ptrs = [None if t is None else t.data_ptr() for t in keep]
    return keep, ptrs


def _check_leaf(name, w, g, states, dev):
    for what, t, dt in (("weight", w, None), ("gradient", g, w.dtype)) + \
            tuple((f"state {k}", s, None) for k, s in enumerate(states)):
        if t.device != dev:
            raise MXNetError(f"{name}: {what} is on {t.device}, not {dev}")
        if t.dtype not in _DTYPES or (dt is not None and t.dtype != dt):
            raise MXNetError(f"{name}: the optimizer kernels take float32, "
                             f"bfloat16 or float16 tensors (the gradient "
                             f"in the weight's dtype), {what} is "
                             f"{t.dtype}")
        if t.shape != w.shape:
            raise MXNetError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"weight {tuple(w.shape)}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: the optimizer kernels need a "
                             f"contiguous {what}")


def _group_chunk(names, params) -> int:
    """Elements per block for the group's launch: the autotuner's choice
    for (group elements,) in the weights' dtype, else `CHUNK`.  Looked up
    once per group shape and `autotune.generation()`, not at every step."""
    global _chunk_memo_gen
    w0 = params[names[0]]
    total = sum(params[n].numel() for n in names)
    gen = autotune.generation()
    if gen != _chunk_memo_gen:
        _chunk_memo.clear()
        _chunk_memo_gen = gen
    key = (total, w0.dtype, w0.device)
    chunk = _chunk_memo.get(key)
    if chunk is None:
        cfg = autotune.cached_config("fused_optimizer", (total,), w0.dtype)
        chunk = int(cfg.chunk) if cfg is not None and "chunk" in cfg \
            else CHUNK
        _chunk_memo[key] = chunk
    last_chunk[autotune.dtype_name(w0.dtype)] = chunk
    return chunk


def _chunk_cuda(optimizer, rule, names, params, grads, states, hptr, dev,
                chunk):
    """One chunk-kernel launch over `names` (one dtype group), in place,
    `chunk` elements of one leaf per block.  The leaf table holds six
    int64 a leaf: weight, gradient, three state pointers (0 past the
    rule's slots; FTML fills all three) and the element count."""
    n_state = len(states[names[0]])
    if n_state != _SLOTS[rule]:
        raise MXNetError(f"{type(optimizer).__name__}: the chunk kernel's "
                         f"rule keeps {_SLOTS[rule]} state tensors, got "
                         f"{n_state}")
    leaves, blocks = [], []
    for i, n in enumerate(names):
        w, g, st = params[n], grads[n], states[n]
        _check_leaf(n, w, g, st, dev)
        ptr = [s.data_ptr() for s in st] + [0] * (3 - n_state)
        leaves.append([w.data_ptr(), g.data_ptr(), *ptr, w.numel()])
        nchunk = -(-w.numel() // chunk)
        blocks.append((i << 32) | np.arange(nchunk, dtype=np.int64))
    table = np.concatenate([np.asarray(leaves, np.int64).ravel()] + blocks)
    n_blocks = table.size - 6 * len(names)
    if n_blocks == 0:
        return
    # pinned and asynchronous: no host sync; the caching host allocator
    # keeps the staging buffer until the copy has run, and the device
    # table's memory is reused only by work queued after the kernel on
    # this stream
    dev_table = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
    w0, s = params[names[0]], states[names[0]]
    err = _kernel_fn("mxt_fused_chunk")(
        dev_table.data_ptr(), len(names), n_blocks, chunk, rule,
        _DTYPES[w0.dtype], _DTYPES[s[0].dtype] if s else 0,
        *_chunk_consts(optimizer), *hptr,
        torch.cuda.current_stream(dev).cuda_stream)
    _launched("fused_optimizer chunk", err, "fused_optimizer_chunk",
              w0.dtype)


class LambLayout(NamedTuple):
    """Where one group's leaves go in a LAMB phase-A launch."""
    r_off: List[int]     # each leaf's first element in the r scratch
    p_off: List[int]     # each leaf's first partial slot (one a chunk)
    chunks: List[int]    # each leaf's chunks
    codes: np.ndarray    # int64 (leaf << 32 | chunk), one a block entry
    r_total: int         # f32 elements of the r scratch
    slots: int           # partial slots (each two f32: w^2 and r^2)


def _lamb_layout(numels: Sequence[int], chunk: int = LAMB_CHUNK
                 ) -> LambLayout:
    """The leaf table's offsets and block map for leaves of `numels`
    elements, plain numpy: each leaf's r at a multiple of 8 elements
    (16-byte aligned), its partial slots contiguous and in chunk order,
    one block entry a (leaf, chunk)."""
    r_off, p_off, chunks, codes = [], [], [], []
    r = slots = 0
    for i, n in enumerate(numels):
        c = -(-int(n) // chunk)
        r_off.append(r)
        p_off.append(slots)
        chunks.append(c)
        codes.append((i << 32) | np.arange(c, dtype=np.int64))
        r += -(-int(n) // 8) * 8
        slots += c
    return LambLayout(r_off, p_off, chunks,
                      np.concatenate(codes) if codes
                      else np.zeros(0, np.int64), r, slots)


class LambPlan(NamedTuple):
    """One dtype group's LAMB launches over its leaf table."""
    block_entries: int   # the group's (leaf, chunk) codes
    grid_a: int          # phase A's persistent blocks, as its entry chose
    grid_b: int          # phase B's
    vector_leaves: int   # leaves whose w is 16-byte aligned: phase B's
    #                      8-element steps
    element_leaves: int  # the others: one element a step (as every tail)


#: the plans of the latest CUDA LAMB update, one a dtype group
last_lamb_plans: List[LambPlan] = []


# (device index, raw stream) -> (tickets, partials, r, ratios): phase A's
# scratch, kept per stream (`kernels.stream_scratch`)
_lamb_scratch: Dict[Any, Tuple[torch.Tensor, ...]] = {}


def _lamb_cuda(optimizer, names, params, grads, states, hptr, dev):
    """In place: per dtype group (`_groups`), one phase-A launch over the
    group's leaf table, then one phase-B launch over the same table."""
    o = optimizer
    for n in names:
        _check_leaf(n, params[n], grads[n], states[n], dev)
        if len(states[n]) != 2:
            raise MXNetError(f"{n}: LAMB state must be (m, v)")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lo, hi = o.lower_bound, o.upper_bound
    phase_a, phase_b = (_kernel_fn("mxt_lamb_phase_a"),
                        _kernel_fn("mxt_lamb_phase_b"))
    grid_a, grid_b = ctypes.c_int(0), ctypes.c_int(0)
    plans = []
    for group in _groups(names, params, states):
        numels = [params[n].numel() for n in group]
        lay = _lamb_layout(numels)
        if lay.codes.size == 0:
            continue
        # the group's r waits in the scratch for its phase-B launch; a
        # later group's phase A overwrites it only after it (one stream)
        tickets, part, r, ratio = _kernels.stream_scratch(
            _lamb_scratch, dev, stream, len(group), 2 * lay.slots,
            lay.r_total, len(group))
        leaves = []
        for i, n in enumerate(group):
            w, g, (m, v) = params[n], grads[n], states[n]
            leaves.append([w.data_ptr(), g.data_ptr(), m.data_ptr(),
                           v.data_ptr(), numels[i], lay.r_off[i],
                           lay.p_off[i], lay.chunks[i]])
        table = np.concatenate([np.asarray(leaves, np.int64).ravel(),
                                lay.codes])
        # pinned and asynchronous, as the chunk kernel's table
        dev_table = torch.from_numpy(table).pin_memory().to(
            dev, non_blocking=True)
        w0, (m0, _) = params[group[0]], states[group[0]]
        wdt = _DTYPES[w0.dtype]
        n_codes = int(lay.codes.size)
        err = phase_a(
            dev_table.data_ptr(), len(group), n_codes, LAMB_CHUNK,
            r.data_ptr(), part.data_ptr(), tickets.data_ptr(),
            ratio.data_ptr(), wdt, _DTYPES[m0.dtype], o.beta1, o.beta2,
            o.epsilon, 1 - o.beta1, 1 - o.beta2, int(o.bias_correction),
            0.0 if lo is None else lo, 0.0 if hi is None else hi,
            int(lo is not None), int(hi is not None), *hptr,
            ctypes.addressof(grid_a), stream)
        _launched("LAMB phase A", err, "lamb_phase_a", w0.dtype)
        err = phase_b(dev_table.data_ptr(), len(group), n_codes, LAMB_CHUNK,
                      r.data_ptr(), ratio.data_ptr(), wdt, hptr[0], hptr[5],
                      ctypes.addressof(grid_b), stream)
        _launched("LAMB phase B", err, "lamb_phase_b", w0.dtype)
        vec = sum(1 for row in leaves if row[0] % 16 == 0)
        plans.append(LambPlan(n_codes, grid_a.value, grid_b.value, vec,
                              len(leaves) - vec))
    last_lamb_plans[:] = plans


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def _groups(names, params, states):
    """Leaves grouped by (weight dtype, state dtypes, state structure), in
    name order within a group."""
    groups: Dict[Any, list] = {}
    for n in names:
        key = (params[n].dtype, tuple(s.dtype for s in states[n]),
               len(states[n]))
        groups.setdefault(key, []).append(n)
    return list(groups.values())


def apply_updates(optimizer, params: Dict[str, Any], grads: Dict[str, Any],
                  states: Dict[str, Any], hp: Dict[str, Any], skip=None,
                  use_kernel: bool = False
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One optimizer step over name-keyed trees: params/grads ``{name:
    tensor}``, states ``{name: tuple of tensors}`` from
    ``optimizer.create_state``; hp the scalar dict (lr, wd, rescale_grad,
    clip_gradient, t; numbers or f32 device scalars); skip an optional
    bool tensor — True keeps every weight and state bit-exactly.  Returns
    (new params, new states): new tensors on the reference route, the
    updated inputs themselves on the kernel route (see the module
    docstring)."""
    names = sorted(params)
    if not use_kernel or not kernel_supported(optimizer) or not names:
        out_p, out_s = {}, {}
        for n in names:
            out_p[n], out_s[n] = _reference_leaf(
                optimizer, params[n], grads[n], tuple(states[n]), hp, skip)
        return out_p, out_s
    out_p = {n: params[n] for n in names}
    out_s = {n: tuple(states[n]) for n in names}
    dev = params[names[0]].device
    groups = [] if _is_lamb(optimizer) else _groups(names, params, out_s)
    chunks = [_group_chunk(gr, params) for gr in groups]
    if dev.type == "cpu":
        new_p, new_s = kernel_plain(optimizer, params, grads, out_s, hp,
                                    skip)
        with torch.no_grad():
            for n in names:
                params[n].copy_(new_p[n])
                for old, new in zip(out_s[n], new_s[n]):
                    old.copy_(new)
        return out_p, out_s
    if dev.type != "cuda":
        raise MXNetError(f"apply_updates runs on cuda or cpu, not {dev}")
    grads = {n: grads[n].contiguous() for n in names}
    keep, hptr = _device_hp(hp, skip, dev)
    if _is_lamb(optimizer):
        _lamb_cuda(optimizer, names, params, grads, out_s, hptr, dev)
    else:
        rule = _chunk_rule(optimizer)
        for group, chunk in zip(groups, chunks):
            _chunk_cuda(optimizer, rule, group, params, grads, out_s, hptr,
                        dev, chunk)
    del keep  # the launches are enqueued; stream order protects the memory
    return out_p, out_s


def kernel_plain(optimizer, params: Dict[str, Any], grads: Dict[str, Any],
                 states: Dict[str, Any], hp: Dict[str, Any], skip=None
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The kernels' plain version on any device: the kernel route's math
    leaf by leaf (LAMB's trust ratio in f32), returning new tensors.  What
    the CPU kernel route writes in place, and the oracle the card's
    kernels are held against."""
    out_p, out_s = {}, {}
    for n in sorted(params):
        out_p[n], out_s[n] = _reference_leaf(
            optimizer, params[n], grads[n], tuple(states[n]), hp, skip,
            kernel_math=True)
    return out_p, out_s


# ---------------------------------------------------------------------------
# autotune registration: the chunk kernel's elements per block
# ---------------------------------------------------------------------------

_TUNE_CHUNKS = (2048, 4096, 8192, 16384, 32768)


def _candidates(shapes, dtype):
    """Elements per block, bounded by the group's size."""
    total = shapes[0] if shapes else 1 << 20
    return [autotune.BlockConfig(chunk=c) for c in _TUNE_CHUNKS
            if c <= max(_TUNE_CHUNKS[0], total)]


def _roofline(config, shapes, dtype):
    """JAX's Adam count: w, g in the weight's dtype, m, v in f32 read; w,
    m, v written; one step per block."""
    total = shapes[0] if shapes else 1 << 20
    itemsize = 2 if "16" in str(dtype) else 4
    return {"flops": 18.0 * total,
            "bytes": total * (2 * itemsize + 4 * 2 + 4 * 3),
            "steps": float(max(1, -(-total // config.chunk)))}


def _build(config, shapes, dtype):
    """The trial launch: one Adam chunk launch over a seeded (total,) leaf
    in `dtype` with f32 moments, at ``config.chunk`` elements per block —
    the CUDA chunk kernel on the card (it counts in `kernels.LAUNCHES`),
    its plain version on the CPU.  Returns the thunk; each call updates
    the leaf in place."""
    total = shapes[0] if shapes else 1 << 20
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    dt = getattr(torch, autotune.dtype_name(dtype))
    gen = torch.Generator(device=dev).manual_seed(0)
    opt = Adam(learning_rate=1e-3)
    p = {"w": torch.randn(total, generator=gen, device=dev).to(dt)}
    g = {"w": torch.randn(total, generator=gen, device=dev).to(dt)}
    st = {"w": opt.create_state(p["w"], dtype=torch.float32)}
    hp = {k: torch.full((), v, dtype=torch.float32, device=dev)
          for k, v in (("lr", 1e-3), ("wd", 0.0), ("rescale_grad", 1.0),
                       ("t", 1.0))}
    hp["clip_gradient"] = None
    chunk = int(config.chunk)
    if dev.type == "cpu":
        def thunk():
            return apply_updates(opt, p, g, st, hp, use_kernel=True)
        return thunk
    keep, hptr = _device_hp(hp, None, dev)

    def thunk():
        _chunk_cuda(opt, _chunk_rule(opt), ["w"], p, g, st, hptr, dev,
                    chunk)
    thunk.keep = keep      # the device scalars live as long as the thunk
    return thunk


autotune.register_tunable("fused_optimizer", _candidates, _build, _roofline)
