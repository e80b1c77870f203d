"""Optimizer update over a whole parameter tree: the multi-tensor CUDA
kernels and their plain versions (counterpart of
``mxnet_tpu/ops/pallas/fused_optimizer.py``).

`apply_updates` has two routes, as in the JAX package:

- ``use_kernel=False`` (the reference route) runs the optimizer's
  elementwise `_rule` leaf by leaf (`_reference_leaf`), casts the new
  weight and state back to their stored dtypes and returns new tensors; a
  `skip` flag turns the whole update into the identity.
- ``use_kernel=True`` (the kernel route, for the rules `kernel_supported`
  names) updates weights and state **in place** and returns the same
  tensors — the port updates in place where JAX returns new arrays, which
  saves a second copy of the weights and the optimizer state and the
  copy back.  On a CUDA tensor it launches ``csrc/fused_optimizer.cu``:
  for Adam, AdamW and SGD one chunk-kernel launch per group of leaves
  with the same (weight dtype, state dtypes, state structure), over a
  device table of per-leaf pointers (no packing copy); for LAMB two
  launches per tensor (phase A: moments, the update direction r and the
  trust ratio from deterministically reduced norms; phase B: the bounded
  update).  The hyperparameters and the skip flag stay on the device.  On
  a CPU tensor it runs the kernels' plain version, `_reference_leaf` (the
  same math, the same order of operations), and writes the results in
  place.

`kernel_route` applies the policy of `ops.policy` (``MXTPU_PALLAS``).  Any
other fused-safe rule takes the per-leaf reference route on either
setting (ROADMAP.md lists them).
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .. import kernels as _kernels
from ..optimizer import LAMB, SGD, Adam, AdamW
from .policy import kernel_active

__all__ = ["apply_updates", "supported", "kernel_supported", "kernel_route"]

CHUNK = 8192           # elements of one leaf per block of the chunk kernel
LAMB_BLOCKS = 1024     # most blocks (partials) of a LAMB phase-A launch
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# support predicates
# ---------------------------------------------------------------------------

def _chunk_rule(optimizer) -> int:
    """The chunk kernel's rule code for `optimizer`, or -1."""
    kind = type(optimizer)
    if kind is Adam:
        return 0
    if kind is AdamW:
        return 1
    if kind is SGD:
        return 3 if optimizer.momentum != 0.0 else 2
    return -1


def _is_lamb(optimizer) -> bool:
    return type(optimizer) is LAMB


def supported(optimizer) -> bool:
    """Can `apply_updates` run this optimizer at all (a pure rule)?"""
    return bool(getattr(optimizer, "fused_safe", True))


def kernel_supported(optimizer) -> bool:
    """Do the CUDA kernels write this optimizer's math out?  Adam, AdamW
    and SGD (the chunk kernel) and LAMB (phases A and B)."""
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


def _reference_leaf(optimizer, w, g, s_old, hp, skip):
    # the hyperparameters are f32 tensors; in JAX they promote a 16-bit
    # leaf's update math to f32 (torch's 0-dim tensors would not), so the
    # rule runs on f32 views of the weight and gradient
    dt = torch.promote_types(w.dtype, torch.float32)
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
_L = ctypes.c_longlong
_SIGS = {"mxt_fused_chunk": [_P, _I, _I, _I, _I, _I, _I] + [_F] * 6
         + [_I] + [_P] * 7,
         "mxt_lamb_phase_a": [_P] * 8 + [_L, _I, _I, _I] + [_F] * 5
         + [_I, _F, _F, _I, _I] + [_P] * 7,
         "mxt_lamb_phase_b": [_P, _P, _P, _L, _I, _P, _P, _P]}
_fns = {}


def _kernel_fn(name):
    f = _fns.get(name)
    if f is None:
        f = getattr(_kernels.load("fused_optimizer"), name)
        f.argtypes = _SIGS[name]
        f.restype = _I
        _fns[name] = f
    return f


def _launched(name, err, counter):
    if err:
        raise MXNetError(f"{name} kernel launch failed (cudaError_t {err})")
    _kernels.LAUNCHES[counter] += 1


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
            raise MXNetError(f"{name}: the optimizer kernels take float32 "
                             f"or bfloat16 tensors, {what} is {t.dtype}")
        if t.shape != w.shape:
            raise MXNetError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"weight {tuple(w.shape)}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: the optimizer kernels need a "
                             f"contiguous {what}")


def _chunk_cuda(optimizer, rule, names, params, grads, states, hptr, dev):
    """One chunk-kernel launch over `names` (one dtype group), in place."""
    n_state = len(states[names[0]])
    leaves, blocks = [], []
    for i, n in enumerate(names):
        w, g, st = params[n], grads[n], states[n]
        _check_leaf(n, w, g, st, dev)
        ptr = [s.data_ptr() for s in st] + [0] * (2 - n_state)
        leaves.append([w.data_ptr(), g.data_ptr(), *ptr, w.numel()])
        nchunk = -(-w.numel() // CHUNK)
        blocks.append((i << 32) | np.arange(nchunk, dtype=np.int64))
    table = np.concatenate([np.asarray(leaves, np.int64).ravel()] + blocks)
    n_blocks = table.size - 5 * len(names)
    if n_blocks == 0:
        return
    # pinned and asynchronous: no host sync; the caching host allocator
    # keeps the staging buffer until the copy has run, and the device
    # table's memory is reused only by work queued after the kernel on
    # this stream
    dev_table = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
    w0, s = params[names[0]], states[names[0]]
    o = optimizer
    b1, b2 = getattr(o, "beta1", 0.0), getattr(o, "beta2", 0.0)
    err = _kernel_fn("mxt_fused_chunk")(
        dev_table.data_ptr(), len(names), n_blocks, CHUNK, rule,
        _DTYPES[w0.dtype], _DTYPES[s[0].dtype] if s else 0, b1, b2,
        getattr(o, "epsilon", 0.0), 1 - b1, 1 - b2,
        getattr(o, "momentum", 0.0), int(getattr(o, "correct_bias", True)),
        *hptr, torch.cuda.current_stream(dev).cuda_stream)
    _launched("fused_optimizer chunk", err, "fused_optimizer_chunk")


def _lamb_cuda(optimizer, names, params, grads, states, hptr, dev):
    """Two launches per tensor, in place: phase A, then phase B."""
    o = optimizer
    for n in names:
        _check_leaf(n, params[n], grads[n], states[n], dev)
        if len(states[n]) != 2:
            raise MXNetError(f"{n}: LAMB state must be (m, v)")
    numels = [params[n].numel() for n in names]
    r = torch.empty(max(numels, default=0), dtype=torch.float32, device=dev)
    part = torch.empty(2 * LAMB_BLOCKS, dtype=torch.float32, device=dev)
    ratio = torch.empty(len(names), dtype=torch.float32, device=dev)
    # phase A's ticket counter: zeroed here, reset by each launch's last
    # block for the next tensor
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lo, hi = o.lower_bound, o.upper_bound
    phase_a, phase_b = (_kernel_fn("mxt_lamb_phase_a"),
                        _kernel_fn("mxt_lamb_phase_b"))
    for i, n in enumerate(names):
        w, g, (m, v) = params[n], grads[n], states[n]
        numel = numels[i]
        if numel == 0:
            continue
        nb = min(LAMB_BLOCKS, -(-numel // 2048))
        rp = ratio[i:i + 1].data_ptr()
        err = phase_a(
            w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            r.data_ptr(), part.data_ptr(), counter.data_ptr(), rp, numel, nb,
            _DTYPES[w.dtype], _DTYPES[m.dtype], o.beta1, o.beta2, o.epsilon,
            1 - o.beta1, 1 - o.beta2, int(o.bias_correction),
            0.0 if lo is None else lo, 0.0 if hi is None else hi,
            int(lo is not None), int(hi is not None), *hptr, stream)
        _launched("LAMB phase A", err, "lamb_phase_a")
        err = phase_b(w.data_ptr(), r.data_ptr(), rp, numel,
                      _DTYPES[w.dtype], hptr[0], hptr[5], stream)
        _launched("LAMB phase B", err, "lamb_phase_b")


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
    if dev.type == "cpu":
        with torch.no_grad():
            for n in names:
                nw, ns = _reference_leaf(optimizer, params[n], grads[n],
                                         out_s[n], hp, skip)
                params[n].copy_(nw)
                for old, new in zip(out_s[n], ns):
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
        for group in _groups(names, params, out_s):
            _chunk_cuda(optimizer, rule, group, params, grads, out_s, hptr,
                        dev)
    del keep  # the launches are enqueued; stream order protects the memory
    return out_p, out_s
