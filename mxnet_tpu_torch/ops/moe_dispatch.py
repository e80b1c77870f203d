"""Blockwise MoE dispatch and combine: a CUDA row gather + plain torch
(counterpart of ``mxnet_tpu/ops/pallas/moe_dispatch.py``).

`parallel.switch_moe`'s dense formulation builds a one-hot dispatch tensor
``disp (T, E, C)`` and contracts it twice — O(T·E·C·H) work for what is a
permutation: every kept token lands in exactly one (expert, slot) capacity
cell.  This module moves the rows directly:

- **dispatch** inverts the token -> slot map on the slot side (a small
  int32 scatter), then gathers each of the E·C capacity rows from its
  source token; empty slots come out zero.
- **combine** gathers each token's expert-output row by its slot and
  scales it by ``gate * kept`` in f32; dropped tokens come out zero, so
  the overflow semantics equal the dense einsums'.

Both are one gather, `gather_rows`: on a CUDA tensor it launches
``csrc/moe_dispatch.cu`` (or raises), on a CPU tensor it runs
`gather_rows_plain`, the kernel's plain version.  The kernel takes an
out-of-range index (the sentinel T for dispatch, E·C for combine) as a
zero row, so the (T+1, H) zero-padded copy the TPU kernel reads is never
made.  `_plan` is the kernel's launch plan in plain Python, memoised per
shape, piece and SM count: the load width, the rows a warp keeps in
flight, and a grid of at most one resident wave.  Gradients run through
two `torch.autograd.Function`s whose backward is the plain scatter/gather
transpose, as in JAX (no backward kernel).

Routes: `moe_dispatch` / `moe_combine` with ``use_kernel=None`` take the
kernel route when `ops.policy.kernel_active` says so, otherwise the
reference (`moe_dispatch_reference`, `moe_combine_reference`: an index_add
scatter and a gather).  On a CUDA tensor the policy alone decides, so the
card launches the kernel at any H; on a CPU tensor JAX's
`kernel_eligible(h)` also applies, so that one ``MXTPU_PALLAS`` setting
gives the same math as JAX's interpreter.  In bf16 the
two routes round the combine differently: the kernel multiplies in f32
and then casts, the reference multiplies in the rows' dtype, as JAX's do.
``MXTPU_PALLAS=off`` restores the dense einsums in `parallel.moe`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from .. import kernels as _kernels
from . import autotune
from .policy import kernel_active

LANES = 128

__all__ = ["moe_dispatch", "moe_combine", "moe_dispatch_reference",
           "moe_combine_reference", "kernel_eligible", "gather_rows",
           "gather_rows_plain", "dispatch_index", "combine_index"]


def _slots(expert, pos, kept, num_experts, capacity):
    """Flat capacity-cell index per token; dropped tokens map to the
    one-past-the-end cell E·C."""
    flat = expert.to(torch.int32) * capacity + pos.to(torch.int32)
    return torch.where(kept, flat, num_experts * capacity).to(torch.int32)


def dispatch_index(expert, pos, kept, num_experts, capacity):
    """The dispatch gather's rows: ``inv[s]`` = the token in capacity cell
    s, or T (the sentinel, a zero row) for an empty cell; (E·C,) int32.
    Dropped tokens all write the discarded cell E·C, so each kept cell is
    written exactly once and the result is deterministic on the card too
    (with no host sync, which a boolean mask of the kept tokens needs)."""
    t = expert.shape[0]
    slot = _slots(expert, pos, kept, num_experts, capacity)
    inv = torch.full((num_experts * capacity + 1,), t, dtype=torch.int32,
                     device=expert.device)
    inv.scatter_(0, slot.long(),
                 torch.arange(t, dtype=torch.int32, device=expert.device))
    return inv[:num_experts * capacity]


def combine_index(expert, pos, kept, gate, num_experts, capacity):
    """The combine gather's rows and scale: each token's cell (E·C, the
    sentinel, for a dropped token) and ``gate * kept`` in f32."""
    return (_slots(expert, pos, kept, num_experts, capacity),
            gate.float() * kept.float())


# ---------------------------------------------------------------------------
# the reference route
# ---------------------------------------------------------------------------

def moe_dispatch_reference(x, expert, pos, kept, num_experts, capacity):
    """Scatter tokens to their (expert, slot) cells.  x (T, H); expert,
    pos (T,) int; kept (T,) bool.  Returns (E, C, H) with empty cells
    exactly zero."""
    h = x.shape[1]
    slot = _slots(expert, pos, kept, num_experts, capacity)
    buf = torch.zeros((num_experts * capacity + 1, h), dtype=x.dtype,
                      device=x.device)
    buf.index_add_(0, slot.long(), x)   # kept cells are unique: add == set
    return buf[:num_experts * capacity].reshape(num_experts, capacity, h)


def moe_combine_reference(down, expert, pos, kept, gate):
    """Each token's expert-output row times ``gate * kept`` in down's
    dtype; dropped tokens give zero rows."""
    e, c, h = down.shape
    flat = torch.cat([down.reshape(e * c, h),
                      torch.zeros((1, h), dtype=down.dtype,
                                  device=down.device)])
    rows = flat[_slots(expert, pos, kept, e, c).long()]
    scale = gate.to(down.dtype) * kept.to(down.dtype)
    return rows * scale[:, None]


# ---------------------------------------------------------------------------
# the row gather: CUDA kernel (csrc/moe_dispatch.cu) and its plain version
# ---------------------------------------------------------------------------

def kernel_eligible(h: int) -> bool:
    """JAX's rule for the route: H slices (<= 128) or tiles (a multiple of
    128) into lane vectors.  The CUDA kernel takes any H, so only the CPU
    route applies it (`_kernel_route`), for parity with JAX's."""
    return h <= LANES or h % LANES == 0


def _kernel_route(x, h) -> bool:
    """``use_kernel=None``'s route: the policy, and on the CPU JAX's
    `kernel_eligible` too."""
    return kernel_active(x) and (x.device.type == "cuda" or
                                 kernel_eligible(h))


def gather_rows_plain(src, idx, scale=None):
    """The kernel's plain version: ``out[i] = src[idx[i]]``, or
    ``(src[idx[i]] in f32 * scale[i])`` cast to src's dtype, and a zero row
    where ``idx[i]`` is outside [0, len(src))."""
    n = src.shape[0]
    idx = idx.long()
    live = (idx >= 0) & (idx < n)
    rows = src[idx.clamp(0, n - 1)]
    if scale is not None:
        rows = (rows.float() * scale.float()[:, None]).to(src.dtype)
    return torch.where(live[:, None], rows, torch.zeros((), dtype=src.dtype,
                                                       device=src.device))


# the kernel's constants (csrc/moe_dispatch.cu), which the plan sizes by
WARPS = 8            # warps a block
MIN_BLOCKS = 4       # resident blocks an SM (__launch_bounds__)
UNITS = 8            # pieces a lane holds at once
MAX_DEPTH = 4        # rows a warp keeps in flight
MAX_PER_LANE = 4     # pieces a lane takes of a row a pass


class GatherPlan(NamedTuple):
    """One launch of the row gather."""
    piece: int           # bytes a load and a store (16, 8, 4 or 2)
    per_lane: int        # pieces a lane takes of a row a pass (1, 2, 4)
    depth: int           # rows a warp keeps in flight
    rows_per_block: int  # a block's contiguous run of rows
    grid: int            # blocks: at most one resident wave


def _piece(h: int, itemsize: int, *ptrs: int) -> int:
    """The widest piece (16, 8, 4 or 2 bytes; an element at least, as the
    row's bytes and every pointer are whole elements) that divides a row's
    bytes and every base pointer: the lowest set bit of their OR."""
    a = h * itemsize
    for q in ptrs:
        a |= q
    return min(16, a & -a)


@functools.lru_cache(maxsize=None)
def _plan(rows: int, h: int, itemsize: int, piece: int,
          sm_count: int) -> GatherPlan:
    """The launch for a (rows, h) gather, plain Python: a lane takes the
    fewest pieces a pass (1, 2 or 4) that cover a row in one pass; a row
    too wide for one pass of `MAX_PER_LANE` takes 2 a pass, so that 4 rows
    are in flight (f32 at H 768 gathered 4% faster so than with 4, bf16 no
    slower: `k47_profile.py --plans`).  A warp keeps ``min(MAX_DEPTH,
    UNITS // per_lane)`` rows in flight; each block takes a contiguous run
    of rows, and the grid is at most one resident wave (`MIN_BLOCKS`
    blocks an SM)."""
    nv = h * itemsize // piece
    need = -(-nv // 32)
    per_lane = 1 << max(0, (need - 1).bit_length()) \
        if need <= MAX_PER_LANE else 2
    depth = min(MAX_DEPTH, UNITS // per_lane)
    per_block = max(1, -(-rows // (sm_count * MIN_BLOCKS)))
    return GatherPlan(piece, per_lane, depth, per_block,
                      max(1, -(-rows // per_block)))


_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        f = _kernels.load("moe_dispatch").mxt_gather_rows
        f.argtypes = [_P] * 4 + [ctypes.c_longlong] + [_I] * 7 + [_P]
        f.restype = _I
        _fn = f
    return _fn


def _check_operands(src, idx, scale):
    """Raise on the first operand the kernel does not take."""
    if src.dtype not in _DTYPES:
        raise MXNetError(f"moe gather kernel takes float32, bfloat16 or "
                         f"float16 rows, got {src.dtype}")
    ops = [("src", src, None), ("idx", idx, torch.int32)]
    if scale is not None:
        ops.append(("scale", scale, torch.float32))
    for name, t, dt in ops:
        if dt is not None and t.dtype != dt:
            raise MXNetError(f"moe gather: {name} must be {dt}, got "
                             f"{t.dtype}")
        if t.device != src.device:
            raise MXNetError(f"moe gather: {name} is on {t.device}, src on "
                             f"{src.device}")
        if not t.is_contiguous():
            raise MXNetError(f"moe gather kernel needs a contiguous {name}")


def _gather_cuda(src, idx, scale, counter, plan=None):
    """Check the operands, then launch the gather on the current stream
    (`plan`, else `_plan` for this call)."""
    n, h = src.shape
    dev = src.device
    # one test for the common case; `_check_operands` names what is wrong
    if not (src.dtype in _DTYPES and idx.dtype == torch.int32 and
            idx.device == dev and src.is_contiguous() and
            idx.is_contiguous() and (scale is None or (
                scale.dtype == torch.float32 and scale.device == dev and
                scale.is_contiguous()))):
        _check_operands(src, idx, scale)
    rows = idx.shape[0]
    if idx.dim() != 1 or (scale is not None and scale.shape != (rows,)):
        raise MXNetError("moe gather: idx (rows,) and scale (rows,) expected")
    if rows >= 2 ** 31 or h >= 2 ** 31:
        raise MXNetError(f"moe gather kernel takes rows, h < 2**31; got "
                         f"{(rows, h)}")
    out = torch.empty((rows, h), dtype=src.dtype, device=dev)
    if rows and h:
        sp, op = src.data_ptr(), out.data_ptr()
        if plan is None:
            item = src.element_size()
            plan = _plan(rows, h, item, _piece(h, item, sp, op),
                         _kernels.sm_count(dev))
        err = _kernel_fn()(
            sp, idx.data_ptr(), None if scale is None else scale.data_ptr(),
            op, n, rows, h, _DTYPES[src.dtype], plan.piece, plan.per_lane,
            plan.rows_per_block, plan.grid,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise MXNetError(f"moe gather kernel launch failed (cudaError_t "
                             f"{err})")
        _kernels.LAUNCHES[counter] += 1
    return out


def gather_rows(src, idx, scale=None, counter="moe_dispatch"):
    """``out[i] = src[idx[i]]`` (times ``scale[i]`` in f32), zero rows for
    indices outside [0, len(src)).  src (N, H); idx (R,) int32; scale
    (R,) f32 or None.  A CUDA `src` launches the kernel (counted under
    `counter` in `kernels.LAUNCHES`) or raises; a CPU `src` runs
    `gather_rows_plain`."""
    if src.device.type == "cuda":
        return _gather_cuda(src, idx, scale, counter)
    if src.device.type != "cpu":
        raise MXNetError(f"moe gather runs on cuda or cpu, not {src.device}")
    return gather_rows_plain(src, idx, scale)


# ---------------------------------------------------------------------------
# autograd: the gather forward, the plain transpose backward
# ---------------------------------------------------------------------------

class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, expert, pos, kept, num_experts, capacity):
        h = x.shape[1]
        inv = dispatch_index(expert, pos, kept, num_experts, capacity)
        buf = gather_rows(x.contiguous(), inv, counter="moe_dispatch")
        ctx.save_for_backward(expert, pos, kept)
        return buf.reshape(num_experts, capacity, h)

    @staticmethod
    def backward(ctx, dbuf):
        expert, pos, kept = ctx.saved_tensors
        # the transpose of the scatter: each token's cell cotangent, in
        # dbuf's dtype (the buffer was built in x's)
        dx = moe_combine_reference(
            dbuf, expert, pos, kept,
            torch.ones(expert.shape, dtype=torch.float32,
                       device=dbuf.device))
        return dx, None, None, None, None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, down, expert, pos, kept, gate):
        e, c, h = down.shape
        slot, scale = combine_index(expert, pos, kept, gate, e, c)
        out = gather_rows(down.reshape(e * c, h).contiguous(), slot, scale,
                          counter="moe_combine")
        ctx.save_for_backward(down, expert, pos, kept, gate)
        return out

    @staticmethod
    def backward(ctx, dout):
        down, expert, pos, kept, gate = ctx.saved_tensors
        e, c, _ = down.shape
        scale = gate.to(dout.dtype) * kept.to(dout.dtype)
        # d(down): the scaled token cotangents scattered back to their cells
        ddown = moe_dispatch_reference(dout * scale[:, None], expert, pos,
                                       kept, e, c).to(down.dtype)
        # d(gate): the row dot of the gathered expert output and dout
        rows = moe_combine_reference(down, expert, pos, kept,
                                     torch.ones_like(gate))
        dgate = (rows.float() * dout.float()).sum(dim=-1)
        dgate = (dgate * kept.float()).to(gate.dtype)
        return ddown, None, None, None, dgate


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def moe_dispatch(x, expert, pos, kept, num_experts, capacity,
                 use_kernel=None):
    """Tokens (T, H) -> the (E, C, H) capacity buffer."""
    if use_kernel is None:
        use_kernel = _kernel_route(x, x.shape[1])
    if not use_kernel:
        return moe_dispatch_reference(x, expert, pos, kept, num_experts,
                                      capacity)
    return _Dispatch.apply(x, expert, pos, kept, num_experts, capacity)


def moe_combine(down, expert, pos, kept, gate, use_kernel=None):
    """(E, C, H) expert outputs -> (T, H) gated token rows."""
    if use_kernel is None:
        use_kernel = _kernel_route(down, down.shape[2])
    if not use_kernel:
        return moe_combine_reference(down, expert, pos, kept, gate)
    return _Combine.apply(down, expert, pos, kept, gate)


# ---------------------------------------------------------------------------
# autotune registration: no free block parameter (the plan follows from
# the shape and the card); the candidates are the kernel and the
# reference, so `tune()` can compare them and the cache records which won
# per shape bucket.  As in JAX,
# nothing on the path consults it.
# ---------------------------------------------------------------------------

def _candidates(shapes, dtype):
    return [autotune.BlockConfig(use_kernel=1),
            autotune.BlockConfig(use_kernel=0)]


def _roofline(config, shapes, dtype):
    t = shapes[0] if shapes else 4096
    e = shapes[1] if len(shapes) > 1 else 8
    c = shapes[2] if len(shapes) > 2 else 1024
    h = shapes[3] if len(shapes) > 3 else 1024
    itemsize = 2 if "16" in str(dtype) else 4
    if config.get("use_kernel"):
        return {"flops": 2.0 * t * h, "bytes": 2.0 * t * h * itemsize,
                "steps": float(t + e * c)}
    # the dense einsum pair: T·E·C·H multiply-adds each way
    return {"flops": 4.0 * t * e * c * h,
            "bytes": (2.0 * t * h + t * e * c) * itemsize,
            "steps": 2.0}


def _build(config, shapes, dtype):
    import numpy as np
    t = shapes[0] if shapes else 4096
    e = shapes[1] if len(shapes) > 1 else 8
    c = shapes[2] if len(shapes) > 2 else max(1, t // e)
    h = shapes[3] if len(shapes) > 3 else 1024
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(t, h).astype(np.float32)).to(
        dev, getattr(torch, autotune.dtype_name(dtype)))
    expert = torch.from_numpy(rng.randint(0, e, t).astype(np.int32)).to(dev)
    pos = torch.from_numpy(rng.randint(0, c, t).astype(np.int32)).to(dev)
    kept = torch.ones((t,), dtype=torch.bool, device=dev)
    use_k = bool(config.get("use_kernel"))

    def thunk():
        return moe_dispatch(x, expert, pos, kept, e, c, use_kernel=use_k)
    return thunk


autotune.register_tunable("moe_dispatch", _candidates, _build, _roofline)
