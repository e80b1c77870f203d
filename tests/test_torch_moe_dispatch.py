"""Port parity: MoE dispatch and combine (mxnet_tpu_torch.ops.moe_dispatch)
against the JAX package's ``ops/pallas/moe_dispatch.py``.

Each route is held against JAX's own route for the same setting: the
port's kernel route on the CPU (the CUDA row gather's plain version,
`gather_rows_plain`) against JAX's Pallas gather in the interpreter
(``use_kernel=True`` under ``MXTPU_PALLAS_INTERPRET=1``), and the port's
reference route against JAX's ``use_kernel=False``, at JAX's test shapes
(T, E, C, H) = (53, 4, 6, 128) and (31, 3, 5, 64) with capacity overflow,
in f32 and bf16.  Tolerance: exact equality of the forward outputs — the
dispatch is a copy and the combine one multiply (f32 then a cast on the
kernel route, in the rows' dtype on the reference route) on both sides;
dropped tokens and empty slots exactly zero.  Gradients of x and the gate
against ``jax.grad`` of the same composite as JAX's kernel test: atol
1e-5 (f32 summation order of the gate's row dot).
"""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops.pallas import moe_dispatch as jmd

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import moe_dispatch as tmd

torch.set_num_threads(1)

SHAPES = [(53, 4, 6, 128), (31, 3, 5, 64)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _routing(t, e, c, seed):
    """Router-shaped assignments (JAX's test): pos is the arrival rank of
    the token within its expert; rank >= capacity drops."""
    rng = np.random.RandomState(seed)
    expert = rng.randint(0, e, t).astype(np.int32)
    pos = np.zeros(t, np.int64)
    seen = np.zeros(e, np.int64)
    for i, ex in enumerate(expert):
        pos[i] = seen[ex]
        seen[ex] += 1
    kept = pos < c
    return expert, np.where(kept, pos, 0).astype(np.int32), kept


def _inputs(t, e, c, h, dtype, seed=10):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, h).astype(np.float32)
    down = rng.randn(e, c, h).astype(np.float32)
    gate = rng.rand(t).astype(np.float32)
    if dtype == "bfloat16":      # start from bf16 values on both sides
        x = torch.from_numpy(x).bfloat16().float().numpy()
        down = torch.from_numpy(down).bfloat16().float().numpy()
    return x, down, gate, _routing(t, e, c, seed + 3)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not \
        isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("t,e,c,h", SHAPES)
def test_dispatch_and_combine_match_jax(interpret, t, e, c, h, use_kernel,
                                        dtype):
    x, down, gate, (expert, pos, kept) = _inputs(t, e, c, h, dtype)
    assert not kept.all(), "want capacity overflow in this test"
    jd = getattr(jnp, dtype)
    jbuf = jmd.moe_dispatch(jnp.asarray(x, jd), jnp.asarray(expert),
                            jnp.asarray(pos), jnp.asarray(kept), e, c,
                            use_kernel=use_kernel)
    jout = jmd.moe_combine(jnp.asarray(down, jd), jnp.asarray(expert),
                           jnp.asarray(pos), jnp.asarray(kept),
                           jnp.asarray(gate), use_kernel=use_kernel)
    td = getattr(torch, dtype)
    ex, ps, kp = (torch.from_numpy(a) for a in (expert, pos, kept))
    kernels.reset_launch_counts()
    tbuf = tmd.moe_dispatch(torch.from_numpy(x).to(td), ex, ps, kp, e, c,
                            use_kernel=use_kernel)
    tout = tmd.moe_combine(torch.from_numpy(down).to(td), ex, ps, kp,
                           torch.from_numpy(gate), use_kernel=use_kernel)
    # the CPU runs plain versions: no kernel launch is counted
    assert not any(kernels.launch_counts().values())
    assert tbuf.dtype == tout.dtype == td
    assert tbuf.shape == (e, c, h) and tout.shape == (t, h)
    np.testing.assert_array_equal(_np(tbuf), _np(jbuf))
    np.testing.assert_array_equal(_np(tout), _np(jout))
    # dropped tokens give exactly zero rows; so do the empty slots
    assert not np.any(_np(tout)[~kept])
    filled = np.zeros((e, c), bool)
    filled[expert[kept], pos[kept]] = True
    assert not np.any(_np(tbuf)[~filled])


def test_kernel_route_rounds_the_combine_like_the_tpu_kernel():
    """In bf16 the kernel route multiplies in f32 and then casts; the
    reference route multiplies in bf16 (two roundings).  The two routes
    differ on some elements, and each equals its own formula."""
    t, e, c, h = 53, 4, 6, 128
    _, down, gate, (expert, pos, kept) = _inputs(t, e, c, h, "bfloat16")
    d16 = torch.from_numpy(down).bfloat16()
    args = (torch.from_numpy(expert), torch.from_numpy(pos),
            torch.from_numpy(kept), torch.from_numpy(gate))
    k = tmd.moe_combine(d16, *args, use_kernel=True)
    r = tmd.moe_combine(d16, *args, use_kernel=False)
    slot = np.where(kept, expert * c + pos, e * c)
    rows = np.concatenate([down.reshape(e * c, h), np.zeros((1, h))])[slot]
    want_k = torch.from_numpy((rows * (gate * kept)[:, None]).astype(
        np.float32)).bfloat16()
    assert torch.equal(k, want_k)
    assert not torch.equal(k, r)


@pytest.mark.parametrize("t,e,c,h", [(24, 3, 4, 128), (31, 3, 5, 64)])
def test_gradients_match_jax(interpret, t, e, c, h):
    x, down_w, gate, (expert, pos, kept) = _inputs(t, e, c, h, "float32",
                                                   seed=14)
    je, jp, jk = (jnp.asarray(a) for a in (expert, pos, kept))
    jdw = jnp.asarray(down_w)

    def f_jax(xv, gv):
        buf = jmd.moe_dispatch(xv, je, jp, jk, e, c, use_kernel=True)
        out = jmd.moe_combine(buf * 0.5 + jdw, je, jp, jk, gv,
                              use_kernel=True)
        return jnp.sum(out ** 2)

    gx, gg = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(x),
                                             jnp.asarray(gate))
    te, tp, tk = (torch.from_numpy(a) for a in (expert, pos, kept))
    for use_kernel in (True, False):
        xv = torch.from_numpy(x).requires_grad_()
        gv = torch.from_numpy(gate).requires_grad_()
        buf = tmd.moe_dispatch(xv, te, tp, tk, e, c, use_kernel=use_kernel)
        out = tmd.moe_combine(buf * 0.5 + torch.from_numpy(down_w), te, tp,
                              tk, gv, use_kernel=use_kernel)
        (out ** 2).sum().backward()
        np.testing.assert_allclose(xv.grad.numpy(), np.asarray(gx),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gv.grad.numpy(), np.asarray(gg),
                                   rtol=1e-5, atol=1e-5)
        # a dropped token gets no gradient through the layer
        assert not np.any(gv.grad.numpy()[~kept])


def test_gather_plain_version_and_wrapper_checks():
    src = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([2, 4, 0, -1, 3], dtype=torch.int32)
    out = tmd.gather_rows(src, idx)
    want = torch.stack([src[2], torch.zeros(3), src[0], torch.zeros(3),
                        src[3]])
    assert torch.equal(out, want)
    sc = torch.tensor([2.0, float("inf"), 0.5, 1.0, 0.0])
    out = tmd.gather_rows(src.bfloat16(), idx, sc)
    # sentinel rows are exactly zero whatever their scale
    assert torch.equal(out[1], torch.zeros(3, dtype=torch.bfloat16))
    assert torch.equal(out[0], (src[2] * 2).bfloat16())
    with pytest.raises(MXNetError, match="cuda or cpu"):
        tmd.gather_rows(src.to("meta"), idx)
    assert tmd.kernel_eligible(64) and tmd.kernel_eligible(768)
    assert not tmd.kernel_eligible(200)
    assert tmd.kernel_eligible(768) == jmd.kernel_eligible(768)


@pytest.mark.parametrize("h", [64, 200])
def test_policy_picks_the_route(monkeypatch, h):
    """``use_kernel=None`` on the CPU: the reference under ``auto``, the
    kernel route under ``kernel`` only for an H that JAX's rule takes
    (200 is not a multiple of 128), as JAX's interpreter does."""
    t, e, c = 31, 3, 5
    x, _, _, (expert, pos, kept) = _inputs(t, e, c, h, "float32")
    args = (torch.from_numpy(x), torch.from_numpy(expert),
            torch.from_numpy(pos), torch.from_numpy(kept), e, c)
    calls = []
    monkeypatch.setattr(tmd._Dispatch, "apply",
                        lambda *a: calls.append("kernel") or
                        tmd.moe_dispatch_reference(*a))
    kernel = ["kernel"] if tmd.kernel_eligible(h) else []
    assert tmd.kernel_eligible(h) == jmd.kernel_eligible(h)
    for mode, want in (("auto", []), ("reference", []), ("off", []),
                       ("kernel", kernel)):
        monkeypatch.setenv("MXTPU_PALLAS", mode)
        calls.clear()
        tmd.moe_dispatch(*args)
        assert calls == want, mode


# ---------------------------------------------------------------------------
# the CUDA gather's launch plan (`_plan`), walked in plain Python
# ---------------------------------------------------------------------------

_CU = open(os.path.join(os.path.dirname(tmd.__file__), os.pardir, "csrc",
                        "moe_dispatch.cu")).read()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


def test_gather_plan_constants_are_the_kernels():
    assert _cu_const("WARPS") == tmd.WARPS
    assert _cu_const("MIN_BLOCKS") == tmd.MIN_BLOCKS
    assert _cu_const("UNITS") == tmd.UNITS
    assert _cu_const("MAX_DEPTH") == tmd.MAX_DEPTH
    assert "constexpr int CHUNK = THREADS;" in _CU
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in _CU


def _walk(plan, rows, nv):
    """How often the kernel's loops store each (row, piece): the rows its
    blocks, staged chunks and warps' groups of `depth` visit, times the
    pieces a lane's passes visit in each (the kernel's own loop bounds)."""
    warps, chunk = tmd.WARPS, 32 * tmd.WARPS
    d, p = plan.depth, plan.per_lane
    row_seen = np.zeros(rows, np.int64)
    for b in range(plan.grid):
        r0 = b * plan.rows_per_block
        r1 = min(rows, r0 + plan.rows_per_block)
        for c0 in range(r0, r1, chunk):
            cn = min(chunk, r1 - c0)
            for w in range(warps):
                for g in range(w * d, cn, warps * d):
                    for dd in range(d):
                        if g + dd < cn:
                            row_seen[c0 + g + dd] += 1
    piece_seen = np.zeros(nv, np.int64)
    for lane in range(32):
        for t in range(lane, nv, 32 * p):
            for k in range(p):
                if t + 32 * k < nv:
                    piece_seen[t + 32 * k] += 1
    return np.outer(row_seen, piece_seen)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("rows", [1, 53, 8192, 10240])
@pytest.mark.parametrize("h,itemsize,ptr", [(768, 2, 0), (768, 4, 0),
                                            (100, 2, 0), (100, 2, 200),
                                            (256, 4, 4), (3, 2, 2)])
def test_gather_plan_covers_every_row_once_in_one_wave(rows, sms, h,
                                                       itemsize, ptr):
    """The grid is at most one resident wave, and the kernel's walk stores
    every piece of every row exactly once, at widths that take 16-byte
    pieces (768) and widths or base pointers that take 8, 4 or 2."""
    piece = tmd._piece(h, itemsize, 0, ptr)
    assert (h * itemsize) % piece == 0 and ptr % piece == 0
    assert piece >= itemsize
    plan = tmd._plan(rows, h, itemsize, piece, sms)
    assert plan.piece == piece
    assert plan.grid <= sms * tmd.MIN_BLOCKS
    assert (plan.grid - 1) * plan.rows_per_block < rows <= \
        plan.grid * plan.rows_per_block
    assert plan.per_lane in (1, 2, 4)
    assert plan.depth >= 2 and plan.depth * plan.per_lane <= tmd.UNITS
    nv = h * itemsize // piece
    if nv <= 32 * tmd.MAX_PER_LANE:
        assert 32 * plan.per_lane >= nv     # a row in one pass
    else:
        assert plan.per_lane == 2           # wider: 4 rows in flight
    seen = _walk(plan, rows, nv)
    assert (seen == 1).all()


def test_gather_plan_pieces():
    """The widest piece the row bytes and both pointers allow."""
    assert tmd._piece(768, 2, 0, 256) == 16
    assert tmd._piece(768, 2, 8, 256) == 8
    assert tmd._piece(100, 2, 0, 0) == 8       # 200-byte rows
    assert tmd._piece(101, 2, 0, 0) == 2
    assert tmd._piece(3, 4, 0, 0) == 4
    assert tmd._piece(6, 4, 0, 0) == 8
