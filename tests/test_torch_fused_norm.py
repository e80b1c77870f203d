"""Port parity: the fused LayerNorm / RMSNorm (mxnet_tpu_torch.ops.fused_norm)
against the JAX package's ``ops/pallas/fused_norm.py``.

The port's kernel route (``MXTPU_PALLAS=kernel``: on the CPU, the CUDA
kernel's plain version) is held against JAX's kernel route run in the
Pallas interpreter (``use_kernel=True`` under ``MXTPU_PALLAS_INTERPRET=1``),
at the JAX kernel test's shapes; the reference routes against each other.
Tolerances: atol 1e-5 in f32 and 3e-2 in bf16 on the outputs (the JAX
kernel test's own, ``tests/unittest/test_pallas_kernels.py``; bf16 outputs
of magnitude up to 4 round in steps of 1/64), 1e-4 on the gradients (f32
summation order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import numpy_extension as npx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops.pallas import fused_norm as jfn

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.ops import fused_norm as tfn
from mxnet_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

SHAPES = [(5, 37), (9, 200), (64, 256)]
ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "kernel")
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _inputs(rows, h, dtype, pdtype=None, seed=1):
    """x, residual, gamma, beta as numpy f32 (the values both sides get)."""
    rng = np.random.RandomState(seed)
    x, res = rng.randn(rows, h), rng.randn(rows, h)
    g, b = rng.rand(h) + 0.5, rng.randn(h)
    arrs = [a.astype(np.float32) for a in (x, res, g, b)]
    pdtype = pdtype or dtype
    return arrs, (dtype, dtype, pdtype, pdtype)


def _both(arrs, dtypes):
    j = [jnp.asarray(a, getattr(jnp, d)) for a, d in zip(arrs, dtypes)]
    t = [torch.from_numpy(a).to(getattr(torch, d)) for a, d in zip(arrs,
                                                                    dtypes)]
    return j, t


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().detach().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("rows,h", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_route_matches_jax_kernel(kernel_route, rows, h, dtype):
    arrs, dts = _inputs(rows, h, dtype)
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _both(arrs, dts)
    atol = ATOL[dtype]
    pairs = [
        (tfn.fused_layer_norm(tx, tg, tb),
         jfn.fused_layer_norm(jx, jg, jb, use_kernel=True)),
        (tfn.fused_rms_norm(tx, tg),
         jfn.fused_rms_norm(jx, jg, use_kernel=True))]
    for tout, jout in ((tfn.layer_norm_residual(tx, tr, tg, tb),
                        jfn.layer_norm_residual(jx, jr, jg, jb,
                                                use_kernel=True)),
                       (tfn.rms_norm_residual(tx, tr, tg),
                        jfn.rms_norm_residual(jx, jr, jg, use_kernel=True))):
        pairs += list(zip(tout, jout))
    for t, j in pairs:
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        _close(t, j, atol)


@pytest.mark.parametrize("rows,h", SHAPES)
def test_reference_route_matches_jax_reference(rows, h):
    """f32 only: in bf16 this route rounds its statistics to bf16 at
    places that differ between the two frameworks."""
    arrs, dts = _inputs(rows, h, "float32", seed=2)
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _both(arrs, dts)
    atol = ATOL["float32"]
    _close(tfn.fused_layer_norm(tx, tg, tb, use_kernel=False),
           jfn.layer_norm_reference(jx, jg, jb), atol)
    _close(tfn.fused_rms_norm(tx, tg, use_kernel=False),
           jfn.rms_norm_reference(jx, jg), atol)
    for t, j in zip(tfn.layer_norm_residual(tx, tr, tg, tb,
                                            use_kernel=False),
                    jfn.layer_norm_reference(jx, jg, jb, residual=jr)):
        _close(t, j, atol)


def test_output_dtypes_follow_the_route(monkeypatch):
    """bf16 x with f32 gamma and beta: x's dtype on the kernel route, the
    promoted f32 on the reference route — on both sides."""
    arrs, dts = _inputs(4, 32, "bfloat16", pdtype="float32")
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _both(arrs, dts)
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    for mode, want in (("kernel", "bfloat16"), ("reference", "float32")):
        monkeypatch.setenv("MXTPU_PALLAS", mode)
        j = jfn.fused_layer_norm(jx, jg, jb)
        t = tfn.fused_layer_norm(tx, tg, tb)
        assert str(j.dtype) == want
        assert t.dtype == getattr(torch, want)
        assert tnn.layer_norm(tx, tg, tb).dtype == getattr(torch, want)
        assert tnn.rms_norm(tx, tg).dtype == getattr(torch, want)
        _close(t, j, ATOL["bfloat16"])


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_gradients_match_jax_kernel_route(kernel_route, rms, residual):
    arrs, _ = _inputs(6, 40, "float32", seed=5)
    x, res, g, b = arrs
    b = 0.1 * b

    def jloss(xv, rv, gv, bv):
        if residual:
            y, s = (jfn.rms_norm_residual(xv, rv, gv, use_kernel=True) if rms
                    else jfn.layer_norm_residual(xv, rv, gv, bv,
                                                 use_kernel=True))
            return jnp.sum(y ** 2) + jnp.sum(s * 0.3)
        y = (jfn.fused_rms_norm(xv, gv, use_kernel=True) if rms
             else jfn.fused_layer_norm(xv, gv, bv, use_kernel=True))
        return jnp.sum(y ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                      (x, res, g, b)))
    tx, tr, tg, tb = (torch.from_numpy(a).requires_grad_()
                      for a in (x, res, g, b))
    if residual:
        y, s = (tfn.rms_norm_residual(tx, tr, tg) if rms
                else tfn.layer_norm_residual(tx, tr, tg, tb))
        loss = (y ** 2).sum() + (s * 0.3).sum()
    else:
        y = tfn.fused_rms_norm(tx, tg) if rms else \
            tfn.fused_layer_norm(tx, tg, tb)
        loss = (y ** 2).sum()
    loss.backward()
    for t, j in zip((tx, tr, tg, tb), want):
        got = np.zeros_like(np.asarray(j)) if t.grad is None else \
            t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(j), atol=1e-4, rtol=0)


def test_residual_variant_takes_a_cotangent_on_one_output(kernel_route):
    """Only y (or only s) reaching the loss: the other cotangent is None."""
    arrs, _ = _inputs(3, 16, "float32", seed=6)
    x, res, g, b = (torch.from_numpy(a).requires_grad_() for a in arrs)
    y, s = tfn.layer_norm_residual(x, res, g, b)
    y.sum().backward()
    assert torch.equal(x.grad, res.grad)
    x.grad = None
    y, s = tfn.layer_norm_residual(x, res, g, b)
    s.sum().backward()
    assert torch.allclose(x.grad, torch.ones_like(x))


def test_nn_entry_points_and_rmsnorm_match_npx():
    arrs, _ = _inputs(24, 32, "float32", seed=8)
    x, res, g, b = (a.reshape(4, 6, 32) if a.size == 768 else a
                    for a in arrs)
    jx, jr, jg, jb = map(jnp.asarray, (x, res, g, b))
    tx, tr, tg, tb = map(torch.from_numpy, (x, res, g, b))
    for t, j in zip(tnn.layer_norm_residual(tx, tr, tg, tb),
                    npx.layer_norm_residual(jx, jr, jg, jb)):
        _close(t, np.asarray(j), 1e-5)
    _close(tnn.rms_norm(tx, tg), npx.rms_norm(jx, jg), 1e-5)
    for t, j in zip(tnn.rms_norm_residual(tx, tr, tg),
                    npx.rms_norm_residual(jx, jr, jg)):
        _close(t, np.asarray(j), 1e-5)
    _close(tnn.layer_norm(tx, tg, tb), npx.layer_norm(jx, jg, jb), 1e-5)
    blk = jnn.RMSNorm(in_channels=32)
    blk.initialize()
    tblk = tgnn.RMSNorm(in_channels=32).initialize(device="cpu")
    _close(tblk(tx), blk(mx.np.array(x)).asnumpy(), 1e-5)
    for fn, args in ((tnn.rms_norm, (tx, tg)),
                     (tnn.layer_norm_residual, (tx, tr, tg, tb))):
        with pytest.raises(ValueError, match="last axis"):
            fn(*args, axis=0)


@pytest.mark.parametrize("axis", [0, 1, -2, -1])
def test_ops_layer_norm_over_any_axis_matches_npx(axis):
    rng = np.random.RandomState(11)
    x = rng.randn(4, 6, 32).astype(np.float32)
    h = x.shape[axis]
    g, b = rng.randn(h).astype(np.float32), rng.randn(h).astype(np.float32)
    got = tnn.layer_norm(*map(torch.from_numpy, (x, g, b)), axis=axis,
                         eps=1e-12)
    want = npx.layer_norm(*map(jnp.asarray, (x, g, b)), axis=axis, eps=1e-12)
    _close(got, want, 1e-5)


def test_layers_check_in_channels_and_swap_their_norm():
    ln = tgnn.LayerNorm(in_channels=8).initialize(device="cpu")
    rn = tgnn.RMSNorm(in_channels=8).initialize(device="cpu")
    for m in (ln, rn):
        with pytest.raises(MXNetError, match="expected 8"):
            m(torch.zeros(2, 7))
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    ln._norm = tfn.fused_layer_norm_reference
    rn._norm = tfn.fused_rms_norm_reference
    # the plain kernel route on any device and under any policy: x's dtype
    assert ln(x).dtype == rn(x).dtype == torch.bfloat16


def test_kernel_eligible_follows_the_policy(monkeypatch):
    x = torch.zeros(4, 8)
    monkeypatch.setenv("MXTPU_PALLAS", "kernel")
    assert tfn.kernel_eligible(x)
    assert not tfn.kernel_eligible(x, axis=0)
    assert not tfn.kernel_eligible(torch.zeros(8))
    assert not tfn.kernel_eligible(torch.zeros(4, 8, dtype=torch.float64))
    for mode in ("auto", "reference", "off"):
        monkeypatch.setenv("MXTPU_PALLAS", mode)
        assert not tfn.kernel_eligible(x)     # a CPU tensor


# ---------------------------------------------------------------------------
# the kernel's launch plan and JAX's block_rows tunable (no card needed)
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(8192, 768), (1280, 768), (37, 200), (3, 16384), (1, 1)]
BLOCK_ROWS = (8, 16, 32, 64, 128, 256, 512, 1024)


def _rows_covered(p, rows):
    """How often each row is normalised, as the kernel walks the grid: a
    "warp" block takes rows [b * block_rows, ...), its group g (warp w,
    group k of the warp) rows g, g + groups, ...; a "block" block every
    grid-th row."""
    count = np.zeros(rows, np.int64)
    if p.variant == "block":
        for b in range(p.grid):
            count[b::p.grid] += 1
        return count
    gpw = 32 // p.lanes
    groups = p.warps * gpw
    m = np.arange(groups)[:, None] + groups * np.arange(
        -(-p.block_rows // groups))[None, :]
    m = m[m < p.block_rows]
    r = (np.arange(p.grid)[:, None] * p.block_rows + m[None, :]).ravel()
    np.add.at(count, r[r < rows], 1)
    return count


def _elements_covered(p, h):
    """How often each element of a row is held: thread slot s of the row
    (lane of its group, or the block's thread) holds vectors
    t * lanes * nv + k * lanes + s, each of `vec` elements."""
    count = np.zeros(h, np.int64)
    nvec = h // p.vec
    for t in range(p.tiles):
        for k in range(p.nv):
            q = t * p.lanes * p.nv + k * p.lanes + np.arange(p.lanes)
            q = q[q < nvec]
            e = (q[:, None] * p.vec + np.arange(p.vec)[None, :]).ravel()
            np.add.at(count, e, 1)
    return count


@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
@pytest.mark.parametrize("rows,h", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_is_a_legal_launch_covering_each_row_once(block_rows, rows, h,
                                                       dtype, aligned):
    p = tfn._plan(rows, h, dtype, torch.float32, block_rows, 132, aligned)
    item = torch.finfo(dtype).bits // 8
    threads = 32 * p.warps
    # what `mxt_fused_norm` accepts (csrc/fused_norm.cu)
    assert p.vec == 1 or (p.vec * item == 16 and aligned
                          and (h * item) % 16 == 0)
    assert h % p.vec == 0 and 1 <= p.nv and p.nv * p.vec <= p.elems
    assert p.grid >= 1 and p.tiles >= 1
    if p.variant == "warp":
        assert p.lanes in (1, 2, 4, 8, 16, 32) and threads <= 256
        assert p.elems in tfn.WARP_ELEMS and p.tiles == 1
        assert p.lanes * p.nv * p.vec >= h
        assert p.block_rows == block_rows
        assert p.grid * p.block_rows >= rows
        assert p.rows_warp * p.warps >= block_rows
    else:
        assert p.lanes == threads <= tfn.BLOCK_THREADS
        assert p.elems == tfn.BLOCK_ELEMS and threads % 32 == 0
        assert p.tiles * threads * p.nv * p.vec >= h
        assert p.grid <= rows
    if h * item <= 32 * tfn.WARP_ELEMS[-1] * item and \
            -(-h // (32 * p.vec)) * p.vec <= 32:
        assert p.variant == "warp"
    if (rows, h) == (3, 16384):
        # the wide row stays in registers: one tile, read once
        assert p.variant == "block" and p.tiles == 1
    assert (_rows_covered(p, rows) == 1).all()
    assert (_elements_covered(p, h) == 1).all()


def test_plan_widths_and_memo(monkeypatch):
    """16-byte loads only where the row and the pointers allow; the plan is
    memoised per key and tuner generation, with its source."""
    p = tfn._plan(8192, 768, torch.bfloat16, torch.float32, 32, 132, True)
    assert (p.variant, p.vec, p.lanes, p.nv) == ("warp", 8, 32, 3)
    p = tfn._plan(8192, 768, torch.float32, torch.float32, 32, 132, True)
    assert (p.vec, p.nv) == (4, 6)
    assert tfn._plan(8, 200, "bfloat16", torch.float32, 8, 132,
                     False).vec == 1
    assert tfn._plan(8, 100, torch.bfloat16, torch.float32, 8, 132,
                     True).vec == 1     # 200 bytes: not a multiple of 16
    x = torch.zeros(4 * 768 + 1)
    assert tfn._aligned(x[:768]) and not tfn._aligned(x[1:769])
    monkeypatch.setattr(tfn._kernels, "sm_count", lambda d: 132)
    monkeypatch.delenv("MXTPU_AUTOTUNE_CACHE", raising=False)
    tfn.autotune.clear_memory_cache()
    a = tfn._planned(8192, 768, torch.bfloat16, torch.float32, "cpu", True)
    assert a.source == "default" and a.block_rows == 32
    small = tfn._planned(1280, 768, torch.bfloat16, torch.float32, "cpu",
                         True)
    assert (small.block_rows, small.grid) == (8, 160)   # a block an SM
    assert tfn._planned(8192, 768, torch.bfloat16, torch.float32, "cpu",
                        True) is a
    b = tfn._planned(8192, 768, torch.bfloat16, torch.float32, "cpu", True,
                     block_rows=64)
    assert (b.source, b.block_rows, b.grid) == ("explicit", 64, 128)


def test_default_block_rows_gives_every_sm_a_block():
    assert [tfn.default_block_rows(r, 132) for r in
            (8192, 4193, 4192, 2097, 2096, 1280, 37, 1)] == [
                32, 32, 16, 16, 8, 8, 8, 8]
    assert tfn.default_block_rows(8192, 300) == 16


@pytest.mark.parametrize("shapes", [(8192, 768), (1280, 768), (37, 200),
                                    (3, 16384), (1, 1), (2, 64), ()])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tunable_matches_jax(shapes, dtype):
    want = jfn._candidates(shapes, dtype)
    got = tfn._candidates(shapes, dtype)
    assert [dict(c) for c in got] == [dict(c) for c in want]
    for c in got:
        assert tfn._roofline(c, shapes, dtype) == jfn._roofline(
            c, shapes, dtype)


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    from mxnet_tpu_torch.ops import autotune as at
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("MXTPU_AUTOTUNE", raising=False)
    at.clear_memory_cache()
    yield tmp_path
    at.clear_memory_cache()


@pytest.mark.parametrize("kept,want", [(64, 64), (2048, 1024), (4, 8)])
def test_resolve_block_rows_precedence(tune_cache, monkeypatch, kept, want):
    """The argument, then the tuned config clamped to [8, 1024] (JAX's
    `_default_block_rows`), then the card's default."""
    import json
    from mxnet_tpu_torch.ops import autotune as at
    monkeypatch.setattr(tfn._kernels, "sm_count", lambda d: 132)
    assert tfn.resolve_block_rows(8192, 768, torch.bfloat16) == 32
    key = at._key("fused_norm", (8192, 768), "bfloat16", "cpu")
    (tune_cache / "autotune_fused_norm.json").write_text(json.dumps(
        {key: {"config": {"block_rows": kept}}}))
    at.clear_memory_cache()
    assert tfn.resolve_block_rows(8192, 768, torch.bfloat16) == want
    assert tfn.resolve_block_rows(8000, 700, "bfloat16") == want  # bucket
    assert tfn.resolve_block_rows(8192, 768, torch.float32) == 32
    assert tfn.resolve_block_rows(8192, 768, torch.bfloat16, 16) == 16
    p = tfn._planned(8192, 768, torch.bfloat16, torch.float32, "cpu", True)
    assert (p.source, p.block_rows) == ("tuned", want)


def test_cold_tune_on_the_cpu_times_the_plain_version(tune_cache):
    """On the CPU the trials run `norm_plain` (no launch counted); a warm
    call is a hit with 0 trials and the wrappers pick the kept rows up."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import autotune as at
    assert "fused_norm" in at.tunables()
    kernels.reset_launch_counts()
    n = len(tfn._candidates((64, 32), "float32"))
    cold = at.tune("fused_norm", (64, 32), "float32", runs=1, top_k=n)
    assert not cold.cache_hit and cold.trials == n == 5     # 8 to 128
    assert not any(kernels.launch_counts().values())
    warm = at.tune("fused_norm", (64, 32), "float32")
    assert warm.cache_hit and warm.trials == 0
    assert tfn.resolve_block_rows(64, 32, torch.float32) == \
        cold.config.block_rows
