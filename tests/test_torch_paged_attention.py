"""Port parity: ragged paged attention (mxnet_tpu_torch.ops.paged_attention)
against the JAX package's reference and its Pallas kernel in interpret mode.

The same numpy inputs (from a seed) go through both packages.  Tolerance:
atol/rtol 1e-5 in float32 — both sides compute the same f32 arithmetic and
differ only in summation order.  Only valid rows (chunk rows below a slot's
token count) are compared: padded rows are garbage by contract.  Over an
int8 pool (the JAX package's `quantize_kv` planes and scales handed to
both) the references agree within 1e-5 of the output's scale; over an f16
pool within 1e-5 of it under f32 queries and 5e-3 under f16 queries (p
and the products round to f16).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops.pallas import paged_attention as jpa

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, H, Hkv, C, D, ps, npages, maxp, start, nt):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, C, D).astype(np.float32)
    kp = rng.randn(npages, ps, Hkv, D).astype(np.float32)
    vp = rng.randn(npages, ps, Hkv, D).astype(np.float32)
    # distinct physical pages per slot, shuffled (non-contiguous layout)
    pt = (rng.permutation(npages - 1)[:B * maxp] + 1).reshape(B, maxp)
    start = np.asarray(start, np.int32)
    nt = np.asarray(nt, np.int32)
    ctx = (start + nt).astype(np.int32)
    return q, kp, vp, pt.astype(np.int32), ctx, start, nt


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _assert_valid_rows(out, ref, nt):
    out, ref = np.asarray(out), np.asarray(ref)
    for b, n in enumerate(nt):
        np.testing.assert_allclose(out[b, :, :n], ref[b, :, :n], **TOL)


# slot 0 prefills from 0, slot 1 sits mid-context at a non-page-aligned
# length, slot 2 decodes deep in, slot 3 is empty (ctx = 0)
CASES = [pytest.param(C, H, Hkv, window, id=f"C{C}-H{H}kv{Hkv}-w{window}")
         for C in (1, 8) for (H, Hkv) in ((4, 4), (4, 2), (4, 1))
         for window in (None, 3)]


@pytest.mark.parametrize("C,H,Hkv,window", CASES)
def test_reference_matches_jax_reference(C, H, Hkv, window):
    B, D, ps, npages, maxp = 4, 16, 8, 24, 5
    start = [0, 13, 29, 0]
    nt = [C, max(1, C - 3), 1, 0]
    q, kp, vp, pt, ctx, st, nt = _inputs(0, B, H, Hkv, C, D, ps, npages,
                                         maxp, start, nt)
    ref = jpa.paged_attention_reference(*_jax(q, kp, vp, pt, ctx, st),
                                        window=window)
    out = tpa.paged_attention_reference(*_torch(q, kp, vp, pt, ctx, st),
                                        window=window)
    _assert_valid_rows(out, ref, nt)


@pytest.mark.parametrize("C,H,Hkv,window", CASES)
def test_dispatcher_matches_pallas_kernel_interpret(C, H, Hkv, window,
                                                    monkeypatch):
    """The port's CPU dispatch against the exact Pallas kernel code (run in
    interpret mode, page size 8 as the JAX serve tests run it)."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    B, D, ps, npages, maxp = 4, 16, 8, 24, 5
    start = [0, 13, 29, 0]
    nt = [C, max(1, C - 3), 1, 0]
    q, kp, vp, pt, ctx, st, nt = _inputs(1, B, H, Hkv, C, D, ps, npages,
                                         maxp, start, nt)
    ref = jpa.ragged_paged_attention(*_jax(q, kp, vp, pt, ctx, st),
                                     window=window, use_kernel=True)
    kernels.reset_launch_counts()
    out = tpa.ragged_paged_attention(*_torch(q, kp, vp, pt, ctx, st),
                                     window=window)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert kernels.launch_counts()["ragged_paged_attention"] == 0
    _assert_valid_rows(out, ref, nt)


# head widths the card's kernel takes since it pads rows to 16 columns in
# shared memory: 24 and 72 (JAX's kernel takes any D <= 128) and Gemma 2B's
# 256 (JAX's kernel takes multiples of 128); MQA decode as Gemma 2B serves
# it (8 heads over 1), GPT-2-d256's 3 over 1, and a GQA prefill chunk
@pytest.mark.parametrize("D", [24, 72, 256])
@pytest.mark.parametrize("C,H,Hkv,window", [(1, 8, 1, None),
                                             (8, 3, 1, None), (8, 4, 2, 3)])
def test_dispatcher_at_any_head_width_matches_pallas_kernel_interpret(
        D, C, H, Hkv, window, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    B, ps, npages, maxp = 4, 8, 24, 5
    start = [0, 13, 29, 0]
    nt = [C, max(1, C - 3), 1, 0]
    q, kp, vp, pt, ctx, st, nt = _inputs(5, B, H, Hkv, C, D, ps, npages,
                                         maxp, start, nt)
    ref = jpa.ragged_paged_attention(*_jax(q, kp, vp, pt, ctx, st),
                                     window=window, use_kernel=True)
    out = tpa.ragged_paged_attention(*_torch(q, kp, vp, pt, ctx, st),
                                     window=window)
    _assert_valid_rows(out, ref, nt)


@pytest.mark.parametrize("C,window", [(1, None), (4, None), (4, 2)])
def test_dense_attend_matches_jax(C, window):
    """The dense-cache attention `generate` uses (no ctx_len)."""
    rng = np.random.RandomState(2)
    B, H, Hkv, T, D = 2, 4, 2, 12, 16
    q = rng.randn(B, H, C, D).astype(np.float32)
    kc = rng.randn(B, Hkv, T, D).astype(np.float32)
    vc = rng.randn(B, Hkv, T, D).astype(np.float32)
    pos = (np.array([[5], [9]]) + np.arange(C)[None]).astype(np.int32)
    ref = jpa._dense_attend(*_jax(q, kc, vc, pos), window=window)
    out = tpa._dense_attend(*_torch(q, kc, vc, pos), window=window)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **TOL)


def test_gather_pages_matches_jax():
    rng = np.random.RandomState(3)
    pool = rng.randn(9, 4, 2, 8).astype(np.float32)
    pt = rng.randint(0, 9, (3, 2)).astype(np.int32)
    ref = jpa.gather_pages(jnp.asarray(pool), jnp.asarray(pt))
    out = tpa.gather_pages(*_torch(pool, pt))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_empty_slot_and_padded_context_are_exact():
    """A ctx=0 slot's valid rows do not exist; a context padded with
    extra (unread) pages gives the bit-identical result."""
    B, H, Hkv, C, D, ps = 2, 4, 2, 1, 16, 8
    q, kp, vp, pt, ctx, st, nt = _inputs(4, B, H, Hkv, C, D, ps, 12, 3,
                                         [10, 0], [1, 1])
    a = tpa.ragged_paged_attention(*_torch(q, kp, vp, pt, ctx, st))
    pt_long = np.concatenate([pt, pt[:, :1]], axis=1)
    b = tpa.ragged_paged_attention(*_torch(q, kp, vp, pt_long, ctx, st))
    assert torch.equal(a, b)
    assert torch.isfinite(a).all()


def _int8_pools(kp, vp):
    """JAX's int8 planes and scales of two f32 pools (numpy)."""
    from mxnet_tpu.contrib.quantization import quantize_kv
    out = []
    for pool in (kp, vp):
        q, sc = quantize_kv(jnp.asarray(pool))
        out += [np.asarray(q), np.asarray(sc)]
    return out


# C 1 (decode), 5 (the verification width), 16 (the prefill chunk); MHA
# and GQA; with and without a window; D 24, 64 and Gemma 2B's 256
INT8_CASES = [pytest.param(C, H, Hkv, window, D,
                           id=f"C{C}-H{H}kv{Hkv}-w{window}-D{D}")
              for C in (1, 5, 16) for (H, Hkv) in ((4, 4), (8, 2))
              for window in (None, 3) for D in (24, 64, 256)]


@pytest.mark.parametrize("C,H,Hkv,window,D", INT8_CASES)
def test_int8_pool_reference_matches_jax_reference(C, H, Hkv, window, D):
    B, ps, npages, maxp = 4, 8, 24, 5
    start = [0, 13, 22, 0]
    nt = [C, max(1, C - 3), 1, 0]
    q, kp, vp, pt, ctx, st, nt = _inputs(7, B, H, Hkv, C, D, ps, npages,
                                         maxp, start, nt)
    kq, ks, vq, vs = _int8_pools(kp, vp)
    ref = np.asarray(jpa.paged_attention_reference(
        *_jax(q, kq, vq, pt, ctx, st), window=window,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    tq_, tk, tv, tpt, tctx, tst, tks, tvs = _torch(q, kq, vq, pt, ctx, st,
                                                   ks, vs)
    out = tpa.paged_attention_reference(tq_, tk, tv, tpt, tctx, tst,
                                        window=window, k_scales=tks,
                                        v_scales=tvs)
    # the dispatcher on a CPU tensor: the same plain version, no launch
    kernels.reset_launch_counts()
    disp = tpa.ragged_paged_attention(tq_, tk, tv, tpt, tctx, tst,
                                      window=window, k_scales=tks,
                                      v_scales=tvs)
    assert set(kernels.launch_counts().values()) == {0}
    assert torch.equal(disp, out)
    scale = max(float(np.abs(ref[b, :, :n]).max())
                for b, n in enumerate(nt) if n)
    for b, n in enumerate(nt):
        err = np.abs(out.numpy()[b, :, :n] - ref[b, :, :n])
        assert err.size == 0 or float(err.max()) <= 1e-5 * scale


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_int8_pool_reference_dtypes_match_jax(out_dtype):
    """bf16 queries over an int8 pool: the gathered context is
    dequantized in f32, then cast to ``out_dtype`` or q's dtype, as in
    JAX."""
    B, H, Hkv, C, D, ps = 2, 4, 2, 3, 16, 8
    q, kp, vp, pt, ctx, st, nt = _inputs(8, B, H, Hkv, C, D, ps, 9, 3,
                                         [5, 11], [3, 2])
    kq, ks, vq, vs = _int8_pools(kp, vp)
    jq_ = jnp.asarray(q).astype(jnp.bfloat16)
    ref = jpa.paged_attention_reference(
        jq_, *_jax(kq, vq, pt, ctx, st), k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs), out_dtype=out_dtype and jnp.bfloat16)
    tq_, tk, tv, tpt, tctx, tst, tks, tvs = _torch(q, kq, vq, pt, ctx, st,
                                                   ks, vs)
    out = tpa.paged_attention_reference(
        tq_.bfloat16(), tk, tv, tpt, tctx, tst, k_scales=tks, v_scales=tvs,
        out_dtype=out_dtype and torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    for b, n in enumerate(nt):
        np.testing.assert_allclose(out.float().numpy()[b, :, :n],
                                   ref[b, :, :n], rtol=2e-2, atol=2e-2)


def test_gather_pages_dequantizes_like_jax():
    rng = np.random.RandomState(9)
    pool = rng.randint(-127, 128, (9, 4, 2, 8)).astype(np.int8)
    scales = rng.rand(9, 4, 2).astype(np.float32)
    pt = rng.randint(0, 9, (3, 2)).astype(np.int32)
    ref = jpa.gather_pages(jnp.asarray(pool), jnp.asarray(pt),
                           jnp.asarray(scales))
    out = tpa.gather_pages(*_torch(pool, pt, scales))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_int8_pool_checks_raise_by_name():
    """The kernel's checks (run before any launch): an int8 pool needs
    both scale planes, a float pool takes none, the planes are f32 of the
    pool's (pages, page size, kv heads)."""
    from mxnet_tpu_torch.base import MXNetError
    q, kp, vp, pt, ctx, st, _ = _inputs(6, 1, 2, 2, 1, 8, 8, 4, 1, [0], [1])
    kq, ks, vq, vs = _torch(*_int8_pools(kp, vp))
    tq_, tpt, tctx, tst = _torch(q, pt, ctx, st)
    with pytest.raises(MXNetError, match="needs k_scales and v_scales"):
        tpa._check(tq_, kq, vq, tpt, tctx, tst)
    with pytest.raises(MXNetError, match="needs k_scales and v_scales"):
        tpa._check(tq_, *_torch(kp, vp), tpt, tctx, tst, ks, vs)
    with pytest.raises(MXNetError, match="k_scales must be float32"):
        tpa._check(tq_, kq, vq, tpt, tctx, tst, ks.double(), vs)
    with pytest.raises(MXNetError, match="v_scales must be float32"):
        tpa._check(tq_, kq, vq, tpt, tctx, tst, ks, vs[:, :4])
    with pytest.raises(MXNetError, match="an int8 pool"):
        tpa._check(tq_, kq, vq.bfloat16(), tpt, tctx, tst, ks, vs)


# f16 pools: f32 queries (an f16 model's serving step, whose activations
# are f32 after the first LayerNorm: K1 type 5) and f16 queries (JAX's
# kernel on f16 inputs: type 6)
F16_CASES = [pytest.param(qdt, C, H, Hkv, window,
                          id=f"{qdt}-C{C}-H{H}kv{Hkv}-w{window}")
             for qdt in ("float32", "float16") for C in (1, 5, 8)
             for (H, Hkv) in ((4, 4), (4, 1)) for window in (None, 3)]


@pytest.mark.parametrize("qdt,C,H,Hkv,window", F16_CASES)
def test_f16_pool_reference_matches_jax(qdt, C, H, Hkv, window,
                                        monkeypatch):
    """The plain K1 (the CPU dispatch) over f16 pools against JAX's
    reference on the same f16 pages: f32 queries read the pages widened
    to f32 (within 1e-5 of the output's scale: the same f32 arithmetic in
    another summation order); f16 queries compute as JAX's f16 dense
    attention does, p rounded to f16 (within 5e-3 of the scale), and the
    same against JAX's Pallas kernel in interpret mode.  The output takes
    the query's dtype."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    B, D, ps, npages, maxp = 4, 16, 8, 24, 5
    start = [0, 13, 29, 0]
    nt = [C, max(1, C - 3), 1, 0]
    q, kp, vp, pt, ctx, st, nt = _inputs(11, B, H, Hkv, C, D, ps, npages,
                                         maxp, start, nt)
    q = q.astype(qdt)
    kp, vp = kp.astype(np.float16), vp.astype(np.float16)
    out = tpa.ragged_paged_attention(*_torch(q, kp, vp, pt, ctx, st),
                                     window=window)
    assert str(out.dtype) == "torch." + qdt
    wants = [jpa.paged_attention_reference(*_jax(q, kp, vp, pt, ctx, st),
                                           window=window)]
    if qdt == "float16":
        wants.append(jpa.ragged_paged_attention(
            *_jax(q, kp, vp, pt, ctx, st), window=window, use_kernel=True))
    tol = 1e-5 if qdt == "float32" else 5e-3
    got = out.float().numpy()
    for want in wants:
        assert str(want.dtype) == qdt
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want[b, :, :n]).max())
                    for b, n in enumerate(nt) if n)
        for b, n in enumerate(nt):
            err = np.abs(got[b, :, :n] - want[b, :, :n])
            assert err.size == 0 or float(err.max()) <= tol * scale


def test_f16_types_and_the_int8_pool_under_f16_queries(monkeypatch):
    """The kernel's checks take f16 pools under f32 queries (type 5) and
    f16 queries over f16 pools (type 6), each from the library of its
    query's width; an int8 pool under f16 queries, which no serving path
    makes, raises by name, as do float64 queries and an f16 pool under
    bf16 queries."""
    from mxnet_tpu_torch.base import MXNetError
    q, kp, vp, pt, ctx, st, _ = _inputs(6, 1, 2, 2, 1, 8, 8, 4, 1, [0], [1])
    tq_, tk, tv, tpt, tctx, tst = _torch(q, kp, vp, pt, ctx, st)
    h = torch.float16
    assert tpa._TYPES[h, torch.float32] == 5 and tpa._TYPES[h, h] == 6
    assert tpa._LIBRARY[torch.float32] == "paged_attention_q32"
    assert tpa._LIBRARY[h] == tpa._LIBRARY[torch.bfloat16] == \
        "paged_attention_q16"
    monkeypatch.setattr(tpa._kernels, "sm_count", lambda device: 132)
    for qq, pool in ((tq_, tk.half()), (tq_.half(), tk.half())):
        assert tpa._check(qq, pool, pool, tpt, tctx, tst).row_tile == 1
    kq, ks, vq, vs = _torch(*_int8_pools(kp, vp))
    with pytest.raises(MXNetError, match="int8 pool under float16"):
        tpa._check(tq_.half(), kq, vq, tpt, tctx, tst, ks, vs)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16 q"):
        tpa._check(tq_.double(), tk.double(), tv.double(), tpt, tctx, tst)
    with pytest.raises(MXNetError, match="float16 pool under float32"):
        tpa._check(tq_.bfloat16(), tk.half(), tv.half(), tpt, tctx, tst)


def test_head_mismatch_raises():
    from mxnet_tpu_torch.base import MXNetError
    q, kp, vp, pt, ctx, st, _ = _inputs(5, 1, 3, 2, 1, 8, 8, 4, 1, [0], [1])
    with pytest.raises(MXNetError, match="multiple of pool kv heads"):
        tpa.ragged_paged_attention(*_torch(q, kp, vp, pt, ctx, st))


# ---------------------------------------------------------------------------
# K1's launch plan and the page-size tunable (no card needed)
# ---------------------------------------------------------------------------

from mxnet_tpu_torch.ops import autotune as at      # noqa: E402

SMS = 132     # the H100 SXM's SM count


@pytest.mark.parametrize("C,H,Hkv,variant,row_tile", [
    (1, 12, 12, "few", 1),      # MHA decode: one row
    (1, 12, 3, "few", 4),       # GQA rep 4 decode
    (16, 12, 12, "tile", 16),   # the prefill chunk
    (16, 12, 3, "tile", 16)])   # rep 4 x chunk 16: 64 rows, 4 row tiles
def test_plan_variant_by_rows(C, H, Hkv, variant, row_tile):
    plan = tpa._plan(8, H, Hkv, C, 64, 16, 32, torch.float32, SMS)
    rows = H // Hkv * C
    assert (plan.variant, plan.row_tile) == (variant, row_tile)
    assert plan.groups == 8 * Hkv * -(-rows // row_tile)


@pytest.mark.parametrize("maxp,ps,split", [(1, 16, 1), (32, 16, 8),
                                           (256, 16, 16)])
def test_plan_split_counts(maxp, ps, split):
    """Capacity 16 keys: one split, written straight to `out`; the main
    path's 512: eight splits of 64 keys (eight blocks an SM over 96
    groups would ask for less, but a split holds a tile a warp at least);
    4096: 256-key splits, at most four tiles a warp."""
    plan = tpa._plan(8, 12, 12, 1, 64, ps, maxp, torch.float32, SMS)
    cap = maxp * ps
    assert plan.split == split
    assert (plan.split - 1) * plan.span < cap <= plan.split * plan.span
    assert plan.workspace == (0 if split == 1 else
                              plan.groups * split * plan.row_tile * 68)
    if split > 1:
        assert plan.span <= tpa.MAX_SPAN
        assert plan.span >= plan.warps * tpa.KEY_TILE


@pytest.mark.parametrize("ps", [8, 16, 24, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_plan_spans_are_whole_pages(ps, dtype, D):
    for maxp in (1, 3, 32, 200, 5000):
        for C, H, Hkv in ((1, 12, 12), (16, 12, 3)):
            plan = tpa._plan(8, H, Hkv, C, D, ps, maxp, dtype, SMS)
            assert plan.span % ps == 0 and plan.span <= maxp * ps
            assert plan.split <= tpa.MAX_SPLITS
            assert 1 <= plan.warps <= 4
            assert plan.split == -(-maxp * ps // plan.span)


@pytest.mark.parametrize("D,row", [(18, 24), (24, 28), (72, 76), (100, 104),
                                   (256, 260)])
def test_plan_workspace_rows_are_whole_16_byte_units(D, row):
    """A split's partial row is D floats rounded up to 4, then m, l and
    two floats of pad (csrc `prow`): 16-byte rows at any D."""
    plan = tpa._plan(8, 12, 12, 1, D, 16, 32, torch.float32, SMS)
    assert plan.split > 1
    assert plan.workspace == plan.groups * plan.split * plan.row_tile * row


@pytest.mark.parametrize("D", [24, 64, 72, 256])
@pytest.mark.parametrize("C,H,Hkv", [(1, 12, 12), (5, 12, 12), (1, 12, 3),
                                     (16, 12, 3)])
def test_plan_of_an_int8_pool(C, H, Hkv, D):
    """An int8 pool's rows are a quarter of f32's: its rings always fit
    four warps; the split and rows follow the same rules as the float
    pools' (the variant by folded rows, whole-page spans)."""
    for maxp in (1, 32, 256):
        p8 = tpa._plan(8, H, Hkv, C, D, 16, maxp, torch.int8, SMS)
        pf = tpa._plan(8, H, Hkv, C, D, 16, maxp, torch.float32, SMS)
        assert p8.warps == 4 and p8.warps >= pf.warps
        assert (p8.variant, p8.row_tile, p8.groups) == (
            pf.variant, pf.row_tile, pf.groups)
        assert p8.span % 16 == 0 and p8.split == -(-maxp * 16 // p8.span)
        assert p8.span >= p8.warps * tpa.KEY_TILE or p8.split == 1


@pytest.mark.parametrize("D", [24, 64, 256])
def test_plan_of_an_f16_pool_is_the_bf16_pools(D):
    """f16 rows are as wide as bf16's: an f16 pool's plan (rings, warps,
    splits) is the bf16 pool's at every shape, by dtype or by name."""
    for maxp in (1, 32, 256):
        for C, H, Hkv in ((1, 12, 12), (5, 12, 3), (16, 12, 3)):
            args = (8, H, Hkv, C, D, 16, maxp)
            assert tpa._plan(*args, torch.float16, SMS) == \
                tpa._plan(*args, torch.bfloat16, SMS) == \
                tpa._plan(*args, "float16", SMS)


def test_f16_tuning_key_times_f16_inputs():
    """``tune("paged_attention", ..., "float16")`` times K1 over f16 queries
    and an f16 pool (the JAX package's build turns any 16-bit key into
    bf16 inputs); "bfloat16" keeps bf16 and "float32" f32."""
    cfg = at.BlockConfig(page_size=16)
    for key, want in (("float16", torch.float16),
                      ("bfloat16", torch.bfloat16),
                      ("float32", torch.float32),
                      (torch.float16, torch.float16)):
        q, kp, vp, *_ = tpa._at_inputs(cfg, (2, 4, 4, 16, 40), key,
                                       torch.device("cpu"))
        assert q.dtype == kp.dtype == vp.dtype == want, key


def test_plan_is_memoised():
    args = (8, 12, 12, 1, 64, 16, 32, torch.float32, SMS)
    hits = tpa._plan.cache_info().hits
    assert tpa._plan(*args) is tpa._plan(*args)
    assert tpa._plan.cache_info().hits >= hits + 1


def test_paged_attention_is_a_tunable():
    assert "paged_attention" in at.tunables()
    cands = tpa._at_candidates((8, 12, 12, 64, 512), "float32")
    assert [c.page_size for c in cands] == [16, 32, 64, 128]


@pytest.mark.parametrize("shapes", [(8, 12, 12, 64, 512), (4, 8, 2, 128,
                                                            1000), ()])
def test_roofline_equals_jax(shapes):
    for ps in (16, 32, 64, 128):
        got = tpa._at_roofline(at.BlockConfig(page_size=ps), shapes,
                               "float32")
        want = jpa._at_roofline(at.BlockConfig(page_size=ps), shapes,
                                "float32")
        assert got == want


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("MXTPU_SERVE_PAGE_SIZE", raising=False)
    monkeypatch.delenv("MXTPU_AUTOTUNE", raising=False)
    at.clear_memory_cache()
    yield tmp_path
    at.clear_memory_cache()


def test_recommended_page_size_is_the_tuned_one(tune_cache):
    assert tpa.recommended_page_size() == 16
    assert tpa.recommended_page_size(32) == 32
    kernels.reset_launch_counts()
    res = at.tune("paged_attention", (2, 2, 2, 16, 64), "float32", runs=1)
    assert not res.cache_hit and res.trials == 4
    # the CPU trials run the plain version: no kernel launch is counted
    assert kernels.launch_counts()["ragged_paged_attention"] == 0
    assert tpa.recommended_page_size() == res.config.page_size
    at.clear_memory_cache()       # a fresh process reads it from disk
    assert tpa.recommended_page_size() == res.config.page_size


def test_serve_config_page_size_follows_jax_order(tune_cache, monkeypatch):
    from mxnet_tpu_torch.serve import ServeConfig
    assert ServeConfig().page_size == 16
    key = at._key("paged_attention", (8, 12, 12, 64, 512), "float32",
                  at.device_kind())
    at._disk_store("paged_attention", key, at.BlockConfig(page_size=64))
    at.clear_memory_cache()
    assert ServeConfig().page_size == 64
    monkeypatch.setenv("MXTPU_SERVE_PAGE_SIZE", "32")
    assert ServeConfig().page_size == 32
    assert ServeConfig(page_size=8).page_size == 8
