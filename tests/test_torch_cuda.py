"""The port's CUDA kernels against their plain versions, on the card:
ragged paged attention (both variants at the default plan, one split and
one page a split, pages 8, 24 and 128, D 64 and 128, any D up to 256 --
rows that are not a multiple of 16 columns or 16 bytes --, empty slots,
windows, two streams, two calls bit-equal; the speculative verification
widths 2-8 over page tables that share and fork pages), the dequant-matmul (every plan of its menu, odd
shapes, the tied head, two calls bit-equal), flash attention (forward and
backward, with padding or per-row bias, causal, dropout, ragged L and
D up to 256, under windows of 3 and 64 keys each way and with 1, 3 or 4
query heads folded onto each kv head's rows, a dQ ticket over a middle
range of key tiles, rows past every key's band, a windowed BERT against
its plain attention; the forward at every (block_q, block_k) of its
tuner's menu, unaligned operands, two calls and two streams bit-equal, masked rows
exactly zero with lse 0, and its tunable's trials; the backward at both
key tiles, two calls and two streams bit-equal, masked rows and keys
exactly zero, heads over 128 wide with their own tiles, and Gemma 2B's
fold of 16384 rows a head with the q walk split across blocks), the
streaming cross-entropy (any V from 1, every 16-byte phase of a row's
start, unclamped labels at both ends, -inf over a row's first reads; the
forward's loss and lse within 1e-4 in bf16 too), the fused
LayerNorm/RMSNorm (any h, with and without residual and beta; both plan
variants, 16-byte and one-element loads, every block_rows of its tuner's
menu, two calls bit-equal, the public wrappers, its tunable's trials)
and the optimizer kernels (the multi-tensor chunk for Adam, AdamW and
SGD, and for NAG, Signum, AdaBelief, Adamax, AdaDelta and FTML with f32
and bf16 weights and state and the skip flag; LAMB phases A and B once
per dtype group, with 1- and 768-element leaves, an unaligned leaf, two
streams and the gluon `Trainer`; phase B within one unit in the last
place of the host's float64 update; f32 and bf16 weights; the skip flag;
every tunable chunk size; a cold norm tune timed by CUDA events, twice),
the MoE row gather (dispatch and combine, f32, bf16 and f16, with
sentinel rows, 16-byte and narrower rows, an unaligned source) and a
two-step MoE `TrainStep` on the card; and the int8 KV pool: K1's int8
variant under f32 and bf16 queries (both variants, D 24-256, windows,
every split), the int8-activation product padded to the shapes
``torch._int_mm`` takes, and a small GPT served over an int8 pool; and
float16: the flash and cross-entropy cases above in f16 too, gradients
past f16's range stored as inf where the plain versions' casts put them,
a dtype neither kernel takes refused by name, the loss scaler's check on
CUDA gradients, and a small BERT's fp16 AMP steps through the `Trainer`
(f32 and f16 weights) against the plain versions; and float16 in the
other rows: the chunk kernel's nine rules and LAMB's phases over f16
weights with f32 or f16 state, K1 with f32 or f16 queries over f16 pools
(types 5 and 6: every split, any head width, two streams), K2 on f16
activations at every plan, each launch counted under its dtype, a small
f16 GPT served over an f16 pool and trained through `TrainStep`, and the
tuner's f16 keys; and the Gluon front end: the cross-entropy at 2 and 3
classes, K2 at N = 2 and K = 16, `quantize_net` over ``nn.Dense`` (K2 a
layer, none under ``MXTPU_QUANT_ACT=1``), and a `gluon.Trainer` over a
``gluon.nn`` net launching the norm and the chunk; and the operations
plane: a `TrainStep` under health and recovery whose own skip flag (one NaN
planted in a gradient) keeps every weight and state bit through the chunk
and LAMB kernels with no host sync, and its ``save_async`` / ``load``
round trip, dropout generator included, bit-equal; and the models as
Gluon blocks: `examples/gpt_generation.py`'s loop on its two GPTs (the
launches a step, the plain twin's losses, the `save_parameters` round
trip) and `examples/serve_gpt.py`'s engine over a Block; and the data
plane: the device prefetcher copying on a stream of its own from pinned
memory, each batch read right after ``next()`` correct while a long kernel
is queued on the consumer's stream and the batch is freed at once (the
event wait and ``record_stream``), and a `DataLoader` over arrays on the
card whose two worker processes rebuild them on the CPU and never open a
CUDA context.

Marked ``cuda``: each test skips (with its reason) where no card is
visible, as on the CPU test machine.  Run them on a machine with an H100
(which needs no JAX): ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``.  Tolerances: f32 max-abs
<= 1e-4 of the output scale (summation order), bf16 <= 2e-2, f16 <= 5e-3
(three more mantissa bits than bf16; f32 queries over an f16 pool at the
f32 bound, the pool widening exactly); the optimizer
kernels at atol 2e-6 on f32 (the JAX kernel test's bound), 16-bit values
at one step of their type (rtol 2**-7 bf16, 2**-10 f16); the row gather
and the chunk kernel
at different chunk sizes bit for bit (a copy, or one f32 multiply and a
cast, on both sides).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.ops import quantized_matmul as qm

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("C,Hkv,ps,window", [(1, 4, 16, None),
                                             (8, 2, 8, None),
                                             (8, 1, 24, 5)])
def test_paged_attention_kernel_matches_plain(card, dtype, tol, C, Hkv, ps,
                                              window):
    g = torch.Generator().manual_seed(0)
    B, H, D, maxp = 3, 4, 64, 6
    q = torch.randn(B, H, C, D, generator=g).to(card, dtype)
    kp = torch.randn(B * maxp + 1, ps, Hkv, D, generator=g).to(card, dtype)
    vp = torch.randn(B * maxp + 1, ps, Hkv, D, generator=g).to(card, dtype)
    pt = (torch.randperm(B * maxp, generator=g) + 1).reshape(B, maxp)
    start = torch.tensor([0, 2 * ps + 3, 0])
    nt = torch.tensor([C, C, 0])
    args = [t.to(card, torch.int32) for t in (pt, start + nt, start)]
    kernels.reset_launch_counts()
    out = pa.ragged_paged_attention(q, kp, vp, *args, window=window)
    ref = pa.paged_attention_reference(q, kp, vp, *args, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ragged_paged_attention"] == 1
    for b in range(2):                  # slot 2 is empty (ctx = 0)
        n = int(nt[b])
        err = (out[b, :, :n].float() - ref[b, :, :n].float()).abs().max()
        assert float(err) <= tol * float(ref[b, :, :n].float().abs().max())


def _rpa_inputs(card, dtype, C, H, Hkv, D, ps, maxp, start, nt, seed=0):
    g = torch.Generator().manual_seed(seed)
    B = len(start)
    q = torch.randn(B, H, C, D, generator=g).to(card, dtype)
    kp = torch.randn(B * maxp + 1, ps, Hkv, D, generator=g).to(card, dtype)
    vp = torch.randn(B * maxp + 1, ps, Hkv, D, generator=g).to(card, dtype)
    pt = (torch.randperm(B * maxp, generator=g) + 1).reshape(B, maxp)
    start, nt = torch.tensor(start), torch.tensor(nt)
    return [q, kp, vp] + [t.to(card, torch.int32)
                          for t in (pt, start + nt, start)]


def _with_span(plan, span, cap, D):
    """`plan` with splits of `span` keys over a table of `cap` keys."""
    split = -(-cap // span)
    return plan._replace(span=span, split=split, workspace=(
        plan.groups * split * plan.row_tile * (-(-D // 4) * 4 + 4)
        if split > 1 else 0))


RPA_SHAPES = [(1, 4, 4), (1, 8, 2), (16, 4, 4), (4, 8, 1)]   # C, H, Hkv


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("C,H,Hkv", RPA_SHAPES)
@pytest.mark.parametrize("ps,D,maxp", [(8, 64, 40), (24, 128, 14),
                                       (128, 64, 4)])
@pytest.mark.parametrize("windowed", [False, True])
def test_paged_attention_every_split_matches_plain(card, dtype, tol, C, H,
                                                   Hkv, ps, D, maxp,
                                                   windowed):
    """Both variants (rows 1 and 4: few; 16 and 32: tile) at the default
    plan, one split a slot and one page a split: contexts that end exactly
    on a split boundary and that cross one, the full table, an empty slot
    and a slot with no key at all, a window whose floor skips splits; two
    calls bit-equal, one launch each."""
    cap = ps * maxp
    sms = kernels.sm_count(card)
    plan = pa._plan(6, H, Hkv, C, D, ps, maxp, dtype, sms)
    assert plan.variant == ("few" if H // Hkv * C < 16 else "tile")
    S = plan.span
    ctx = [S, min(S + 5, cap), 0, 0, cap - 1, cap]
    nt = [min(C, c) for c in ctx]
    nt[3] = 0
    start = [c - n for c, n in zip(ctx, nt)]
    start[3] = 7                  # past the start, yet no key: ctx = 0
    args = _rpa_inputs(card, dtype, C, H, Hkv, D, ps, maxp, start, nt)
    args[4][3] = 0
    window = 2 * ps + 3 if windowed else None
    scale = D ** -0.5
    ref = pa.paged_attention_reference(*args, window=window, scale=scale)
    plans = [plan, _with_span(plan, cap, cap, D),
             _with_span(plan, ps, cap, D)]
    assert plans[1].split == 1 and plans[2].split == maxp
    for pl in plans:
        kernels.reset_launch_counts()
        a = pa._rpa_cuda(*args, window, scale, plan=pl)
        b = pa._rpa_cuda(*args, window, scale, plan=pl)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["ragged_paged_attention"] == 2
        assert torch.equal(a, b), pl
        assert torch.isfinite(a.float()).all()
        for s in (2, 3):          # no key: exactly zero
            assert not bool(a[s].float().any()), pl
        for s, n in enumerate(nt):
            if n:
                err = (a[s, :, :n].float() - ref[s, :, :n].float()).abs()
                assert float(err.max()) <= tol * float(
                    ref[s, :, :n].float().abs().max()), (pl, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("C,H,Hkv", [(1, 12, 12), (16, 12, 3)])
def test_paged_attention_splits_on_two_streams(card, dtype, C, H, Hkv):
    """Split launches on two streams at once keep their own tickets and
    partials: each stream's results equal the same launch made alone, bit
    for bit, and the tickets are left zeroed."""
    D, ps, maxp = 64, 16, 32
    calls = [_rpa_inputs(card, dtype, C, H, Hkv, D, ps, maxp,
                         [300, 17, 450, 0], [C, 1, C, C], seed=s)
             for s in (1, 2)]
    plan = _with_span(pa._plan(4, H, Hkv, C, D, ps, maxp, dtype,
                               kernels.sm_count(card)), 64, ps * maxp, D)
    assert plan.split == 8
    wants = [pa._rpa_cuda(*a, None, 0.125, plan=plan) for a in calls]
    streams = [torch.cuda.Stream(card) for _ in calls]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(pa._rpa_cuda(*calls[i], None, 0.125,
                                            plan=plan))
    torch.cuda.synchronize()
    for want, got in zip(wants, outs):
        assert all(torch.equal(o, want) for o in got)
    raw = {st.cuda_stream for st in streams}
    mine = [v for key, v in pa._scratch_of.items() if key[1] in raw]
    assert len(mine) == 2
    assert all(int(t[0].abs().sum()) == 0 for t in mine)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("C", [2, 3, 5, 8])
@pytest.mark.parametrize("H,Hkv", [(12, 12), (12, 3)])
def test_paged_attention_verify_widths_over_shared_and_forked_pages(
        card, dtype, tol, C, H, Hkv):
    """K1 at speculative verification widths (rep 1: 2-8 causal rows in
    the chunk, the few-rows variant; rep 4: 8-32 rows) over the page
    tables the prefix cache makes: slots 0, 2 and 3 read one physical run
    of 6 full pages and a partial 7th (shared), slot 1 reads the same
    prefix through a forked copy of the partial page; slot 4 feeds fewer
    rows than C, slot 5 none.  Against the plain version, two calls
    bit-equal, and slot 1 (same queries and K/V as slot 0 through another
    table) bit-equal to slot 0."""
    D, ps, maxp = 64, 16, 32
    B = 6
    start = [100, 100, 100, 240, 37, 0]
    nt = [C, C, C, C, max(1, C - 2), 0]
    args = _rpa_inputs(card, dtype, C, H, Hkv, D, ps, maxp, start, nt)
    q, kp, vp, pt = args[:4]
    npages = kp.shape[0]
    ids = torch.randperm(npages - 1, generator=torch.Generator()
                         .manual_seed(3)) + 1
    shared, fork, rest = ids[:7], ids[7], ids[8:]
    table = torch.zeros(B, maxp, dtype=torch.int32)
    table[:, :7] = shared
    table[:, 7:] = rest[:B * (maxp - 7)].view(B, maxp - 7)
    table[1, 6] = fork
    kp[fork].copy_(kp[shared[6]])        # the fork's copy, as copy_page
    vp[fork].copy_(vp[shared[6]])
    q[1].copy_(q[0])
    args[3] = table.to(card)
    kernels.reset_launch_counts()
    out = pa.ragged_paged_attention(*args)
    again = pa.ragged_paged_attention(*args)
    ref = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ragged_paged_attention"] == 2
    assert torch.equal(out, again)
    assert torch.equal(out[1], out[0])
    for b, n in enumerate(nt):
        if n:
            err = (out[b, :, :n].float() - ref[b, :, :n].float()).abs()
            assert float(err.max()) <= tol * float(
                ref[b, :, :n].float().abs().max()), b


def test_paged_attention_raises_on_a_head_dim_it_does_not_take(card):
    """D = 24 (not a multiple of 16: the kernel refused it before its rows
    were padded in shared memory) launches and matches the plain version;
    a head over 256 wide still raises by name."""
    args = _rpa_inputs(card, torch.float32, 1, 2, 2, 24, 8, 2, [3], [1])
    kernels.reset_launch_counts()
    out = pa.ragged_paged_attention(*args)
    ref = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ragged_paged_attention"] == 1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    q = torch.zeros(1, 2, 1, 384, device=card)
    pool = torch.zeros(2, 8, 2, 384, device=card)
    i32 = torch.zeros(1, 1, dtype=torch.int32, device=card)
    with pytest.raises(MXNetError, match="B4 part 2"):
        pa.ragged_paged_attention(q, pool, pool, i32, i32[0], i32[0])


# (query dtype, pool dtype, tolerance): each route and f32 queries over a
# bf16 pool (held to the bf16 tolerance); f32 queries over an f16 pool
# (type 5: the pool's values widen exactly, so the f32 arithmetic's 1e-4)
# and f16 over f16 (type 6)
RPA_TYPES = [(torch.float32, torch.float32, 1e-4),
             (torch.bfloat16, torch.bfloat16, 2e-2),
             (torch.float32, torch.bfloat16, 2e-2),
             (torch.float32, torch.float16, 1e-4),
             (torch.float16, torch.float16, 5e-3)]


@pytest.mark.parametrize("qdt,pdt,tol", RPA_TYPES)
@pytest.mark.parametrize("D", [7, 18, 24, 72, 100, 200, 256])
@pytest.mark.parametrize("C,H,Hkv,windowed", [(1, 3, 1, False),
                                               (16, 3, 1, False),
                                               (1, 8, 1, True),
                                               (4, 8, 2, True)])
def test_paged_attention_any_head_width_matches_plain(card, qdt, pdt, tol,
                                                      D, C, H, Hkv,
                                                      windowed):
    """Rows of any width up to 256: whole 16-byte pieces (24, 72, 256),
    8-byte (bf16 100, f32 18), 4-byte (bf16 18) and 2-byte ones (bf16 7),
    each zero-filled past D to 16 columns; the default plan (a split
    merge at these tables) and one split, two calls bit-equal."""
    start, nt = [0, 37, 100, 5], [C, C, min(C, 3), 0]
    args = _rpa_inputs(card, qdt, C, H, Hkv, D, 16, 12, start, nt, seed=D)
    args[1], args[2] = args[1].to(pdt), args[2].to(pdt)
    window = 30 if windowed else None
    ref = pa.paged_attention_reference(*args, window=window,
                                       scale=D ** -0.5)
    plan = pa._plan(4, H, Hkv, C, D, 16, 12, pdt, kernels.sm_count(card))
    for p in (plan, _with_span(plan, 16 * 12, 16 * 12, D)):
        kernels.reset_launch_counts()
        out = pa._rpa_cuda(*args, window, D ** -0.5, plan=p)
        again = pa._rpa_cuda(*args, window, D ** -0.5, plan=p)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["ragged_paged_attention"] == 2
        assert torch.equal(out, again)
        for b, n in enumerate(nt):
            if n:
                err = (out[b, :, :n].float() - ref[b, :, :n].float()).abs()
                assert float(err.max()) <= tol * float(
                    ref[b, :, :n].float().abs().max()), (b, p)


def _qmm_case(card, dtype, bits, M, N, K, seed=1):
    g = torch.Generator().manual_seed(seed)
    qt = qm.quantize_weight(torch.randn(N, K, generator=g), bits).to(card)
    x = torch.randn(M, K, generator=g).to(card, dtype)
    return x, qt


def _qmm_check(out, ref, tol):
    err = (out.float() - ref.float()).abs().max()
    assert float(err) <= tol * float(ref.float().abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,N,K", [(8, 96, 64), (37, 70, 33), (8, 96, 33),
                                   (3, 50, 1000), (8, 50257, 768)])
def test_quantized_matmul_kernel_matches_plain(card, dtype, tol, bits, M, N,
                                               K):
    """Odd shapes (unaligned rows take the scalar path), int4 at K = 33,
    the tied-head shape; one launch a call, counted under x's dtype, the
    output in x's dtype."""
    x, qt = _qmm_case(card, dtype, bits, M, N, K)
    kernels.reset_launch_counts()
    out = qm.quantized_matmul(x, qt)
    assert kernels.launch_counts()["quantized_matmul"] == 1
    assert kernels.DTYPE_LAUNCHES == {
        ("quantized_matmul", str(dtype)[6:]): 1}
    assert out.dtype == dtype
    ref = qm.quantized_matmul_reference(x, qt)
    torch.cuda.synchronize()
    _qmm_check(out, ref, tol)


QMM_SHAPES = [(2304, 768), (768, 768), (3072, 768), (768, 3072)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 128])
def test_quantized_matmul_every_plan_matches_plain(card, dtype, tol, bits,
                                                   M):
    """Every variant and split of the tuner's menu at GPT-2 small's four
    projection shapes, and the default plan, bit-equal across two calls."""
    for N, K in QMM_SHAPES:
        x, qt = _qmm_case(card, dtype, bits, M, N, K, seed=N + K)
        ref = qm.quantized_matmul_reference(x, qt)
        sms = qm._sms(x.device)
        plans = [qm._plan(M, N, K, bits, dtype, sms)] + [
            qm._plan(M, N, K, bits, dtype, sms, qm.VARIANTS[c.variant],
                     c.split)
            for c in qm._candidates((M, N, K), qm._tune_dtype(bits, dtype))]
        for plan in plans:
            kernels.reset_launch_counts()
            a = qm._qmm_cuda(x, qt, plan)
            b = qm._qmm_cuda(x, qt, plan)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["quantized_matmul"] == 2
            assert torch.equal(a, b), plan
            _qmm_check(a, ref, tol)


@pytest.mark.parametrize("variant,M", [("small", 8), ("large", 128)])
def test_quantized_matmul_split_k_on_two_streams(card, variant, M):
    """Split-K launches on two streams at once keep their own ticket
    counters and partials: each stream's results equal the same launch
    made alone, bit for bit."""
    N, K = 768, 3072
    x, qt = _qmm_case(card, torch.float32, 8, M, N, K)
    plan = qm._plan(M, N, K, 8, torch.float32, qm._sms(x.device), variant,
                    4)
    assert plan.split == 4
    xs = [x, x * -0.5]
    wants = [qm._qmm_cuda(xi, qt, plan) for xi in xs]
    streams = [torch.cuda.Stream(card) for _ in xs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(qm._qmm_cuda(xs[i], qt, plan))
    torch.cuda.synchronize()
    for want, got in zip(wants, outs):
        assert all(torch.equal(o, want) for o in got)
    raw = {st.cuda_stream for st in streams}
    assert len([k for k in qm._scratch_of if k[1] in raw]) == 2
    # the counters are left zeroed: a later launch is still right
    assert torch.equal(qm._qmm_cuda(xs[0], qt, plan), wants[0])


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    """float64 reaches neither K1 nor K2, and an int8 pool under f16
    queries (no path makes it) is refused by name: no plain version in
    their place."""
    from mxnet_tpu_torch.contrib.quantization import quantize_kv
    q = torch.zeros(1, 2, 1, 8, device=card, dtype=torch.float64)
    pool = torch.zeros(2, 8, 2, 8, device=card, dtype=torch.float64)
    i32 = torch.zeros(1, 1, dtype=torch.int32, device=card)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        pa.ragged_paged_attention(q, pool, pool, i32, i32[0], i32[0])
    (kq, ks), (vq, vs) = quantize_kv(pool.float()), quantize_kv(pool.float())
    with pytest.raises(MXNetError, match="int8 pool under float16"):
        pa.ragged_paged_attention(q.half(), kq, vq, i32, i32[0], i32[0],
                                  k_scales=ks, v_scales=vs)
    qt = qm.quantize_weight(torch.randn(4, 8), 8).to(card)
    with pytest.raises(MXNetError, match="contiguous"):
        qm._qmm_cuda(torch.randn(8, 2, device=card).T, qt)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        qm.quantized_matmul(torch.randn(8, 8, device=card,
                                        dtype=torch.float64), qt)


def _flash_case(card, dtype, B, H, Lq, Lk, D, bias_kind, causal, rate,
                window=None, symmetric=True, rep=1):
    """The dispatcher's output and gradients (kernels, through autograd)
    and those of the plain versions (`flash_attention_reference`) on the
    same inputs; ``rep`` query heads share each of H // rep kv heads."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(2)
    G = H // rep
    q, k, v, do = (torch.randn(*s, generator=g).to(card, dtype)
                   for s in ((B, H, Lq, D), (B, G, Lk, D), (B, G, Lk, D),
                             (B, H, Lq, D)))
    bias = None
    if bias_kind == "pad":
        vl = torch.randint(1, Lk + 1, (B,), generator=g)
        bias = torch.where(torch.arange(Lk)[None] < vl[:, None], 0.0,
                           fa.MASK_VALUE).to(card)
    elif bias_kind == "row":
        bias = torch.randn(B, Lq, Lk, generator=g).to(card)
        bias[0, :3] = fa.MASK_VALUE                 # fully masked rows
    seed = torch.tensor([12345], dtype=torch.int32, device=card)
    out = []
    for flash in (fa.flash_attention, fa.flash_attention_reference):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = flash(qq, kk, vv, causal=causal, bias=bias, dropout_rate=rate,
                  dropout_seed=seed, window=window,
                  window_symmetric=symmetric)
        o.backward(do)
        out.append([o.detach()] + [t.grad for t in (qq, kk, vv)])
    torch.cuda.synchronize()
    return out


# (window, symmetric): none, and windows of 3 and 64 keys each way (the
# symmetric band [q - w, q + w] only without causal)
FLASH_WINDOWS = [(None, True), (3, True), (3, False), (64, True),
                 (64, False)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("Lq,Lk,D,bias_kind,causal,rate", [
    (128, 128, 64, "pad", False, 0.1), (77, 77, 64, "none", True, 0.0),
    (40, 100, 32, "row", False, 0.0), (130, 65, 128, "pad", False, 0.2),
    (200, 300, 64, "pad", False, 0.1), (257, 257, 128, "none", True, 0.0),
    (96, 96, 32, "row", False, 0.1), (130, 65, 256, "pad", False, 0.2),
    (77, 77, 192, "none", True, 0.0), (40, 100, 160, "row", False, 0.1)])
@pytest.mark.parametrize("window,symmetric", FLASH_WINDOWS)
@pytest.mark.parametrize("rep", [1, 3, 4])
def test_flash_attention_kernels_match_plain(card, dtype, tol, Lq, Lk, D,
                                             bias_kind, causal, rate, window,
                                             symmetric, rep):
    """Through the dispatcher and autograd, against the plain versions:
    3 kv heads shared by ``rep`` query heads each (folded rows that
    straddle two heads in a q tile where Lq is not a multiple of it)."""
    kernels.reset_launch_counts()
    got, want = _flash_case(card, dtype, 2, 3 * rep, Lq, Lk, D, bias_kind,
                            causal, rate, window, symmetric, rep)
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd"] == 1
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name


def _flash_bwd_inputs(card, dtype, B, H, Lq, Lk, D, bias_kind, causal, rate,
                      seed=3, window=None, symmetric=True, rep=1):
    """Seeded operands of one backward call and its plain version's
    (dq, dk, dv): q, k, v, bias3, seed, o, lse, dout and the flags, then
    the keywords (window, its symmetry, lq).  H kv heads, each shared by
    ``rep`` query heads folded onto its rows (q is (B, H, rep * Lq, D))."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(*s, generator=g).to(card, dtype)
                   for s in ((B, H, rep * Lq, D), (B, H, Lk, D),
                             (B, H, Lk, D), (B, H, rep * Lq, D)))
    bias = None
    if bias_kind == "pad":
        vl = torch.randint(1, Lk + 1, (B,), generator=g)
        bias = torch.where(torch.arange(Lk)[None] < vl[:, None], 0.0,
                           fa.MASK_VALUE).to(card)
    elif bias_kind == "row":
        bias = torch.randn(B, Lq, Lk, generator=g).to(card)
        bias[0, :3] = fa.MASK_VALUE                 # fully masked rows
    bias3, per_head, per_row = (None, False, False) if bias is None \
        else fa.normalize_bias(bias, B, H * rep, Lq, Lk)
    sd = torch.tensor([777], dtype=torch.int32, device=card)
    flags = (D ** -0.5, causal, rate, per_head, per_row)
    kw = dict(window=window, window_symmetric=symmetric, lq=Lq)
    o, lse = fa.flash_fwd_reference(q, k, v, bias3, sd, *flags, **kw)
    args = (q, k, v, bias3, sd, o, lse, do) + flags
    return args, kw, fa.flash_bwd_reference(*args, **kw)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("B,H,Lq,Lk,D,bias_kind,causal,rate", [
    (2, 3, 128, 128, 64, "pad", False, 0.1),
    (2, 3, 200, 300, 64, "pad", False, 0.1),
    (1, 2, 257, 257, 128, "none", True, 0.0),
    (2, 2, 96, 150, 32, "row", False, 0.0),
    (2, 2, 70, 33, 80, "none", False, 0.0),
    (1, 2, 45, 70, 33, "pad", True, 0.1)])
@pytest.mark.parametrize("window,symmetric", FLASH_WINDOWS)
@pytest.mark.parametrize("rep", [1, 3, 4])
def test_flash_backward_every_key_tile_is_right_and_repeatable(
        card, dtype, tol, bk, B, H, Lq, Lk, D, bias_kind, causal, rate,
        window, symmetric, rep):
    """Both key tiles (one tile a head: dQ written by the block; several:
    partials summed by the last to arrive) against the plain version, two
    calls bit-equal, and in 16 bits a grid of three persistent blocks giving
    the same bits; under a window and with ``rep`` query heads folded onto
    each of the H kv heads' rows."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    args, kw, want = _flash_bwd_inputs(card, dtype, B, H, Lq, Lk, D,
                                       bias_kind, causal, rate,
                                       window=window, symmetric=symmetric,
                                       rep=rep)
    plan = fa._bwd_plan(B, H * rep, Lq, Lk, D, dtype,
                        kernels.sm_count(card), bk=bk, kv_heads=H)
    kernels.reset_launch_counts()
    got = fa._flash_bwd_cuda(*args, plan=plan, **kw)
    again = fa._flash_bwd_cuda(*args, plan=plan, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == 2
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, a2), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name
    if dtype != torch.float32:
        # three persistent blocks walk every item, the next one's loads in
        # flight (causal heads wider than Lq have items with no q tile):
        # the same bits
        narrow = fa._flash_bwd_cuda(*args, plan=plan._replace(grid=3), **kw)
        assert all(torch.equal(a, b) for a, b in zip(narrow, got))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("B,H,Lq,Lk,D,bias_kind,causal,rate", [
    (2, 3, 128, 128, 256, "pad", False, 0.1),
    (2, 2, 200, 300, 256, "pad", False, 0.1),
    (1, 2, 257, 257, 192, "none", True, 0.0),
    (2, 2, 70, 33, 160, "row", False, 0.0),
    (1, 2, 45, 70, 129, "pad", True, 0.1)])
@pytest.mark.parametrize("window,symmetric", FLASH_WINDOWS)
@pytest.mark.parametrize("rep", [1, 3, 4])
def test_flash_backward_wide_heads_right_and_repeatable(
        card, dtype, tol, B, H, Lq, Lk, D, bias_kind, causal, rate, window,
        symmetric, rep):
    """Heads over 128 wide (two warps a 16 keys, each with half the dK and
    dV columns; the one key tile that fits: 64 keys in bf16, 32 in f32)
    against the plain version, two calls bit-equal, in bf16 a grid of
    three persistent blocks giving the same bits; the forward's wide plan
    (64 x 64 bf16, 32 x 32 f32) against its plain version too."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    args, kw, want = _flash_bwd_inputs(card, dtype, B, H, Lq, Lk, D,
                                       bias_kind, causal, rate,
                                       window=window, symmetric=symmetric,
                                       rep=rep)
    plan = fa._bwd_plan(B, H * rep, Lq, Lk, D, dtype,
                        kernels.sm_count(card), kv_heads=H)
    assert plan.dmax == 256
    kernels.reset_launch_counts()
    got = fa._flash_bwd_cuda(*args, plan=plan, **kw)
    again = fa._flash_bwd_cuda(*args, plan=plan, **kw)
    o, lse = fa._flash_fwd_cuda(*args[:5], *args[8:], **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd"] == 2
    assert counts["flash_attention_fwd"] == 1
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, a2), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name
    for name, a, b in (("out", o, args[5]), ("lse", lse, args[6])):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name
    if dtype != torch.float32:
        narrow = fa._flash_bwd_cuda(*args, plan=plan._replace(grid=3), **kw)
        assert all(torch.equal(a, b) for a, b in zip(narrow, got))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("D", [64, 256])
def test_flash_backward_long_folds_split_the_q_walk(card, dtype, tol, D):
    """Gemma 2B's fold, 8 query heads over one kv head at L 2048: 16384
    rows a head, so each key tile's q walk is cut into 16 splits whose f32
    dK / dV partials are summed in order (one block summing every row
    drifted 1.4e-4 from the plain version in f32); two calls bit-equal."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    args, kw, want = _flash_bwd_inputs(card, dtype, 1, 1, 2048, 2048, D,
                                       "none", True, 0.1, rep=8)
    plan = fa._bwd_plan(1, 8, 2048, 2048, D, dtype, kernels.sm_count(card),
                        kv_heads=1)
    assert plan.q_splits == 16
    got = fa._flash_bwd_cuda(*args, plan=plan, **kw)
    again = fa._flash_bwd_cuda(*args, plan=plan, **kw)
    torch.cuda.synchronize()
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, a2), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_backward_on_two_streams(card, dtype):
    """Backward calls with dQ partials on two streams at once keep their
    own tickets and partials: each stream's results equal the same call
    made alone, bit for bit, and the tickets are left zeroed."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    calls = [_flash_bwd_inputs(card, dtype, 2, 3, 150, 260, 64, "pad",
                               False, 0.1, seed=s)[0] for s in (4, 5)]
    plan = fa._bwd_plan(2, 3, 150, 260, 64, dtype, kernels.sm_count(card),
                        bk=64)
    assert plan.key_tiles == 5
    wants = [fa._flash_bwd_cuda(*a, plan=plan) for a in calls]
    streams = [torch.cuda.Stream(card) for _ in calls]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(10):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(fa._flash_bwd_cuda(*calls[i], plan=plan))
    torch.cuda.synchronize()
    for want, got in zip(wants, outs):
        for grads in got:
            assert all(torch.equal(a, b) for a, b in zip(grads, want))
    raw = {st.cuda_stream for st in streams}
    mine = [v for key, v in fa._scratch_of.items() if key[1] in raw]
    assert len(mine) == 2
    assert all(int(t[0].abs().sum()) == 0 for t in mine)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bk", [64, 128])
def test_flash_backward_masked_rows_and_keys_get_zeros(card, dtype, bk):
    """A query row whose keys are all masked has exactly zero dQ, and a key
    masked for every row (padding) exactly zero dK and dV."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    B, H, L, D = 2, 2, 140, 64
    g = torch.Generator().manual_seed(6)
    q, k, v, do = (torch.randn(B, H, L, D, generator=g).to(card, dtype)
                   for _ in range(4))
    bias = torch.randn(B, L, L, generator=g)
    bias[:, 5:9] = fa.MASK_VALUE             # rows 5-8: every key masked
    bias[:, :, 100:] = fa.MASK_VALUE         # keys 100-139: every row
    bias3, per_head, per_row = fa.normalize_bias(bias.to(card), B, H, L, L)
    flags = (D ** -0.5, False, 0.0, per_head, per_row)
    o, lse = fa._flash_fwd_cuda(q, k, v, bias3, None, *flags)
    plan = fa._bwd_plan(B, H, L, L, D, dtype, kernels.sm_count(card), bk=bk)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, bias3, None, o, lse, do,
                                    *flags, plan=plan)
    torch.cuda.synchronize()
    assert not bool(dq[:, :, 5:9].any())
    assert not bool(dk[:, :, 100:].any()) and not bool(dv[:, :, 100:].any())
    assert bool(dq[:, :, 9:].any()) and bool(dk[:, :, :100].any())


# the forward at every plan of the tuner's menu: B, H, Lq, Lk, D and the
# mask (the five of `chip_smoke.py` phase 6), ragged Lq != Lk, D 32-128
FWD_PLANS = [(64, 64), (64, 128), (128, 64), (128, 128)]
FWD_CASES = [(2, 3, 128, 128, 64, "none"), (2, 3, 128, 128, 64, "pad"),
             (2, 3, 100, 77, 32, "row"), (2, 3, 77, 77, 96, "causal"),
             (2, 3, 130, 200, 128, "pad_dropout"),
             (1, 2, 200, 65, 64, "causal"), (2, 2, 33, 300, 96, "pad_dropout"),
             (1, 2, 257, 129, 128, "row")]


def _fwd_args(card, dtype, B, H, Lq, Lk, D, mask, seed=8, offset=0):
    """Seeded operands of one forward call: q, k, v, bias3, seed and the
    flags.  ``offset`` elements shift q, k and v off 16-byte alignment (each
    a contiguous view into a larger buffer)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(seed)

    def operand(*shape):
        n = int(np.prod(shape))
        buf = torch.randn(n + offset, generator=g).to(card, dtype)
        return buf[offset:].view(*shape)
    q, k, v = operand(B, H, Lq, D), operand(B, H, Lk, D), operand(B, H, Lk, D)
    bias = None
    if mask in ("pad", "pad_dropout"):
        vl = torch.randint(1, Lk + 1, (B,), generator=g)
        bias = torch.where(torch.arange(Lk)[None] < vl[:, None], 0.0,
                           fa.MASK_VALUE).to(card)
    elif mask == "row":
        bias = torch.randn(B, Lq, Lk, generator=g)
        bias[0, :3] = fa.MASK_VALUE                 # fully masked rows
        bias = bias.to(card)
    bias3, per_head, per_row = (None, False, False) if bias is None \
        else fa.normalize_bias(bias, B, H, Lq, Lk)
    sd = torch.tensor([4242], dtype=torch.int32, device=card)
    rate = 0.1 if mask == "pad_dropout" else 0.0
    return (q, k, v, bias3, sd, D ** -0.5, mask == "causal", rate, per_head,
            per_row)


def _close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    return err <= tol * max(float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("bq,bk", FWD_PLANS)
@pytest.mark.parametrize("B,H,Lq,Lk,D,mask", FWD_CASES)
def test_flash_forward_every_plan_matches_plain(card, dtype, tol, bq, bk, B,
                                                H, Lq, Lk, D, mask):
    """Each (block_q, block_k) against the plain version, output and lse,
    two calls bit-equal, and three persistent blocks walking every item
    give the same bits (heads over 64 wide take 64 rows, f32 ones 64
    keys)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    args = _fwd_args(card, dtype, B, H, Lq, Lk, D, mask)
    plan = fa._fwd_plan(B, H, Lq, Lk, D, dtype, bq, bk)
    want_bk = 64 if dtype == torch.float32 and D > 64 else bk
    assert (plan.bq, plan.bk) == ((64 if D > 64 else bq), want_bk)
    assert plan.smem <= fa.SMEM_BLOCK
    kernels.reset_launch_counts()
    o, lse = fa._flash_fwd_cuda(*args, plan=plan)
    o2, lse2 = fa._flash_fwd_cuda(*args, plan=plan)
    o3, lse3 = fa._flash_fwd_cuda(*args, plan=plan._replace(grid=3))
    want_o, want_lse = fa.flash_fwd_reference(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_fwd"] == 3
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, o3) and torch.equal(lse, lse3)
    assert _close(o, want_o, tol), "out"
    assert _close(lse, want_lse, tol), "lse"


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("offset,D", [(1, 64), (0, 33), (3, 40)])
def test_flash_forward_unaligned_operands(card, dtype, tol, offset, D):
    """Operands off 16-byte alignment, or rows that are not whole 16-byte
    chunks, take the kernel's scalar loads and stores: the same results."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    args = _fwd_args(card, dtype, 2, 3, 90, 130, D, "pad_dropout",
                     offset=offset)
    assert offset == 0 or args[0].data_ptr() % 16
    for bq, bk in FWD_PLANS:
        plan = fa._fwd_plan(2, 3, 90, 130, D, dtype, bq, bk)
        o, lse = fa._flash_fwd_cuda(*args, plan=plan)
        want_o, want_lse = fa.flash_fwd_reference(*args)
        torch.cuda.synchronize()
        assert _close(o, want_o, tol) and _close(lse, want_lse, tol), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bq,bk", FWD_PLANS)
def test_flash_forward_masked_rows_give_zeros_and_zero_lse(card, dtype, bq,
                                                           bk):
    """A query row whose keys are all masked writes exactly zeros and
    lse = 0; its neighbours do not."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    B, H, L, D = 2, 2, 140, 64
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(B, H, L, D, generator=g).to(card, dtype)
               for _ in range(3))
    bias = torch.randn(B, L, L, generator=g)
    bias[:, 5:9] = fa.MASK_VALUE             # rows 5-8: every key masked
    bias[1, 70:] = fa.MASK_VALUE             # rows 70-139 of batch 1 too
    bias3, per_head, per_row = fa.normalize_bias(bias.to(card), B, H, L, L)
    plan = fa._fwd_plan(B, H, L, L, D, dtype, bq, bk)
    o, lse = fa._flash_fwd_cuda(q, k, v, bias3, None, D ** -0.5, False, 0.0,
                                per_head, per_row, plan=plan)
    torch.cuda.synchronize()
    lse = lse.reshape(B, H, L)
    assert not bool(o[:, :, 5:9].any()) and not bool(o[1, :, 70:].any())
    assert not bool(lse[:, :, 5:9].any()) and not bool(lse[1, :, 70:].any())
    assert bool(o[:, :, 9:70].all(dim=-1).any()) and bool(lse[0, :, 9:].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_forward_on_two_streams(card, dtype):
    """Forward calls on two streams at once give, each, the bits of the same
    call made alone."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    calls = [_fwd_args(card, dtype, 2, 3, 150, 260, 64, "pad_dropout",
                       seed=s) for s in (4, 5)]
    wants = [fa._flash_fwd_cuda(*a) for a in calls]
    streams = [torch.cuda.Stream(card) for _ in calls]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(10):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(fa._flash_fwd_cuda(*calls[i]))
    torch.cuda.synchronize()
    for want, got in zip(wants, outs):
        for o, lse in got:
            assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("mask", ["pad_dropout", "causal", "row"])
def test_flash_backward_on_the_new_forward_matches_plain(card, dtype, tol,
                                                         mask):
    """The backward run on the kernel forward's (o, lse) against the plain
    backward on the plain forward's."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    B, H, L, D = 2, 3, 128, 64
    args = _fwd_args(card, dtype, B, H, L, L, D, mask, seed=9)
    q, k, v, bias3, sd, *flags = args
    do = torch.randn(B, H, L, D, generator=torch.Generator().manual_seed(1)
                     ).to(card, dtype)
    o, lse = fa._flash_fwd_cuda(*args)
    got = fa._flash_bwd_cuda(q, k, v, bias3, sd, o, lse, do, *flags)
    o_ref, lse_ref = fa.flash_fwd_reference(*args)
    want = fa.flash_bwd_reference(q, k, v, bias3, sd, o_ref, lse_ref, do,
                                  *flags)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _close(a, b, tol), name


def test_flash_tune_launches_the_forward_and_warm_hits(card, tmp_path,
                                                       monkeypatch):
    """A cold ``tune("flash_attention", ...)`` times every candidate through
    the CUDA forward; a warm one runs no trial; the next call's plan is the
    tuned one."""
    from mxnet_tpu_torch.ops import autotune as at
    from mxnet_tpu_torch.ops import flash_attention as fa
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("MXTPU_FLASH_BLOCK_Q", raising=False)
    monkeypatch.delenv("MXTPU_FLASH_BLOCK_K", raising=False)
    shape = (2, 3, 128, 128, 64)
    at.clear_memory_cache()
    try:
        cands = fa._at_candidates(shape, "bfloat16")
        assert len(cands) == 4
        kernels.reset_launch_counts()
        cold = at.tune("flash_attention", shape, "bfloat16",
                       top_k=len(cands))
        trials = kernels.launch_counts()["flash_attention_fwd"]
        warm = at.tune("flash_attention", shape, "bfloat16")
        assert cold.trials == 4 and trials == 6 * cold.trials
        assert warm.cache_hit and warm.trials == 0
        assert kernels.launch_counts()["flash_attention_fwd"] == trials
        plan = fa._planned_fwd(*shape, torch.bfloat16, card)
        assert (plan.bq, plan.bk, plan.source) == (
            cold.config.block_q, cold.config.block_k, "tuned")
    finally:
        at.clear_memory_cache()


def test_flash_attention_kernel_raises_on_what_it_does_not_take(card):
    """Grouped K/V and a window launch the kernels (they raised before the
    band and the fold were ported), and so does a 256-wide head (it raised
    before the wide tiles); a head over 256 wide still raises by name."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 4, 8, 16, device=card)
    kv = torch.zeros(1, 2, 8, 16, device=card)
    kernels.reset_launch_counts()
    fa.flash_attention(q, kv, kv)
    fa.flash_attention(q, q, q, window=2)
    fa.flash_attention(q, kv, kv, causal=True, window=2)
    wide = torch.zeros(1, 1, 8, 256, device=card)
    fa.flash_attention(wide, wide, wide)
    assert kernels.launch_counts()["flash_attention_fwd"] == 4
    with pytest.raises(MXNetError, match="B4 part 2"):
        big = torch.zeros(1, 1, 8, 257, device=card)
        fa.flash_attention(big, big, big)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
def test_flash_backward_middle_visitor_ranges_and_tickets_reset(card, dtype,
                                                                 tol):
    """Causal with a window of 100 over 512 rows and 1024 keys, 64-key
    tiles: q tiles 3-7 are each visited by a strict middle range of key
    tiles (neither tile 0 nor the last), so their dQ tickets count and sum
    a range that starts past 0; keys 512-1023 are seen by no row.  Two
    calls give the same bits and leave every ticket zeroed; within
    tolerance of the plain version; unseen keys get exact zeros."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    args, kw, want = _flash_bwd_inputs(card, dtype, 2, 3, 512, 1024, 64,
                                       "none", True, 0.1, window=100)
    plan = fa._bwd_plan(2, 3, 512, 1024, 64, dtype, kernels.sm_count(card),
                        bk=64)
    assert (plan.key_tiles, plan.q_tiles) == (16, 8) and plan.tickets
    firsts = [max(0, 64 * qt - 100) // 64 for qt in range(8)]
    lasts = [(64 * qt + 63) // 64 for qt in range(8)]
    assert all(0 < f and last < 15 for f, last in zip(firsts[3:], lasts[3:]))
    got = fa._flash_bwd_cuda(*args, plan=plan, **kw)
    again = fa._flash_bwd_cuda(*args, plan=plan, **kw)
    torch.cuda.synchronize()
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, a2), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name
    assert not got[1][:, :, 512:].any() and not got[2][:, :, 512:].any()
    stream = torch.cuda.current_stream(card).cuda_stream
    tickets = fa._scratch_of[(card.index or 0, stream)][0]
    assert int(tickets.abs().sum()) == 0


@pytest.mark.parametrize("causal", [False, True])
def test_windowed_rows_past_every_key_get_zero_dq(card, causal):
    """Lq 300 over Lk 100 with a window of 20: rows past position 119 see
    no key, so no key tile visits their q tiles; the wrapper zeroes their
    dQ, the forward writes zeros with lse 0."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    args, kw, want = _flash_bwd_inputs(card, torch.float32, 1, 2, 300, 100,
                                       64, "pad", causal, 0.0, window=20,
                                       symmetric=True)
    q, k, v, bias3, sd = args[:5]
    o, lse = fa._flash_fwd_cuda(q, k, v, bias3, sd, *args[8:], window=20,
                                window_symmetric=True, lq=300)
    dq, dk, dv = fa._flash_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert not o[:, :, 120:].any() and not lse[:, 120:].any()
    assert not dq[:, :, 120:].any() and dq[:, :, :100].any()
    for a, b in zip((dq, dk, dv), want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_windowed_bert_on_the_card_matches_the_plain_attention(card):
    """`BertForPretraining(window=32)` (2 layers, hidden 256, 4 heads, L 128
    padded by ``valid_length``, dropout 0.1) forward and backward on the
    card, against the same model whose attention runs the plain versions
    (`multi_head_attention_reference`, i.e. `flash_attention_reference`)
    from the same seed: the band and the padding inside one kernel."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.models import bert as tbert
    from mxnet_tpu_torch.models.layers import _plain_twin
    cfg = tbert.BertConfig(vocab_size=1000, hidden_size=256, num_layers=2,
                           num_heads=4, intermediate_size=512,
                           max_position=128, dropout=0.1, window=32)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 1000, (4, 128), generator=g).to(card)
    vl = torch.tensor([128, 90, 37, 113], device=card)
    runs = []
    for plain in (False, True):
        m = tbert.BertForPretraining(cfg, device=card, seed=3)
        if plain:
            _plain_twin(m, norms=False)
        kernels.reset_launch_counts()
        with autograd.train_mode():
            mlm, nsp = m(ids, valid_length=vl)
        (mlm.float().square().mean() + nsp.float().sum()).backward()
        counts = kernels.launch_counts()
        assert counts["flash_attention_fwd"] == (0 if plain else 2)
        assert counts["flash_attention_bwd"] == (0 if plain else 2)
        runs.append([mlm.detach()] + [p.grad for p in m.parameters()])
    for a, b in zip(*runs):
        if b is None:
            continue
        err = float((a.float() - b.float()).abs().max())
        assert err <= 1e-4 * max(float(b.float().abs().max()), 1e-30)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("N,V", [(64, 30522), (37, 1001), (37, 1), (37, 9),
                                 (16, 50257)])
def test_softmax_xent_kernels_match_plain(card, dtype, tol, N, V):
    """Both kernels against their plain versions.  The forward's loss and
    lse are f32 computed from the same values on both sides, so they are
    held to 1e-4 of their scale in bf16 too; dx, written in x's type, to
    `tol`.  Rows start at every 16-byte phase (V 50257 in bf16 moves the
    start 2 bytes a row), labels fall outside [0, V) at both ends, and a
    row's first reads -- each thread's head or tail scalar and its first
    batch of vectors -- are all -inf."""
    from mxnet_tpu_torch.ops import softmax_xent as sx
    g = torch.Generator().manual_seed(3)
    x = 3 * torch.randn(N, V, generator=g)
    lab = torch.randint(0, V, (N,), generator=g)
    lab[0] = -1                                   # not clamped
    lab[2] = V                                    # past the last column
    if V > 8:
        per = 16 // (torch.finfo(dtype).bits // 8)
        first = per + sx.FWD_UNROLL * sx.FWD_THREADS * per
        x[:, 7] = float("-inf")                   # a masked column
        x[1, :min(V - 1, first)] = float("-inf")
        lab[lab == 7] = 8
        lab[1] = V - 1
    x, lab = x.to(card, dtype), lab.to(card, torch.int32)
    gr = torch.rand(N, generator=g).to(card)
    kernels.reset_launch_counts()
    xx = x.clone().requires_grad_()
    loss = sx.softmax_cross_entropy(xx, lab)
    loss.backward(gr)
    loss_k, lse_k = sx._xent_fwd_cuda(x, lab)
    loss_ref, lse = sx.xent_fwd_reference(x, lab)
    dx_ref = sx.xent_bwd_reference(x, lab, lse, gr)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["softmax_xent_fwd"] == 2
    assert kernels.launch_counts()["softmax_xent_bwd"] == 1
    assert bool(torch.isfinite(loss).all())
    assert torch.equal(loss.detach(), loss_k)
    for a, b, t in ((loss_k, loss_ref, 1e-4), (lse_k, lse, 1e-4),
                    (xx.grad, dx_ref, tol)):
        err = float((a.float() - b.float()).abs().max())
        assert err <= t * float(b.float().abs().max())


def test_f16_kernels_store_inf_past_the_range_as_the_casts_do(card):
    """In f16 a gradient past the range is +-inf in the kernels' outputs,
    exactly where the plain versions' casts put it (nothing saturates at
    65504): a loss scaler must see the same overflow.  Uniform attention
    (q = k = 0) over twice as many rows as keys gives dV = 2 * dO = 1.2e5
    in every element, dQ and dK exactly 0; cross-entropy over equal logits
    with g = 1e9 gives dx = +-1e6 everywhere."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import softmax_xent as sx
    g = torch.Generator().manual_seed(5)
    q = torch.zeros(2, 3, 128, 64, device=card, dtype=torch.float16)
    k = torch.zeros(2, 3, 64, 64, device=card, dtype=torch.float16)
    v = torch.randn(2, 3, 64, 64, generator=g).to(card, torch.float16)
    do = torch.full_like(q, 6e4)
    kernels.reset_launch_counts()
    for flash in (fa.flash_attention, fa.flash_attention_reference):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = flash(qq, kk, vv)
        o.backward(do)
        assert bool(torch.isfinite(o).all())
        assert bool(torch.isposinf(vv.grad).all())
        assert not bool(qq.grad.abs().any()) and \
            not bool(kk.grad.abs().any())
    x = torch.zeros(8, 1000, device=card, dtype=torch.float16)
    lab = torch.arange(8, device=card, dtype=torch.int32)
    gr = torch.full((8,), 1e9, device=card)
    loss, lse = sx._xent_fwd_cuda(x, lab)
    dx = sx._xent_bwd_cuda(x, lab, lse, gr)
    want = sx.xent_bwd_reference(x, lab, lse, gr)
    torch.cuda.synchronize()
    assert kernels.DTYPE_LAUNCHES[("flash_attention_bwd", "float16")] == 1
    assert bool(torch.isfinite(loss).all())
    assert torch.equal(torch.isposinf(dx), torch.isposinf(want))
    assert torch.equal(torch.isneginf(dx), torch.isneginf(want))
    assert not bool(torch.isfinite(dx).any())


def test_kernels_raise_on_a_dtype_they_do_not_take(card):
    """float64 reaches neither kernel: the dispatchers raise by name (no
    plain version, SDPA or `F.cross_entropy` in their place)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import softmax_xent as sx
    q = torch.zeros(1, 2, 8, 16, device=card, dtype=torch.float64)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        fa.flash_attention(q, q, q)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        sx.softmax_cross_entropy(torch.zeros(4, 9, device=card,
                                             dtype=torch.float64),
                                 torch.zeros(4, dtype=torch.int32,
                                             device=card))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,h", [(37, 200), (64, 768), (3, 4099)])
@pytest.mark.parametrize("rms,residual", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_fused_norm_kernel_matches_plain(card, dtype, tol, rows, h, rms,
                                         residual):
    from mxnet_tpu_torch.ops import fused_norm as fn
    g = torch.Generator().manual_seed(5)
    x = torch.randn(rows, h, generator=g).to(card, dtype)
    r = torch.randn(rows, h, generator=g).to(card, dtype) if residual \
        else None
    gamma = (torch.rand(h, generator=g) + 0.5).to(card)
    beta = None if rms else torch.randn(h, generator=g).to(card)
    kernels.reset_launch_counts()
    got = fn._norm_cuda(x, r, gamma, beta, 1e-5, rms)
    want = fn.norm_plain(x, r, gamma, beta, 1e-5, rms)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == 1
    got = got if residual else (got,)
    want = want if residual else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max())


def test_fused_norm_dispatch_launches_and_differentiates(card):
    from mxnet_tpu_torch.ops import nn as tnn
    x = torch.randn(4, 16, 768, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    gamma = torch.ones(768, device=card, requires_grad=True)
    beta = torch.zeros(768, device=card, requires_grad=True)
    kernels.reset_launch_counts()
    y = tnn.layer_norm(x, gamma, beta)          # MXTPU_PALLAS=auto
    y.float().sum().backward()
    assert kernels.launch_counts()["fused_norm"] == 1
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    assert gamma.grad.dtype == torch.float32


NORM_CASES = [(64, 768), (37, 200), (5, 1), (3, 16384), (3, 4099)]
NORM_BLOCK_ROWS = (8, 16, 32, 64, 128, 256, 512, 1024)


@pytest.mark.parametrize("dtype,pdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("rows,h", NORM_CASES)
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("with_beta", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_norm_every_plan_matches_plain(card, dtype, pdtype, rows, h,
                                             rms, residual, with_beta,
                                             offset):
    """Both variants ("warp" to h 1024, "block" above), 16-byte and
    one-element loads (an operand one element past an aligned address
    takes the narrow plan), at every block_rows of JAX's menu: within 1e-4
    (f32) / 2e-2 (bf16) of the output scale, and two calls bit-equal."""
    from mxnet_tpu_torch.ops import fused_norm as fn
    g = torch.Generator().manual_seed(9)

    def operand():
        buf = torch.randn(rows * h + offset, generator=g).to(card, dtype)
        return buf[offset:].view(rows, h)
    x = operand()
    r = operand() if residual else None
    gamma = (torch.rand(h, generator=g) + 0.5).to(card, pdtype)
    beta = torch.randn(h, generator=g).to(card, pdtype) if with_beta \
        else None
    want = fn.norm_plain(x, r, gamma, beta, 1e-5, rms)
    want = want if residual else (want,)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for br in NORM_BLOCK_ROWS:
        plan = fn._planned(rows, h, dtype, pdtype, x.device,
                           fn._aligned(x, r), br)
        assert plan.vec == 1 or offset == 0
        kernels.reset_launch_counts()
        got = fn._norm_cuda(x, r, gamma, beta, 1e-5, rms, block_rows=br)
        again = fn._norm_cuda(x, r, gamma, beta, 1e-5, rms, block_rows=br)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fused_norm"] == 2
        got = got if residual else (got,)
        again = again if residual else (again,)
        for a, a2, b in zip(got, again, want):
            assert a.dtype == dtype
            assert torch.equal(a, a2), (br, plan)
            err = float((a.float() - b.float()).abs().max())
            assert err <= tol * float(b.float().abs().max()), (br, plan)


def test_fused_norm_wrappers_launch_at_any_width(card):
    """`fused_layer_norm`, `fused_rms_norm`, `layer_norm_residual` and
    `rms_norm_residual` launch the kernel on a CUDA tensor, including an
    x at a storage offset (the narrow plan) and h = 16384 ("block")."""
    from mxnet_tpu_torch.ops import fused_norm as fn
    for h, off in ((768, 0), (768, 1), (16384, 0), (200, 1)):
        buf = torch.randn(6 * h + off, device=card, dtype=torch.bfloat16)
        x = buf[off:].view(2, 3, h)
        r = torch.randn_like(x)
        gamma = torch.rand(h, device=card) + 0.5
        beta = torch.randn(h, device=card)
        kernels.reset_launch_counts()
        outs = [fn.fused_layer_norm(x, gamma, beta, use_kernel=True),
                fn.fused_rms_norm(x, gamma, use_kernel=True),
                *fn.layer_norm_residual(x, r, gamma, beta, use_kernel=True),
                *fn.rms_norm_residual(x, r, gamma, use_kernel=True)]
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fused_norm"] == 4
        assert all(o.dtype == torch.bfloat16 and o.shape == x.shape
                   for o in outs)
        want = fn.norm_plain(x.reshape(-1, h), None, gamma, beta, 1e-5,
                             False)
        err = float((outs[0].reshape(-1, h).float() - want.float()).abs()
                    .max())
        assert err <= 2e-2 * float(want.float().abs().max())


def test_fused_norm_tune_launches_the_kernel_and_warm_hits(card, tmp_path,
                                                          monkeypatch):
    from mxnet_tpu_torch.ops import autotune as at
    from mxnet_tpu_torch.ops import fused_norm as fn
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("MXTPU_AUTOTUNE", raising=False)
    at.clear_memory_cache()
    try:
        shape = (1280, 768)
        n = len(fn._candidates(shape, "bfloat16"))
        kernels.reset_launch_counts()
        cold = at.tune("fused_norm", shape, "bfloat16", runs=2, top_k=n)
        assert cold.trials == n
        assert kernels.launch_counts()["fused_norm"] == n * (1 + 2)
        warm = at.tune("fused_norm", shape, "bfloat16")
        assert warm.cache_hit and warm.trials == 0
        p = fn._planned(1280, 768, torch.bfloat16, torch.float32, card, True)
        assert (p.source, p.block_rows) == ("tuned", cold.config.block_rows)
    finally:
        at.clear_memory_cache()


def test_norm_tune_picks_the_least_event_timed_block_rows(card, tmp_path,
                                                          monkeypatch):
    """Two cold ``tune("fused_norm", (8192, 768), "bfloat16")`` runs over
    JAX's whole block_rows menu, timed by CUDA events after an L2 flush:
    each picks the candidate with the least time among its trials, and the
    two pick the same block_rows or two whose times lie within 3% of each
    other in both runs."""
    from mxnet_tpu_torch.ops import autotune as at
    from mxnet_tpu_torch.ops import fused_norm as fn
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("MXTPU_AUTOTUNE", raising=False)
    shape = (8192, 768)
    n = len(fn._candidates(shape, "bfloat16"))
    picks = []
    try:
        for _ in range(2):
            at.clear_memory_cache()
            for f in tmp_path.iterdir():
                f.unlink()                  # cold: nothing on disk either
            res = at.tune("fused_norm", shape, "bfloat16", top_k=n)
            assert not res.cache_hit and res.trials == n
            ms = {dict(k)["block_rows"]: v for k, v in
                  res.timings_ms.items()}
            assert ms[res.config.block_rows] == min(ms.values())
            picks.append((res.config.block_rows, ms))
    finally:
        at.clear_memory_cache()
    (a, ms_a), (b, ms_b) = picks
    assert a == b or (ms_a[b] <= 1.03 * ms_a[a] and
                      ms_b[a] <= 1.03 * ms_b[b]), picks


# one step of a 16-bit type, relative to the value
STEP16 = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}


def _close16(a, b, atol=2e-6):
    """`a` within one step of its 16-bit type of `b` (plus `atol`, the
    fused multiply-adds' f32 residue), or within atol of an f32 `b`."""
    if a.dtype in STEP16:
        torch.testing.assert_close(a.float(), b.float(),
                                   rtol=STEP16[a.dtype], atol=atol)
    else:
        torch.testing.assert_close(a, b, rtol=0, atol=atol)


OPT_CASES = {"adam": ("Adam", {}), "adamw": ("AdamW", {}),
             "sgd": ("SGD", {}), "sgd_momentum": ("SGD", {"momentum": 0.9}),
             "lamb": ("LAMB", {}),
             "lamb_bounds": ("LAMB", {"lower_bound": 5.0,
                                      "upper_bound": 20.0,
                                      "bias_correction": False})}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
def test_optimizer_kernels_match_plain(card, name, wdtype):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    cls, kw = OPT_CASES[name]
    opt = getattr(topt, cls)(learning_rate=0.01, **kw)
    g = torch.Generator().manual_seed(6)
    sizes = {"a": 70001, "b": 1000, "c": 37, "d": 8}
    params = {n: torch.randn(k, generator=g).to(card, wdtype)
              for n, k in sizes.items()}
    params["d"] = params["d"].float()                  # a second group
    grads = {n: (3 * torch.randn(p.shape, generator=g)).to(card, p.dtype)
             for n, p in params.items()}
    states = {n: tuple(torch.rand(p.shape, generator=g).to(card)
                       for _ in opt.create_state(p))
              for n, p in params.items()}
    hp = {"lr": 0.01, "wd": 0.01, "rescale_grad": 0.5,
          "clip_gradient": 1.0, "t": 3.0}
    hp = {k: torch.tensor(v, device=card) for k, v in hp.items()}
    want_p, want_s = fo.kernel_plain(opt, params, grads, states, hp)
    kernels.reset_launch_counts()
    fo.apply_updates(opt, params, grads, states, hp, use_kernel=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    groups = 1 if wdtype == torch.float32 else 2
    if cls == "LAMB":
        # phases A and B once per (weight, state) dtype group
        assert counts["lamb_phase_a"] == groups
        assert counts["lamb_phase_b"] == groups
    else:
        assert counts["fused_optimizer_chunk"] == groups
    # each launch counted under its group's weight dtype
    names = ("lamb_phase_a", "lamb_phase_b") if cls == "LAMB" else \
        ("fused_optimizer_chunk",)
    assert kernels.DTYPE_LAUNCHES == {
        (k, d): 1 for k in names for d in {str(wdtype)[6:], "float32"}}
    for n in params:
        _close16(params[n], want_p[n])
        for a, b in zip(states[n], want_s[n]):
            torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", ["adam", "sgd_momentum", "lamb"])
def test_optimizer_kernels_skip_is_bit_identical(card, name):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    cls, kw = OPT_CASES[name]
    opt = getattr(topt, cls)(learning_rate=0.01, **kw)
    for skip, same in ((True, True), (False, False)):
        params = {"w": torch.randn(5000, device=card)}
        grads = {"w": torch.randn(5000, device=card)}
        grads["w"][7] = float("nan")
        states = {"w": tuple(torch.rand(5000, device=card)
                             for _ in opt.create_state(params["w"]))}
        before = params["w"].clone(), [s.clone() for s in states["w"]]
        hp = {"lr": 0.1, "wd": 0.0, "rescale_grad": 1.0,
              "clip_gradient": None, "t": 1.0}
        fo.apply_updates(opt, params, grads, states, hp,
                         skip=torch.tensor(skip, device=card),
                         use_kernel=True)
        torch.cuda.synchronize()
        assert torch.equal(params["w"], before[0]) == same
        assert all(torch.equal(a, b) == same
                   for a, b in zip(states["w"], before[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("R,N,H", [(10240, 8193, 768), (53, 24, 256),
                                   (31, 17, 100), (10240, 8193, 100)])
def test_moe_gather_kernel_matches_plain_bit_for_bit(card, dtype, R, N, H):
    from mxnet_tpu_torch.ops import moe_dispatch as md
    g = torch.Generator().manual_seed(9)
    src = torch.randn(N, H, generator=g).to(card, dtype)
    idx = torch.randint(0, N + 1, (R,), generator=g)   # N is the sentinel
    idx[:3] = N
    idx = idx.to(card, torch.int32)
    scale = torch.rand(R, generator=g).to(card)
    kernels.reset_launch_counts()
    a = md.gather_rows(src, idx)
    b = md.gather_rows(src, idx, scale, counter="moe_combine")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_dispatch"] == 1
    assert kernels.launch_counts()["moe_combine"] == 1
    assert torch.equal(a, md.gather_rows_plain(src, idx))
    assert torch.equal(b, md.gather_rows_plain(src, idx, scale))
    assert not a[:3].any() and not b[:3].any()
    with pytest.raises(MXNetError, match="int32"):
        md.gather_rows(src, idx.long())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_moe_gather_kernel_takes_unaligned_rows(card, dtype):
    """A source one element past a 16-byte boundary moves in one-element
    pieces, bit-equal to the plain version, scale or none."""
    from mxnet_tpu_torch.ops import moe_dispatch as md
    N, H, R = 700, 768, 1500
    g = torch.Generator().manual_seed(10)
    src = torch.randn(N * H + 1, generator=g).to(card, dtype)[1:].view(N, H)
    assert md._piece(H, src.element_size(), src.data_ptr(), 0) == \
        src.element_size()
    idx = torch.randint(-2, N + 2, (R,), generator=g).to(card, torch.int32)
    scale = (torch.rand(R, generator=g) - 0.25).to(card)
    a = md.gather_rows(src, idx)
    b = md.gather_rows(src, idx, scale, counter="moe_combine")
    torch.cuda.synchronize()
    assert torch.equal(a, md.gather_rows_plain(src, idx))
    assert torch.equal(b, md.gather_rows_plain(src, idx, scale))


@pytest.mark.parametrize("h", [200, 768])
def test_moe_dispatch_and_combine_launch_the_gather_at_any_width(card, h):
    """On the card the policy alone picks the route: an H that JAX's
    lane rule refuses (200) launches the gather as 768 does, one dispatch
    and one combine, bit-equal to the plain version."""
    from mxnet_tpu_torch.ops import moe_dispatch as md
    t, e, c = 53, 4, 6
    g = torch.Generator().manual_seed(5)
    x = torch.randn(t, h, generator=g).to(card)
    expert = torch.randint(0, e, (t,), generator=g)
    pos = torch.zeros(t, dtype=torch.int64)
    for k in range(e):
        sel = expert == k
        pos[sel] = torch.arange(int(sel.sum()))
    kept = pos < c
    gate = torch.rand(t, generator=g)
    expert, pos, kept, gate = (v.to(card) for v in (expert, pos, kept, gate))
    kernels.reset_launch_counts()
    buf = md.moe_dispatch(x, expert, pos, kept, e, c)
    out = md.moe_combine(buf, expert, pos, kept, gate)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["moe_dispatch"] == counts["moe_combine"] == 1
    inv = md.dispatch_index(expert, pos, kept, e, c)
    slot, scale = md.combine_index(expert, pos, kept, gate, e, c)
    assert torch.equal(buf.reshape(e * c, h), md.gather_rows_plain(x, inv))
    assert torch.equal(out, md.gather_rows_plain(buf.reshape(e * c, h), slot,
                                                 scale))
    assert not out[~kept].any()


def test_tuned_chunks_give_the_same_bits(card):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    opt = topt.Adam(learning_rate=1e-3)
    g = torch.Generator().manual_seed(4)
    w0 = torch.randn(300_001, generator=g).to(card)
    gr = torch.randn(300_001, generator=g).to(card)
    hp = {"lr": 1e-3, "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": None,
          "t": 1.0}
    hp = {k: None if v is None else torch.tensor(v, device=card)
          for k, v in hp.items()}
    outs = []
    for chunk in fo._TUNE_CHUNKS:
        p = {"w": w0.clone()}
        st = {"w": opt.create_state(w0)}
        keep, hptr = fo._device_hp(hp, None, w0.device)
        fo._chunk_cuda(opt, 0, ["w"], p, {"w": gr}, st, hptr, w0.device,
                       chunk)
        torch.cuda.synchronize()
        outs.append((p["w"], st["w"]))
    for w, s in outs[1:]:
        assert torch.equal(w, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(s, outs[0][1]))


def test_moe_train_step_on_the_card(card):
    """Two steps of the MoE layer through `TrainStep` on the kernel route:
    one dispatch and one combine gather and one chunk launch a step, and
    the losses equal the plain route's within 1e-4."""
    import os
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import MoEFeedForward, TrainStep
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 64, 256, generator=g).to(card)
    y = torch.randn(4, 64, 256, generator=g).to(card)

    def loss_fn(out, xx, yy):
        return torch.mean((out[0] - yy) ** 2) + 0.01 * out[1]

    losses = {}
    for mode in ("auto", "reference"):
        old = os.environ.get("MXTPU_PALLAS")
        os.environ["MXTPU_PALLAS"] = mode
        try:
            layer = MoEFeedForward(256, 512, 4, device=card, seed=0)
            step = TrainStep(layer, Adam(learning_rate=1e-3), loss_fn,
                             num_model_args=1)
            kernels.reset_launch_counts()
            losses[mode] = [float(step(x, y)) for _ in range(2)]
            counts = kernels.launch_counts()
        finally:
            if old is None:
                os.environ.pop("MXTPU_PALLAS")
            else:
                os.environ["MXTPU_PALLAS"] = old
        if mode == "auto":
            assert counts["moe_dispatch"] == counts["moe_combine"] == 2
            assert counts["fused_optimizer_chunk"] == 2
        else:
            assert not any(counts.values())
    np.testing.assert_allclose(losses["auto"], losses["reference"],
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd_momentum", "lamb"])
def test_optimizer_kernels_with_16bit_state_match_plain(card, name, dtype):
    """16-bit weights with state in their dtype (the `Trainer`'s state of
    a bf16 or f16 model): the decay of the state rounds the scalar and the
    product to that dtype in the kernel as in the plain version; state and
    weights within one step of the dtype, and atol 2e-6 (as above): the
    kernel fuses a multiply-add the plain version rounds twice, which can
    flip a 16-bit rounding or leave an f32 residual where the plain sum
    cancels to 0."""
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    cls, kw = OPT_CASES[name]
    opt = getattr(topt, cls)(learning_rate=0.01, **kw)
    g = torch.Generator().manual_seed(7)
    params = {n: torch.randn(k, generator=g).to(card, dtype)
              for n, k in (("a", 70001), ("b", 37))}
    grads = {n: torch.randn(p.shape, generator=g).to(card, dtype)
             for n, p in params.items()}
    states = {n: tuple((0.1 * torch.rand(p.shape, generator=g)).to(
        card, dtype) for _ in opt.create_state(p))
        for n, p in params.items()}
    hp = {k: torch.tensor(v, device=card) for k, v in (
        ("lr", 0.01), ("wd", 0.01), ("rescale_grad", 0.5), ("t", 3.0))}
    hp["clip_gradient"] = None
    want_p, want_s = fo.kernel_plain(opt, params, grads, states, hp)
    fo.apply_updates(opt, params, grads, states, hp, use_kernel=True)
    torch.cuda.synchronize()
    for n in params:
        _close16(params[n], want_p[n])
        for a, b in zip(states[n], want_s[n]):
            assert a.dtype == dtype, n
            _close16(a, b)


# the chunk rules after Adam, AdamW and SGD: (class, kwargs, state slots
# drawn positive -- the rules take their roots); and all nine
CHUNK_RULES = {"nag": ("NAG", {}, ()),
               "signum": ("Signum", {"momentum": 0.0, "wd_lh": 0.01}, ()),
               "signum_momentum": ("Signum", {"wd_lh": 0.01}, ()),
               "adabelief": ("AdaBelief", {}, (1,)),
               "adamax": ("Adamax", {}, (1,)),
               "adadelta": ("AdaDelta", {}, (0, 1)),
               "ftml": ("FTML", {}, (0, 1))}
ALL_CHUNK_RULES = dict(CHUNK_RULES, adam=("Adam", {}, (1,)),
                       adamw=("AdamW", {}, (1,)), sgd=("SGD", {}, ()),
                       sgd_momentum=("SGD", {"momentum": 0.9}, ()))


def _chunk_tree(card, name, wdtype, sdtype, seed):
    """Leaves of 70001, 1000, 37 and 8 elements (the last f32: a second
    dtype group for 16-bit weights), weights N(0, 1), gradients N(0, 9),
    the rule's state in `sdtype` (positive where it takes a root, else
    N(0, 0.01)); the f32 leaf's state stays f32 beside f16 state (no path
    pairs f32 weights with f16 state)."""
    from mxnet_tpu_torch import optimizer as topt
    cls, kw, pos = ALL_CHUNK_RULES[name]
    opt = getattr(topt, cls)(learning_rate=0.01, **kw)
    g = torch.Generator().manual_seed(seed)
    sizes = {"a": 70001, "b": 1000, "c": 37, "d": 8}
    params = {n: torch.randn(k, generator=g).to(card, wdtype)
              for n, k in sizes.items()}
    params["d"] = params["d"].float()
    grads = {n: (3 * torch.randn(p.shape, generator=g)).to(card, p.dtype)
             for n, p in params.items()}
    states = {n: tuple(
        (torch.rand(p.shape, generator=g) + 0.5 if k in pos
         else 0.1 * torch.randn(p.shape, generator=g)).to(
            card, torch.float32 if sdtype == torch.float16 and
            p.dtype == torch.float32 else sdtype)
        for k, _ in enumerate(opt.create_state(p)))
        for n, p in params.items()}
    hp = {k: torch.tensor(v, device=card) for k, v in (
        ("lr", 0.01), ("wd", 0.01), ("rescale_grad", 0.5),
        ("clip_gradient", 1.0), ("t", 3.0))}
    return opt, params, grads, states, hp


@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CHUNK_RULES))
def test_chunk_rules_match_plain(card, name, wdtype, sdtype):
    """NAG, Signum (with and without momentum), AdaBelief, Adamax,
    AdaDelta and FTML through the chunk kernel against `kernel_plain`:
    one launch per dtype group, FTML's three state slots written.  f32
    within atol 2e-6 and rtol 1e-6 (the kernel fuses multiply-adds the
    plain version rounds twice; FTML's d reaches ~1e3), 16-bit values
    within one bf16 step."""
    _check_chunk_rule(card, name, wdtype, sdtype)


@pytest.mark.parametrize("sdtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("name", sorted(ALL_CHUNK_RULES))
def test_chunk_rules_over_f16_weights_match_plain(card, name, sdtype):
    """Every chunk rule over f16 weights with f32 state (`TrainStep`) and
    with f16 state (the `Trainer`): the kernel's (f16, f32) and (f16, f16)
    instantiations against `kernel_plain`, one launch per dtype group
    counted under float16 (and float32 for the f32 leaf), 16-bit values
    within one f16 step (2**-10 of the value)."""
    _check_chunk_rule(card, name, torch.float16, sdtype)


def _check_chunk_rule(card, name, wdtype, sdtype):
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    opt, params, grads, states, hp = _chunk_tree(card, name, wdtype,
                                                 sdtype, seed=11)
    want_p, want_s = fo.kernel_plain(opt, params, grads, states, hp)
    kernels.reset_launch_counts()
    fo.apply_updates(opt, params, grads, states, hp, use_kernel=True)
    torch.cuda.synchronize()
    groups = len({(p.dtype, tuple(s.dtype for s in states[n]))
                  for n, p in params.items()})
    assert kernels.launch_counts()["fused_optimizer_chunk"] == groups
    for n in params:
        got = [params[n]] + list(states[n])
        want = [want_p[n]] + list(want_s[n])
        assert len(got) == 1 + fo._SLOTS[fo._chunk_rule(opt)]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype, n
            if a.dtype in STEP16:
                _close16(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=2e-6)
    if wdtype == torch.float16:
        assert kernels.DTYPE_LAUNCHES == {
            ("fused_optimizer_chunk", "float16"): 1,
            ("fused_optimizer_chunk", "float32"): 1}


@pytest.mark.parametrize("name", sorted(CHUNK_RULES))
def test_chunk_rules_skip_is_bit_identical(card, name):
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    for skip, same in ((True, True), (False, False)):
        opt, params, grads, states, hp = _chunk_tree(
            card, name, torch.bfloat16, torch.float32, seed=12)
        grads["b"][7] = float("nan")
        before = ({n: p.clone() for n, p in params.items()},
                  {n: [t.clone() for t in st] for n, st in states.items()})
        fo.apply_updates(opt, params, grads, states, hp,
                         skip=torch.tensor(skip, device=card),
                         use_kernel=True)
        torch.cuda.synchronize()
        for n in params:
            assert torch.equal(params[n], before[0][n]) == same, n
            assert all(torch.equal(a, b) == same
                       for a, b in zip(states[n], before[1][n])), n


def _lamb_tree(card, wdtype, seed):
    """Leaves of 70001, 768, 1 and 2 * LAMB_CHUNK + 5 elements in
    `wdtype`, a 768 f32 leaf (a second group for bf16), and a 1001-element
    leaf whose weight, gradient and state sit one element past an aligned
    address (the one-element path)."""
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    g = torch.Generator().manual_seed(seed)
    sizes = {"a": 70001, "b": 768, "c": 1, "d": 2 * fo.LAMB_CHUNK + 5,
             "e": 1001, "f": 768}

    def make(n, dt, off, scale=1.0, pos=False):
        buf = torch.rand(n + off, generator=g) if pos else \
            torch.randn(n + off, generator=g)
        return (scale * buf).to(card, dt)[off:]
    params, grads, states = {}, {}, {}
    for k, n in sizes.items():
        dt = torch.float32 if k == "f" else wdtype
        off = 1 if k == "e" else 0
        params[k] = make(n, dt, off)
        grads[k] = make(n, dt, off, 3.0)
        states[k] = (make(n, torch.float32, off, 0.1),
                     make(n, torch.float32, off, 1.0, True))
    return params, grads, states


def _clone(t):
    """A copy of the 1-D `t` at the same address offset modulo 16 bytes
    (``clone`` would align it), so an unaligned leaf stays unaligned."""
    off = t.data_ptr() % 16 // t.element_size()
    out = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:]
    return out.copy_(t)


def _clones(params, states):
    return ({n: _clone(t) for n, t in params.items()},
            {n: tuple(_clone(t) for t in st) for n, st in states.items()})


def _lamb_hp(card):
    hp = {k: torch.tensor(v, device=card) for k, v in (
        ("lr", 0.01), ("wd", 0.01), ("rescale_grad", 0.5), ("t", 3.0),
        ("clip_gradient", 1.0))}
    return hp


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
@pytest.mark.parametrize("kw", [{}, {"lower_bound": 5.0, "upper_bound": 20.0,
                                     "bias_correction": False}])
def test_lamb_phase_a_once_per_group_matches_plain(card, wdtype, kw):
    """One phase-A launch per (weight, state) dtype group over leaves of
    1, 768 and 70001 elements and one at an unaligned address; B once per
    group too; within the tolerances of `test_optimizer_kernels_match_plain`;
    two updates from the same inputs bit-equal; ``skip`` every bit
    unchanged."""
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    opt = topt.LAMB(learning_rate=0.01, **kw)
    params, grads, states = _lamb_tree(card, wdtype, 11)
    assert params["e"].data_ptr() % 16 != 0
    hp = _lamb_hp(card)
    want_p, want_s = fo.kernel_plain(opt, params, grads, states, hp)
    runs = []
    for _ in range(2):
        p, s = _clones(params, states)
        kernels.reset_launch_counts()
        fo.apply_updates(opt, p, grads, s, hp, use_kernel=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        groups = 1 if wdtype == torch.float32 else 2
        assert counts["lamb_phase_a"] == counts["lamb_phase_b"] == groups
        assert kernels.DTYPE_LAUNCHES[
            ("lamb_phase_a", str(wdtype)[6:])] == 1
        runs.append((p, s))
    (p, s), (p2, s2) = runs
    for n in params:
        assert torch.equal(p[n], p2[n]) and all(
            torch.equal(a, b) for a, b in zip(s[n], s2[n])), n
        _close16(p[n], want_p[n])
        for a, b in zip(s[n], want_s[n]):
            torch.testing.assert_close(a, b, rtol=0, atol=2e-6)
    # skip: every weight and state bit unchanged (a NaN gradient too)
    grads["a"][5] = float("nan")
    p, s = _clones(params, states)
    fo.apply_updates(opt, p, grads, s, hp, use_kernel=True,
                     skip=torch.tensor(True, device=card))
    torch.cuda.synchronize()
    for n in params:
        assert torch.equal(p[n], params[n]), n
        assert all(torch.equal(a, b) for a, b in zip(s[n], states[n])), n


def _ulps(a, b):
    """Units in the last place between two tensors of one float dtype,
    element by element (the bit patterns as ordered integers)."""
    it, mag = {torch.float32: (torch.int32, 0x7fffffff),
               torch.bfloat16: (torch.int16, 0x7fff),
               torch.float16: (torch.int16, 0x7fff)}[a.dtype]

    def ordered(x):
        i = x.contiguous().view(it).long()
        return torch.where(i < 0, -(i & mag), i)
    return (ordered(a) - ordered(b)).abs()


def _phase_b_tree(card, wdtype, seed):
    """One dtype group: leaves of 1, 768, LAMB_CHUNK + 1 and 70001
    elements, and a 1001-element leaf one element past an aligned address
    (phase B's one-element path), all in `wdtype` with f32 state."""
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    g = torch.Generator().manual_seed(seed)
    sizes = {"a": 1, "b": 768, "c": fo.LAMB_CHUNK + 1, "d": 70001,
             "e": 1001}

    def make(n, dt, off, scale=1.0, pos=False):
        buf = torch.rand(n + off, generator=g) if pos else \
            torch.randn(n + off, generator=g)
        return (scale * buf).to(card, dt)[off:]
    params, grads, states = {}, {}, {}
    for k, n in sizes.items():
        off = 1 if k == "e" else 0
        params[k] = make(n, wdtype, off)
        grads[k] = make(n, wdtype, off, 3.0)
        states[k] = (make(n, torch.float32, off, 0.1),
                     make(n, torch.float32, off, 1.0, True))
    return params, grads, states


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
def test_lamb_phase_b_within_one_ulp_of_float64(card, wdtype):
    """Phase B, one launch over the group: each weight within one unit in
    the last place of W of ``w - q * r`` computed on the host in float64
    from the same w, the r phase A left in the scratch and q = lr * ratio
    (f32, as the kernel forms it once a chunk), rounded to W; two launches
    on the same inputs bit-equal; the plan's one-element leaf is the
    unaligned one, and each phase's grid at least one block and at most
    one a code."""
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    opt = topt.LAMB(learning_rate=0.01)
    params, grads, states = _phase_b_tree(card, wdtype, 21)
    assert params["e"].data_ptr() % 16 != 0
    hp = _lamb_hp(card)
    names = sorted(params)
    runs = []
    for _ in range(2):
        p, s = _clones(params, states)
        assert p["e"].data_ptr() % 16 != 0
        kernels.reset_launch_counts()
        fo.apply_updates(opt, p, grads, s, hp, use_kernel=True)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["lamb_phase_b"] == 1
        runs.append(p)
    (plan,) = fo.last_lamb_plans
    assert (plan.vector_leaves, plan.element_leaves) == (4, 1)
    n_codes = fo._lamb_layout([params[n].numel() for n in names]).codes.size
    assert plan.block_entries == n_codes
    assert 1 <= plan.grid_a <= n_codes and 1 <= plan.grid_b <= n_codes
    # the group's r and ratios, as phase A left them for phase B
    dev = params["a"].device
    _, _, r, ratio = fo._lamb_scratch[
        (dev.index, torch.cuda.current_stream(dev).cuda_stream)]
    lay = fo._lamb_layout([params[n].numel() for n in names])
    lr = np.float32(0.01)
    for i, n in enumerate(names):
        assert torch.equal(runs[0][n], runs[1][n]), n
        k = params[n].numel()
        rr = r[lay.r_off[i]:lay.r_off[i] + k].double().cpu()
        q = float(lr * np.float32(ratio[i].item()))
        want = (params[n].double().cpu() - q * rr).to(wdtype)
        got = runs[0][n].cpu()
        assert int(_ulps(got, want).max()) <= 1, n


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
def test_lamb_skip_keeps_every_weight_bit(card, wdtype):
    """``skip`` with a NaN and an inf in every leaf's gradient (so r holds
    NaNs on every path of phase B): every weight and state bit is kept,
    in both dtype groups."""
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    opt = topt.LAMB(learning_rate=0.01)
    params, grads, states = _lamb_tree(card, wdtype, 22)
    for g in grads.values():
        g[0] = float("nan")
        g[-1] = float("inf")
    p, s = _clones(params, states)
    kernels.reset_launch_counts()
    fo.apply_updates(opt, p, grads, s, _lamb_hp(card), use_kernel=True,
                     skip=torch.tensor(True, device=card))
    torch.cuda.synchronize()
    groups = 1 if wdtype == torch.float32 else 2
    assert kernels.launch_counts()["lamb_phase_b"] == groups
    for n in params:
        assert int(_ulps(p[n], params[n]).max()) == 0, n
        for a, b in zip(s[n], states[n]):
            assert int(_ulps(a, b).max()) == 0, n


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
def test_lamb_on_two_streams(card, wdtype):
    """Two updates of two trees enqueued at once on two streams, each with
    its own scratch and tickets (phases A and B once a group each), give
    the bits of the same updates run one after the other."""
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    opt = topt.LAMB(learning_rate=0.01)
    hp = _lamb_hp(card)
    trees = [_lamb_tree(card, wdtype, seed) for seed in (12, 13)]
    solo = []
    for params, grads, states in trees:
        p, s = _clones(params, states)
        fo.apply_updates(opt, p, grads, s, hp, use_kernel=True)
        solo.append((p, s))
    torch.cuda.synchronize()
    both = []
    streams = [torch.cuda.Stream(card) for _ in trees]
    for params, grads, states in trees:
        both.append(_clones(params, states))
    torch.cuda.synchronize()
    for (params, grads, states), (p, s), st in zip(trees, both, streams):
        with torch.cuda.stream(st):
            fo.apply_updates(opt, p, grads, s, hp, use_kernel=True)
    torch.cuda.synchronize()
    for (p, s), (p1, s1) in zip(both, solo):
        for n in p:
            assert torch.equal(p[n], p1[n]), n
            assert all(torch.equal(a, b) for a, b in zip(s[n], s1[n])), n


def test_trainer_lamb_launches_phase_a_once_per_group(card):
    """The gluon `Trainer` with LAMB on the kernel route: state in each
    weight's dtype, so bf16 weights and an f32 vector make two groups —
    two phase-A and two phase-B launches a step."""
    from mxnet_tpu_torch.gluon import Trainer
    g = torch.Generator().manual_seed(14)
    ps = {"w": torch.nn.Parameter(torch.randn(64, 768, generator=g).to(
              card, torch.bfloat16)),
          "b": torch.nn.Parameter(torch.randn(768, generator=g).to(
              card, torch.bfloat16)),
          "gamma": torch.nn.Parameter(torch.rand(768, generator=g).to(card))}
    tr = Trainer(ps, "lamb", {"learning_rate": 0.01})
    before = {n: p.detach().clone() for n, p in ps.items()}
    for step in range(2):
        for p in ps.values():
            p.grad = torch.randn(p.shape, generator=g).to(card, p.dtype)
        kernels.reset_launch_counts()
        tr.step(8)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["lamb_phase_a"] == 2 and counts["lamb_phase_b"] == 2
    assert all(not torch.equal(p.detach(), before[n])
               for n, p in ps.items())


# ---------------------------------------------------------------------------
# the GPT training slice: causal flash at GPT's length, K1 with f32 queries
# over a bf16 pool, a small GPT step kernel against plain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_causal_flash_at_gpt_length_matches_plain(card, dtype, tol, rate):
    """GPT-2's attention length, L 1024, causal, with and without dropout:
    forward and backward within tolerance of the plain versions, two
    calls bit-equal."""
    kernels.reset_launch_counts()
    got, want = _flash_case(card, dtype, 1, 2, 1024, 1024, 64, "none", True,
                            rate)
    again, _ = _flash_case(card, dtype, 1, 2, 1024, 1024, 64, "none", True,
                           rate)
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 2
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, want, again):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name
        assert torch.equal(a, c), name


@pytest.mark.parametrize("C,H,Hkv", [(1, 12, 12), (16, 12, 12), (1, 8, 2),
                                     (4, 8, 1)])
@pytest.mark.parametrize("ps,D,maxp", [(16, 64, 8), (24, 128, 14)])
@pytest.mark.parametrize("one_page_a_split", [False, True])
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float16])
def test_paged_attention_f32_queries_over_a_bf16_pool(card, C, H, Hkv, ps, D,
                                                      maxp, one_page_a_split,
                                                      pdt):
    """A 16-bit model's serving step: f32 queries over a bf16 pool (type
    2) or an f16 pool (type 5).  K/V widen to f32 as they load and the
    arithmetic is the f32 route's, so the kernel stays within the f32
    tolerance (1e-4 of the output scale) of the plain version, which casts
    the gathered pool to f32; a query cast to 16 bits would land ~1e-2
    (bf16) or ~1e-3 (f16) off.  Launches count under the pool's dtype."""
    q, kp, vp, pt, ctx, start = _rpa_inputs(
        card, torch.float32, C, H, Hkv, D, ps, maxp, [0, 3 * ps + 5, 0],
        [C, C, 0])
    kp, vp = kp.to(pdt), vp.to(pdt)
    plan = pa._plan(3, H, Hkv, C, D, ps, maxp, pdt,
                    kernels.sm_count(card))
    if one_page_a_split:
        plan = _with_span(plan, ps, maxp * ps, D)
    kernels.reset_launch_counts()
    out = pa._rpa_cuda(q, kp, vp, pt, ctx, start, None, D ** -0.5,
                       plan=plan)
    again = pa._rpa_cuda(q, kp, vp, pt, ctx, start, None, D ** -0.5,
                         plan=plan)
    ref = pa.paged_attention_reference(q, kp, vp, pt, ctx, start)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ragged_paged_attention"] == 2
    assert kernels.DTYPE_LAUNCHES == {
        ("ragged_paged_attention", str(pdt)[6:]): 2}
    assert out.dtype == torch.float32 and torch.equal(out, again)
    for b in range(2):                              # slot 2 is empty
        err = float((out[b] - ref[b]).abs().max())
        assert err <= 1e-4 * float(ref[b].abs().max())
    assert not out[2].any()
    with pytest.raises(MXNetError, match="bfloat16 pool under float32"):
        pa.ragged_paged_attention(q.bfloat16(), kp.float(), vp.float(), pt,
                                  ctx, start)


def _gpt_step(card, remat, plain, seed=0, dtype="bfloat16"):
    """A 2-layer GPT (hidden 128, D 64, L 256, vocab 1000, dropout 0.1) in
    `dtype` through `TrainStep` with AdamW on the kernel route; ``plain``
    builds the oracle on the plain versions (no launch)."""
    import os
    from mxnet_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from mxnet_tpu_torch.models.layers import _plain_twin
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.ops.softmax_xent import (
        softmax_cross_entropy, softmax_cross_entropy_reference)
    from mxnet_tpu_torch.optimizer import AdamW
    from mxnet_tpu_torch.parallel import TrainStep
    cfg = GPTConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256, max_position=256,
                    dropout=0.1, dtype=dtype, remat=remat)
    model = GPTForCausalLM(cfg, device=card, seed=seed)
    xent = softmax_cross_entropy
    if plain:
        _plain_twin(model)
        xent = softmax_cross_entropy_reference

    def loss_fn(out, ids, lab):
        return xent(out.reshape(-1, cfg.vocab_size), lab.reshape(-1)).mean()
    old = os.environ.get("MXTPU_PALLAS")
    os.environ["MXTPU_PALLAS"] = "reference" if plain else "auto"
    try:
        step = TrainStep(model, AdamW(learning_rate=1e-3, wd=0.1), loss_fn,
                         num_model_args=1,
                         update=kernel_plain if plain else None)
    finally:
        if old is None:
            os.environ.pop("MXTPU_PALLAS")
        else:
            os.environ["MXTPU_PALLAS"] = old
    return model, step


def test_gpt_train_step_on_the_card(card):
    """Three bf16 steps of a small GPT on the kernel route: the launches a
    step (flash 2 + 2, twice the forward under remat; norms 5, and 4 more
    under remat; cross-entropy 1 + 1; the chunk once per dtype group),
    the trajectory within 1e-3 of the plain oracle's, remat within 1e-5 of
    no remat, and `warmup` leaving the dropout generator where it was."""
    g = torch.Generator().manual_seed(0)
    stream = torch.randint(0, 1000, (2, 257), generator=g).to(card)
    batch = (stream[:, :-1], stream[:, 1:])
    runs = {}
    for key, remat, plain in (("kernel", False, False), ("plain", False, True),
                              ("remat", "full", False)):
        model, step = _gpt_step(card, remat, plain)
        before = model.generator.get_state()
        step.warmup(*batch)
        assert torch.equal(model.generator.get_state(), before)
        kernels.reset_launch_counts()
        runs[key] = [float(step(*batch)) for _ in range(3)]
        counts = kernels.launch_counts()
        if plain:
            assert not any(counts.values())
            continue
        per = 2 if remat else 1
        assert counts["flash_attention_fwd"] == 3 * 2 * per
        assert counts["flash_attention_bwd"] == 3 * 2
        assert counts["fused_norm"] == 3 * (5 + 4 * (per - 1))
        assert counts["softmax_xent_fwd"] == counts["softmax_xent_bwd"] == 3
        assert counts["fused_optimizer_chunk"] == 3 * 2
    np.testing.assert_allclose(runs["kernel"], runs["plain"], rtol=1e-3)
    np.testing.assert_allclose(runs["remat"], runs["kernel"], rtol=1e-5)
    assert runs["kernel"][-1] < runs["kernel"][0]


# ---------------------------------------------------------------------------
# the int8 KV pool: K1's int8 variant, int8 activations, quantized serving
# ---------------------------------------------------------------------------

def _int8_pools(args):
    """`_rpa_inputs` with its f32 pools turned into int8 planes and scales
    (`quantize_kv`), as the serving engine writes them."""
    from mxnet_tpu_torch.contrib.quantization import quantize_kv
    q, kp, vp, *rest = args
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    return [q, kq, vq] + rest, dict(k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("qdt,tol", [(torch.float32, 1e-4),
                                     (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("C,H,Hkv", [(1, 12, 12), (1, 12, 3), (5, 12, 12),
                                     (5, 12, 3), (16, 12, 12), (16, 12, 3)])
@pytest.mark.parametrize("D", [24, 64, 72, 256])
@pytest.mark.parametrize("windowed", [False, True])
def test_paged_attention_int8_pool_matches_plain(card, qdt, tol, C, H, Hkv,
                                                 D, windowed):
    """The int8 variant under f32 and bf16 queries: few rows (C 1, the
    verification width 5 over MHA) and tiles (GQA folds, C 16), rows of
    16-byte and 8-byte pieces (D 72, 24), D 256, with and without a window,
    an empty slot and a slot with no key; the default plan, one split and
    one page a split, two calls bit-equal, the int8 counter alone."""
    ps, maxp = 16, 12
    cap = ps * maxp
    start, nt = [0, 37, 100, 150, 7], [C, C, min(C, 3), C, 0]
    args, sc = _int8_pools(_rpa_inputs(card, torch.float32, C, H, Hkv, D,
                                       ps, maxp, start, nt, seed=D + C))
    args[0] = args[0].to(qdt)
    args[4][4] = 0
    window = 30 if windowed else None
    scale = D ** -0.5
    ref = pa.paged_attention_reference(*args, window=window, scale=scale,
                                       **sc)
    plan = pa._plan(5, H, Hkv, C, D, ps, maxp, torch.int8,
                    kernels.sm_count(card))
    assert plan.variant == ("few" if H // Hkv * C < 16 else "tile")
    for p in (plan, _with_span(plan, cap, cap, D),
              _with_span(plan, ps, cap, D)):
        kernels.reset_launch_counts()
        out = pa._rpa_cuda(*args, window, scale, plan=p, **sc)
        again = pa._rpa_cuda(*args, window, scale, plan=p, **sc)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["ragged_paged_attention_int8"] == 2
        assert counts["ragged_paged_attention"] == 0
        assert torch.equal(out, again)
        assert not bool(out[4].float().any())
        for b, n in enumerate(nt):
            if n:
                err = (out[b, :, :n].float() - ref[b, :, :n].float()).abs()
                assert float(err.max()) <= tol * float(
                    ref[b, :, :n].float().abs().max()), (b, p)


def test_paged_attention_int8_pool_raises_by_name(card):
    """An int8 pool launches its variant through the dispatcher; without
    its scale planes it raises, and it never runs the plain version."""
    args, sc = _int8_pools(_rpa_inputs(card, torch.float32, 1, 4, 4, 64, 16,
                                       4, [10, 3], [1, 1]))
    kernels.reset_launch_counts()
    pa.ragged_paged_attention(*args, **sc)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ragged_paged_attention_int8"] == 1
    with pytest.raises(MXNetError, match="k_scales and v_scales"):
        pa.ragged_paged_attention(*args)
    with pytest.raises(MXNetError, match="v_scales must be float32"):
        pa.ragged_paged_attention(*args, k_scales=sc["k_scales"],
                                  v_scales=sc["v_scales"].half())
    # f16 queries over an int8 pool: no serving path makes them
    with pytest.raises(MXNetError, match="int8 pool under float16"):
        pa.ragged_paged_attention(args[0].half(), *args[1:], **sc)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,N,K", [(8, 2304, 768), (128, 768, 3072),
                                   (5, 50257, 768), (17, 70, 33)])
def test_int8_act_matmul_sums_equal_the_cpu(card, bits, M, N, K):
    """`torch._int_mm` on the card, padded where it refuses a shape (M <=
    16, K or N off a multiple of 8): the int32 sums equal the CPU's bit for
    bit, and the outputs agree to f32 rounding; K2 is not launched."""
    g = torch.Generator().manual_seed(M + N)
    x = torch.randn(M, K, generator=g)
    qt = qm.quantize_weight(torch.randn(N, K, generator=g) * 0.05, bits)
    xq, _ = qm._quantize_act(x, qt)
    want = qm.int8_mm_nt(xq, qm._rhs_planes(qt))
    qc = qt.to(card)
    got = qm.int8_mm_nt(xq.to(card), qm._rhs_planes(qc))[:, :N]
    assert torch.equal(got.cpu(), want)
    kernels.reset_launch_counts()
    out = qm.quantized_matmul(x.to(card), qc, act_quant=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["quantized_matmul"] == 0
    ref = qm.int8_act_matmul(x, qt)
    assert float((out.cpu() - ref).abs().max()) <= 1e-6 * float(
        ref.abs().max())


@pytest.mark.parametrize("bits,act", [(0, False), (8, True)])
def test_int8_pool_engine_on_the_card(card, monkeypatch, bits, act):
    """A small GPT served over an int8 pool on the card (K1's int8 variant
    once a layer a fused step; under ``MXTPU_QUANT_ACT`` no K2) gives the
    plain engine's greedy streams."""
    from mxnet_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig
    if act:
        monkeypatch.setenv("MXTPU_QUANT_ACT", "1")
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, intermediate_size=256, max_position=128,
                    dropout=0.0)
    model = GPTForCausalLM(cfg, device=card, seed=0)
    sc = ServeConfig(max_slots=4, page_size=16, prefill_chunk=16,
                     max_len=96, kv_dtype="int8", quant_bits=bits)
    prompts = [list(range(3, 3 + n)) for n in (5, 40, 17, 64, 1)]
    outs = {}
    for plain in (False, True):
        eng = InferenceEngine(model, sc, device=card, plain_ops=plain)
        kernels.reset_launch_counts()
        hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.run_until_idle()
        outs[plain] = [h.result(timeout=0) for h in hs]
        counts = kernels.launch_counts()
        steps = eng.stats()["steps_executed"]
        if plain:
            assert not any(counts.values())
        else:
            assert counts["ragged_paged_attention_int8"] == 2 * steps
            assert counts["ragged_paged_attention"] == 0
            assert counts["quantized_matmul"] == 0 if act or not bits \
                else counts["quantized_matmul"] > 0
    assert outs[False] == outs[True]


# ---------------------------------------------------------------------------
# float16 models: serving over an f16 pool, TrainStep over f16 weights, the
# tuner's f16 keys
# ---------------------------------------------------------------------------

def test_f16_engine_on_the_card(card):
    """A small f16 GPT served over an f16 pool on the card: K1 with f32
    queries over the f16 pool (type 5) once a layer a fused step, counted
    under float16, and the plain engine's greedy streams, token for
    token."""
    from mxnet_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, intermediate_size=256, max_position=128,
                    dropout=0.0, dtype="float16")
    model = GPTForCausalLM(cfg, device=card, seed=0)
    sc = ServeConfig(max_slots=4, page_size=16, prefill_chunk=16,
                     max_len=96)
    prompts = [list(range(3, 3 + n)) for n in (5, 40, 17, 64, 1)]
    outs = {}
    for plain in (False, True):
        eng = InferenceEngine(model, sc, device=card, plain_ops=plain)
        assert eng.pools.k.dtype == torch.float16
        kernels.reset_launch_counts()
        hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.run_until_idle()
        outs[plain] = [h.result(timeout=0) for h in hs]
        steps = eng.stats()["steps_executed"]
        if plain:
            assert not any(kernels.launch_counts().values())
        else:
            assert kernels.DTYPE_LAUNCHES == {
                ("ragged_paged_attention", "float16"): 2 * steps}
    assert outs[False] == outs[True]


def test_f16_gpt_train_step_on_the_card(card):
    """Three steps of a small f16 GPT through `TrainStep` on the kernel
    route: f32 optimizer state, the chunk once over the f16 leaves and
    once over the f32 LayerNorm group a step, flash, cross-entropy and the
    norm in f16; the trajectory within 1e-3 of the plain oracle's (f16
    weights without an f32 master copy: rounding apart, as bf16's)."""
    g = torch.Generator().manual_seed(0)
    stream = torch.randint(0, 1000, (2, 257), generator=g).to(card)
    batch = (stream[:, :-1], stream[:, 1:])
    runs = {}
    for plain in (False, True):
        model, step = _gpt_step(card, False, plain, dtype="float16")
        assert {s.dtype for st in step.opt_state.values() for s in st} == \
            {torch.float32}
        assert {str(p.dtype) for p in model.parameters()} == \
            {"torch.float16", "torch.float32"}
        step.warmup(*batch)
        kernels.reset_launch_counts()
        runs[plain] = [float(step(*batch)) for _ in range(3)]
        if plain:
            assert not any(kernels.launch_counts().values())
        else:
            assert kernels.DTYPE_LAUNCHES == {
                ("flash_attention_fwd", "float16"): 6,
                ("flash_attention_bwd", "float16"): 6,
                ("softmax_xent_fwd", "float16"): 3,
                ("softmax_xent_bwd", "float16"): 3,
                ("fused_norm", "float16"): 15,
                ("fused_optimizer_chunk", "float16"): 3,
                ("fused_optimizer_chunk", "float32"): 3}
    np.testing.assert_allclose(runs[False], runs[True], rtol=1e-3)
    assert runs[False][-1] < runs[False][0]


def test_f16_tuning_keys_launch_the_f16_instantiations(card, tmp_path,
                                                       monkeypatch):
    """``tune`` under float16 keys: the chunk's trials launch (f16 leaves,
    f32 moments), K2's ``int8_float16`` trials launch on f16 activations
    and K1's page-size trials over an f16 pool, each counted under
    float16."""
    from mxnet_tpu_torch.ops import autotune as at
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    at.clear_memory_cache()
    try:
        for kind, shape, key, name in (
                ("fused_optimizer", (300_001,), "float16",
                 "fused_optimizer_chunk"),
                ("quantized_matmul", (8, 2304, 768), "int8_float16",
                 "quantized_matmul"),
                ("paged_attention", (8, 12, 12, 64, 512), "float16",
                 "ragged_paged_attention")):
            kernels.reset_launch_counts()
            res = at.tune(kind, shape, key)
            assert res.trials > 0 and not res.cache_hit, kind
            assert kernels.DTYPE_LAUNCHES.get((name, "float16"), 0) > 0, \
                (kind, kernels.DTYPE_LAUNCHES)
            assert set(kernels.DTYPE_LAUNCHES) == {(name, "float16")}, kind
    finally:
        at.clear_memory_cache()


def test_loss_scaler_sees_inf_and_nan_on_the_card(card):
    """`LossScaler.has_overflow` on CUDA gradients of each float type: its
    one reduction (`torch._foreach_norm` at order inf) keeps an inf or a
    NaN anywhere in any gradient."""
    from mxnet_tpu_torch import amp
    ps = [torch.nn.Parameter(torch.zeros(n, dtype=dt, device=card))
          for n, dt in ((3, torch.float32), (70000, torch.float16),
                        (5, torch.bfloat16))]
    s = amp.LossScaler()
    for p in ps:
        p.grad = torch.full_like(p, 6e4)
    assert not s.has_overflow(ps)
    for bad in (float("inf"), float("-inf"), float("nan")):
        for p in ps:
            p.grad[-1] = bad
            assert s.has_overflow(ps), (p.dtype, bad)
            p.grad[-1] = 0.0


@pytest.mark.parametrize("weights", ["float32", "float16"])
def test_fp16_amp_bert_steps_on_the_card(card, weights):
    """Three fp16 AMP steps of a small BERT through the gluon `Trainer`
    and its loss scaler (``multi_precision`` with f16 weights): the flash
    and cross-entropy kernels launch in f16 only, the losses are those of
    the same loop on the plain versions within 1e-3, a poisoned step is
    skipped on both, and the weights keep their dtype."""
    import math
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.models import bert as tb
    from mxnet_tpu_torch.models.layers import _plain_twin
    from mxnet_tpu_torch.ops import softmax_xent as sx
    from mxnet_tpu_torch.ops.fused_norm import fused_layer_norm_reference
    cfg = tb.BertConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256, max_position=64,
                        dropout=0.1)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 1000, (4, 64), generator=g).to(card)
    vl = torch.tensor([64, 50, 33, 61], device=card)
    mp = torch.arange(0, 40, 5, device=card).repeat(4, 1)
    lab = torch.randint(0, 1000, (4, 8), generator=g).to(card)

    def norm_ref(x, gamma, beta, eps=1e-5):
        x, gamma, beta = amp.cast_inputs("layer_norm", x, gamma, beta)
        return fused_layer_norm_reference(x, gamma, beta, eps=eps)

    runs = {}
    for plain in (False, True):
        amp.init("float16")
        model = tb.BertForPretraining(cfg, device=card, seed=0)
        if weights == "float16":
            amp.convert_hybrid_block(model, "float16")
        xent = sx.softmax_cross_entropy
        if plain:
            xent = sx.softmax_cross_entropy_reference
            _plain_twin(model, norm=norm_ref)
        tr = Trainer(model.collect_params(), "adam",
                     {"learning_rate": 1e-3,
                      "multi_precision": weights == "float16"})
        amp.init_trainer(tr)
        kernels.reset_launch_counts()
        losses = []
        for i in range(3):
            with autograd.train_mode():
                loss = xent(model(ids, None, vl, mp)[0], lab).mean()
            losses.append(float(loss))
            with amp.scale_loss(loss * math.inf if i == 1 else loss,
                                tr) as scaled:
                scaled.backward()
            tr.step(1)
        torch.cuda.synchronize()
        runs[plain] = (losses, tr._amp_loss_scaler.loss_scale,
                       dict(kernels.DTYPE_LAUNCHES))
        assert all(p.dtype == getattr(torch, weights)
                   for p in model.parameters())
        amp.disable()
    (got, scale, launches), (want, pscale, plaunches) = runs[False], \
        runs[True]
    assert scale == pscale == 2.0 ** 15
    assert launches[("flash_attention_fwd", "float16")] == 6
    assert launches[("flash_attention_bwd", "float16")] == 6
    assert launches[("softmax_xent_fwd", "float16")] == 3
    assert launches[("softmax_xent_bwd", "float16")] == 3
    assert not any(k[0].startswith(("flash", "softmax")) and
                   k[1] != "float16" for k in launches)
    assert not any(n.startswith(("flash", "softmax")) for n, _ in plaunches)
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= 1e-3


# ---------------------------------------------------------------------------
# the Gluon front end's card cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("N,V", [(32, 2), (32, 3), (64, 2)])
def test_softmax_xent_few_classes_match_plain(card, dtype, tol, N, V):
    """A classifier's logits (BERT fine-tuning's 2 classes, the int8
    example's 3): one row narrower than a vector."""
    from mxnet_tpu_torch.ops import softmax_xent as sx
    g = torch.Generator().manual_seed(5)
    x = (2 * torch.randn(N, V, generator=g)).to(card, dtype)
    lab = torch.randint(0, V, (N,), generator=g).to(card, torch.int32)
    gr = torch.rand(N, generator=g).to(card)
    lk, sk = sx._xent_fwd_cuda(x, lab)
    lp, sp = sx.xent_fwd_reference(x, lab)
    dk = sx._xent_bwd_cuda(x, lab, sk, gr)
    dp = sx.xent_bwd_reference(x, lab, sp, gr)
    torch.cuda.synchronize()
    _qmm_check(lk, lp, 1e-4)
    _qmm_check(sk, sp, 1e-4)
    _qmm_check(dk, dp, tol)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,N,K", [(64, 2, 16), (64, 64, 16), (64, 2, 768),
                                   (64, 3, 32)])
def test_quantized_matmul_gluon_shapes_match_plain(card, bits, M, N, K):
    """The Gluon MLPs' products: a 2- or 3-class head, a K of 16."""
    x, qt = _qmm_case(card, torch.float32, bits, M, N, K)
    kernels.reset_launch_counts()
    out = qm.quantized_matmul(x, qt)
    assert kernels.launch_counts()["quantized_matmul"] == 1
    _qmm_check(out, qm.quantized_matmul_reference(x, qt), 1e-4)


def test_quantize_net_launches_k2_per_dense(card, monkeypatch):
    import mxnet_tpu_torch as tm
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, in_units=16, activation="relu"), nn.LayerNorm(),
            nn.Dense(3))
    net.initialize(device=card)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(64, 16, generator=g).to(card)
    with torch.no_grad():
        want = net(x)
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive")
    kernels.reset_launch_counts()
    out = qnet(x)
    assert kernels.launch_counts()["quantized_matmul"] == 2
    assert kernels.launch_counts()["fused_norm"] == 1
    monkeypatch.setenv("MXTPU_PALLAS", "reference")
    _qmm_check(out, qnet(x), 1e-4)
    monkeypatch.setenv("MXTPU_PALLAS", "auto")
    monkeypatch.setenv("MXTPU_QUANT_ACT", "1")
    kernels.reset_launch_counts()
    act = qnet(x)
    assert kernels.launch_counts()["quantized_matmul"] == 0
    assert (act.argmax(-1) == want.argmax(-1)).float().mean() > 0.8
    assert tm.current_device() == tm.gpu(0)


def test_gluon_trainer_launches_the_norm_and_the_chunk(card):
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, in_units=16, activation="relu"), nn.LayerNorm(),
            nn.Dense(2))
    net.initialize(device=card)
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-3})
    x = torch.randn(8, 16, device=card)
    y = torch.randint(0, 2, (8,), device=card)
    kernels.reset_launch_counts()
    for _ in range(2):
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        autograd.backward(loss)
        tr.step(8)
    lc = kernels.launch_counts()
    assert lc["fused_optimizer_chunk"] == 2 and lc["fused_norm"] == 2
    assert lc["softmax_xent_fwd"] == 2 and lc["softmax_xent_bwd"] == 2


# ---------------------------------------------------------------------------
# the operations plane on the card: the step's own skip flag, checkpoints
# ---------------------------------------------------------------------------

def _plane_step(card, opt_name, monkeypatch, dropout=0.0):
    """A 2-layer BERT (hidden 64) `TrainStep` on the card under health and
    recovery; a hook plants one NaN in the first layer's FFN bias gradient
    while ``poison[0]`` is set."""
    from mxnet_tpu_torch import health, recovery
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.models import bert as tb
    from mxnet_tpu_torch.ops import softmax_cross_entropy
    from mxnet_tpu_torch.parallel import TrainStep

    monkeypatch.setenv("MXTPU_PALLAS", "auto")
    health.enable(crash_dir=None)
    recovery.enable()
    cfg = tb.BertConfig(vocab_size=128, hidden_size=64, num_layers=2,
                        num_heads=4, intermediate_size=128, max_position=32,
                        dropout=dropout, dtype="bfloat16")

    class Bench(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = tb.BertForPretraining(cfg, device=card, seed=5)

        def forward(self, ids, vl, mp):
            return self.model(ids, valid_length=vl, masked_positions=mp)

    net = Bench()
    poison = [False]
    target = dict(net.named_parameters())[
        "model.bert.layers.0.ffn_intermediate.bias"]
    # made here: writing one element from the host inside the step would
    # itself be the host sync the test forbids
    nan_at_3 = torch.zeros_like(target)
    nan_at_3.view(-1)[3] = float("nan")

    def plant(g):
        return g + nan_at_3 if poison[0] else g

    target.register_hook(plant)
    opt = getattr(topt, opt_name)(learning_rate=1e-3)
    step = TrainStep(net, opt,
                     lambda out, ids, vl, mp, lab:
                     softmax_cross_entropy(out[0], lab).mean(),
                     num_model_args=3)
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randint(0, 128, (4, 32)).astype(np.int32)),
             torch.full((4,), 32, dtype=torch.int32),
             torch.from_numpy(np.sort(rng.rand(4, 32).argsort(1)[:, :5], 1)
                              .astype(np.int32)),
             torch.from_numpy(rng.randint(0, 128, (4, 5)).astype(np.int32)))
    return step, tuple(b.to(card) for b in batch), poison


@pytest.fixture
def plane_off():
    from mxnet_tpu_torch import health, recovery, telemetry
    yield
    recovery.disable()
    health.disable()
    telemetry.disable()


@pytest.mark.parametrize("opt_name,kernel", [("Adam", "fused_optimizer_chunk"),
                                             ("LAMB", "lamb_phase_b")])
def test_step_computed_skip_keeps_weights_and_state_bit_exact(
        card, monkeypatch, plane_off, opt_name, kernel):
    step, batch, poison = _plane_step(card, opt_name, monkeypatch)
    assert step._fused_opt_kernel and step._skip_nonfinite
    step.dispatch(*batch)
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in step.params.items()}
    state = {n: [s.clone() for s in step.opt_state[n]]
             for n in step.diff_names}
    poison[0] = True
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")   # no host sync in the step
    try:
        h = step.dispatch(*batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launch_counts()[kernel] >= 1
    assert float(h.probes["nonfinite"]) == 1.0
    assert not np.isfinite(float(h.probes["grad_norm"]))
    torch.cuda.synchronize()
    for n, p in step.params.items():
        assert torch.equal(p, before[n]), n
    for n in step.diff_names:
        for a, b in zip(step.opt_state[n], state[n]):
            assert torch.equal(a, b), n
    poison[0] = False
    step.dispatch(*batch)
    torch.cuda.synchronize()
    assert any(not torch.equal(p, before[n])
               for n, p in step.params.items())


def test_cuda_train_step_save_load_round_trip(card, monkeypatch, plane_off,
                                              tmp_path):
    step, batch, _ = _plane_step(card, "Adam", monkeypatch, dropout=0.1)
    for _ in range(2):
        step.dispatch(*batch)
    path = str(tmp_path / "ck.npz")
    step.save_async(path).result(timeout=60)
    saved = {n: p.detach().clone() for n, p in step.params.items()}
    first = [float(step.dispatch(*batch).loss) for _ in range(2)]
    after = {n: p.detach().clone() for n, p in step.params.items()}
    state = {n: [s.clone() for s in step.opt_state[n]]
             for n in step.diff_names}
    step.load(path)
    assert step._t == 2
    for n, p in step.params.items():
        assert torch.equal(p, saved[n]), n
    again = [float(step.dispatch(*batch).loss) for _ in range(2)]
    assert first == again                 # the dropout generator came back
    for n, p in step.params.items():
        assert torch.equal(p, after[n]), n
    for n in step.diff_names:
        for a, b in zip(step.opt_state[n], state[n]):
            assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the models as Gluon blocks: examples/gpt_generation.py's and
# examples/serve_gpt.py's calls on the card
# ---------------------------------------------------------------------------

def _example_gpt(card, **extra):
    from mxnet_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=64, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128, max_position=64,
                    dropout=0.0, **extra)
    model = GPTForCausalLM(cfg, device=card)
    model.initialize()
    return model


@pytest.mark.parametrize("extra", [{}, dict(rope=True, num_kv_heads=2,
                                            window=8)],
                         ids=["classic", "modern"])
def test_gluon_gpt_example_steps_on_the_card(card, extra, tmp_path):
    """Three steps of `examples/gpt_generation.py`'s loop on its model
    (``gluon.Trainer(model.collect_params(), "adam")``, ``record()``,
    ``backward()``, ``step(1)``): each step launches flash 2 + 2, the
    norm 5, the cross-entropy 1 + 1 and the chunk once (f32: one dtype
    group), and the same loop on the plain twin (`_plain_twin`, the plain
    loss and update) gives the same losses within 1e-4; the trained
    weights come back bit-equal through `save_parameters` into a fresh
    model."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.models import GPTForCausalLM
    from mxnet_tpu_torch.models.layers import _plain_twin
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.ops.softmax_xent import \
        softmax_cross_entropy_reference
    g = torch.Generator().manual_seed(0)
    batches = [torch.randint(0, 64, (8, 24), generator=g).to(card)
               for _ in range(3)]
    runs = {}
    for plain in (False, True):
        model = _example_gpt(card, **extra)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        if plain:
            _plain_twin(model)
            loss_fn = softmax_cross_entropy_reference
        tr = gluon.Trainer(model.collect_params(), "adam",
                           {"learning_rate": 3e-3})
        model.hybridize()
        real = fo.apply_updates
        if plain:
            fo.apply_updates = lambda opt, p, gr, s, hp, skip=None, \
                use_kernel=False: fo.kernel_plain(opt, p, gr, s, hp, skip)
        losses, counts = [], []
        try:
            for ids in batches:
                kernels.reset_launch_counts()
                with autograd.record():
                    logits = model(ids)
                    loss = loss_fn(logits[:, :-1].reshape(-1, 64),
                                   ids[:, 1:].reshape(-1)).mean()
                loss.backward()
                tr.step(1)
                torch.cuda.synchronize()
                counts.append(kernels.launch_counts())
                losses.append(float(loss))
        finally:
            fo.apply_updates = real
        runs[plain] = (model, losses, counts)
    model, losses, counts = runs[False]
    want = {"flash_attention_fwd": 2, "flash_attention_bwd": 2,
            "fused_norm": 5, "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
            "fused_optimizer_chunk": 1}
    for c in counts:
        assert {k: c[k] for k in want} == want
    assert not any(v for c in runs[True][2] for v in c.values())
    np.testing.assert_allclose(losses, runs[True][1], rtol=1e-4)
    path = str(tmp_path / "gpt.npz")
    model.save_parameters(path)
    fresh = GPTForCausalLM(model.cfg, device=card, seed=1)
    fresh.initialize()
    fresh.load_parameters(path)
    with torch.no_grad():
        assert torch.equal(model(batches[0]), fresh(batches[0]))


def test_gluon_gpt_serves_as_the_example_on_the_card(card):
    """`examples/serve_gpt.py`'s engine over a port Block: its pool forces
    an eviction, every stream equals an unbatched greedy `generate`, and
    K1 runs once a layer a fused step."""
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig
    model = _example_gpt(card)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 64, n).tolist() for n in (3, 9, 5, 12, 2, 7)]
    refs = [model.generate(torch.tensor([p], dtype=torch.int32),
                           max_new_tokens=8)[0].tolist() for p in prompts]
    eng = InferenceEngine(model, ServeConfig(
        max_slots=2, page_size=4, num_pages=6, prefill_chunk=4,
        max_len=20), device=card)
    eng.warmup()
    kernels.reset_launch_counts()
    handles = [eng.submit(p, max_new_tokens=8) for p in prompts]
    steps = eng.run_until_idle()
    assert [h.result(timeout=0) for h in handles] == refs
    assert sum(h.evictions for h in handles) >= 1
    assert kernels.launch_counts()["ragged_paged_attention"] == 2 * steps


def test_prefetcher_copies_on_its_own_stream_under_a_busy_consumer(card):
    """Each batch is copied on the prefetcher's own stream from pinned
    memory; read right after ``next()``, behind a long kernel queued on
    the consumer's stream, and freed at once, it still holds its values:
    the consumer's stream waits on the copy's event, and the freed buffer
    is not reused by a later copy before the consumer's reads ran."""
    from mxnet_tpu_torch.parallel import DevicePrefetcher
    rng = np.random.RandomState(0)
    src = [rng.randn(512, 1024).astype(np.float32) for _ in range(12)]
    want = [torch.from_numpy(x).to(card).mul(2).sum() for x in src]
    torch.cuda.synchronize()
    pf = DevicePrefetcher(iter(src), depth=2)
    assert pf.stream is not None
    assert pf.stream.stream_id != torch.cuda.current_stream().stream_id
    got = []
    for _ in src:
        torch.cuda._sleep(4_000_000)        # ~2 ms queued on the consumer
        b = next(pf)
        assert b.device.type == "cuda" and b.dtype == torch.float32
        got.append(b.mul(2).sum())
        del b                               # freed while still to be read
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    stats = pf.stats()
    assert stats["batches"] == len(src) and stats["depth"] == 2


def test_prefetcher_copies_come_from_pinned_memory(card):
    """Under ``torch.profiler`` the prefetched batches' host->device
    copies run from pinned memory on a stream no kernel ran on (the trace
    need not record every copy: the check is where and from what memory
    they ran)."""
    import json
    import tempfile
    from mxnet_tpu_torch.parallel import DevicePrefetcher
    src = [(np.full((64, 64), i, np.float32), np.arange(8, dtype=np.int32))
           for i in range(4)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pf = DevicePrefetcher(iter(src), depth=2)
        sums = [x.sum() + y.sum() for x, y in pf]
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name)).get("traceEvents", [])
    kernels_at = {e.get("args", {}).get("stream") for e in events
                  if e.get("cat") == "kernel"}
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    if not kernels_at or not copies:
        pytest.skip("the profiler saw no device activity here")
    mine = [e for e in copies
            if e.get("args", {}).get("stream") not in kernels_at]
    assert mine and all("Pinned" in e["name"] for e in mine)
    assert [float(v) for v in sums] == [float(64 * 64 * i + 28)
                                        for i in range(4)]


def test_dataloader_workers_open_no_cuda_context(card):
    """A `DataLoader` over arrays on the card with two worker processes:
    the workers rebuild the arrays on the CPU (pinned before unpickling),
    never initialise CUDA, hold no context while they live, and the
    batches land on the card equal to the serial loader's."""
    import os
    import subprocess
    import sys
    import mxnet_tpu_torch as mx
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_data_common as common

    x = mx.np.array(np.arange(40, dtype=np.float32).reshape(10, 4))
    y = mx.np.array(np.arange(10, dtype=np.int32))
    assert x.device == mx.gpu(0)
    ds = mx.gluon.data.ArrayDataset(x, y)
    serial = list(mx.gluon.data.DataLoader(ds, batch_size=3))
    dl = mx.gluon.data.DataLoader(ds, batch_size=3, num_workers=2,
                                  thread_pool=False)
    got, apps = [], None
    for b in dl:
        if apps is None:
            r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                                "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60)
            apps = {int(t) for t in r.stdout.split() if t.isdigit()}
            pids = {w.proc.pid for w in dl._proc_pool._workers}
        got.append(b)
    del dl
    assert not apps & pids and len(apps) <= 1
    assert len(got) == len(serial) == 4
    for (a, b), (c, d) in zip(got, serial):
        assert a.device == mx.gpu(0) and torch.equal(a._data, c._data)
        assert torch.equal(b._data, d._data)
    probe = mx.gluon.data.DataLoader(common.DeviceProbe(), batch_size=2,
                                     num_workers=2, thread_pool=False)
    rows = np.concatenate([b[0].asnumpy() for b in probe])
    del probe
    assert rows[:, 0].all() and not rows[:, 1].any()


def test_to_tensor_divides_on_the_card_as_on_the_cpu(card):
    """`ToTensor` on the card gives the CPU's bits (a worker process makes
    its batches on the CPU, the serial loader on the card)."""
    import mxnet_tpu_torch as mx
    T = mx.gluon.data.vision.transforms
    img = np.arange(256 * 3, dtype=np.uint8).reshape(16, 16, 3)
    on_card = T.ToTensor()(mx.np.array(img)).asnumpy()
    with mx.cpu():
        on_cpu = T.ToTensor()(mx.np.array(img)).asnumpy()
    np.testing.assert_array_equal(on_card, on_cpu)


# ---------------------------------------------------------------------------
# convolution, pooling, the spatial ops, the vision zoo and the iterators:
# each on the card equal to its CPU result (cuDNN against the CPU's
# convolutions, TF32 off)
# ---------------------------------------------------------------------------

def _vision_close(got, want, tol=1e-4):
    scale = max(1.0, float(want.abs().max()))
    assert got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= tol * scale


def _on_both(card, fn, *arrays):
    """`fn` over `arrays` (numpy) on the card and on the CPU, recorded:
    (output, gradients of sum(out ** 2)) on each."""
    outs = []
    for dev in (card, torch.device("cpu")):
        ts = [torch.tensor(a, device=dev, requires_grad=a.dtype ==
                           np.float32) for a in arrays]
        out = fn(*ts)
        (out * out).sum().backward()
        outs.append((out.detach(), [t.grad for t in ts
                                    if t.requires_grad]))
    return outs


def _u32(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


VISION_OPS = {
    "conv2d_groups": (lambda x, w, b: _nn_ops().convolution(
        x, w, b, stride=(2, 1), dilate=(1, 2), pad=(1, 2), num_group=2),
        [(2, 4, 15, 17), (6, 2, 3, 3), (6,)]),
    "conv1d": (lambda x, w, b: _nn_ops().convolution(x, w, b, stride=2,
                                                     pad=1, dilate=2),
               [(2, 4, 31), (6, 4, 3), (6,)]),
    "conv3d": (lambda x, w, b: _nn_ops().convolution(x, w, b, pad=1),
               [(1, 2, 6, 7, 5), (3, 2, 2, 3, 2), (3,)]),
    "deconv2d": (lambda x, w, b: _nn_ops().deconvolution(
        x, w, b, stride=(2, 3), pad=(1, 0), adj=(1, 2), num_group=2,
        no_bias=False), [(2, 4, 9, 7), (4, 3, 3, 2), (6,)]),
    "deconv2d_adj_past_stride": (lambda x, w, b: _nn_ops().deconvolution(
        x, w, b, stride=(2, 2), dilate=(1, 2), pad=(1, 1), adj=(3, 1),
        num_group=2, no_bias=False), [(2, 4, 9, 7), (4, 3, 3, 2), (6,)]),
    "maxpool_full": (lambda x: _nn_ops().pooling(
        x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
        pooling_convention="full"), [(2, 3, 16, 16)]),
    "avgpool_real_count": (lambda x: _nn_ops().pooling(
        x, kernel=(3, 2), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False), [(2, 3, 16, 16)]),
    "lp_pool_1d": (lambda x: _nn_ops().pooling(
        x, kernel=(4,), stride=(3,), pool_type="lp", p_value=3),
        [(2, 3, 20)]),
    "sum_pool_3d": (lambda x: _nn_ops().pooling(
        x, kernel=(2, 3, 2), stride=(2, 2, 3), pad=(1, 1, 0),
        pool_type="sum"), [(1, 2, 6, 5, 7)]),
    "global_max": (lambda x: _nn_ops().pooling(x, global_pool=True),
                   [(2, 3, 7, 9)]),
    "bilinear_sampler": (lambda x, g: _spatial().bilinear_sample(x, g),
                         [(2, 3, 9, 11), (2, 2, 6, 7)]),
    "spatial_transformer": (lambda x, loc: _spatial().spatial_transformer(
        x, loc * 0.5, (7, 8)), [(2, 3, 9, 11), (2, 6)]),
    "grid_generator_warp": (lambda f: _spatial().grid_generator(
        f, "warp"), [(2, 2, 5, 6)]),
    "correlation": (lambda a, b: _spatial().correlation(
        a, b, kernel_size=3, max_displacement=2, stride2=2, pad_size=2),
        [(2, 3, 9, 11), (2, 3, 9, 11)]),
    "im2col": (lambda x: _spatial().im2col(x, (3, 2), (2, 1), (1, 2),
                                           (1, 1)), [(2, 3, 9, 11)]),
    "col2im": (lambda c: _spatial().col2im(c, (9, 11), (3, 2), (2, 1),
                                           (1, 2), (1, 1)),
               [(2, 18, 55)]),
    "deformable_convolution": (lambda x, o, w, b:
                               _spatial().deformable_convolution(
                                   x, o * 1.5, w, b, (3, 3), pad=(1, 1),
                                   num_deformable_group=2),
                               [(2, 4, 9, 11), (2, 36, 9, 11),
                                (5, 4, 3, 3), (5,)]),
}


def _nn_ops():
    from mxnet_tpu_torch.ops import nn
    return nn


def _spatial():
    from mxnet_tpu_torch.ops import spatial
    return spatial


@pytest.mark.parametrize("name", sorted(VISION_OPS))
def test_vision_ops_on_the_card_equal_the_cpu(card, monkeypatch, name):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    fn, shapes = VISION_OPS[name]
    arrays = [_u32(*s, seed=i) for i, s in enumerate(shapes)]
    (got, ggrads), (want, wgrads) = _on_both(card, fn, *arrays)
    assert got.device.type == "cuda"
    _vision_close(got, want)
    for g, w in zip(ggrads, wgrads):
        _vision_close(g, w)


VISION_LAYERS = {
    "conv2d": (lambda nn: nn.Conv2D(8, 3, strides=2, padding=1,
                                    activation="relu"), (2, 3, 17, 17)),
    "conv3d_transpose": (lambda nn: nn.Conv3DTranspose(2, 2, strides=2),
                         (1, 3, 4, 5, 3)),
    "maxpool2d_nhwc": (lambda nn: nn.MaxPool2D(3, 2, 1, layout="NHWC",
                                               ceil_mode=True),
                       (2, 9, 9, 3)),
    "global_avg1d": (lambda nn: nn.GlobalAvgPool1D(), (2, 3, 11)),
    "reflection_pad": (lambda nn: nn.ReflectionPad2D(2), (2, 3, 7, 8)),
    "pixel_shuffle2d": (lambda nn: nn.PixelShuffle2D((2, 3)),
                        (2, 12, 5, 6)),
    "deformable": (lambda nn: nn.DeformableConvolution(4),
                   (2, 3, 9, 9)),
}


@pytest.mark.parametrize("name", sorted(VISION_LAYERS))
def test_vision_layers_on_the_card_equal_the_cpu(card, monkeypatch, name):
    import mxnet_tpu_torch as mx
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    make, shape = VISION_LAYERS[name]
    x = _u32(*shape, seed=3)
    nets = {}
    for dev in ("cpu", "card"):
        torch.manual_seed(0)
        net = make(mx.gluon.nn)
        net.initialize(mx.init.Xavier(), device="cpu")
        net(torch.from_numpy(x))
        if dev == "card":
            net.reset_device(mx.gpu(0))
            net.load_dict({k: p.data() for k, p in
                           nets["cpu"].collect_params().items()})
        nets[dev] = net
    outs = {}
    for dev, net in nets.items():
        t = torch.tensor(x, device=card if dev == "card" else "cpu",
                         requires_grad=True)
        with mx.autograd.record():
            out = net(t)
        (out * out).sum().backward()
        outs[dev] = (out.detach(), t.grad, {k: p.grad() for k, p in
                                            net.collect_params().items()})
    got, want = outs["card"], outs["cpu"]
    _vision_close(got[0], want[0])
    _vision_close(got[1], want[1])
    for k, g in got[2].items():
        _vision_close(g, want[2][k])


def test_resnet18_on_the_card_equals_the_cpu_and_trains(card, monkeypatch):
    """resnet18_v1's logits on the card equal the CPU's (predict mode, 2 x
    3 x 32 x 32); one NAG `Trainer` step at 2 x 3 x 128 x 128 (the
    last stage's BatchNorm then sees 32 values a channel) gives the CPU's
    loss and weights, launching the cross-entropy forward and backward and
    the chunk kernel once each."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    nets = {}
    for dev in ("cpu", "card"):
        net = vision.resnet18_v1(classes=10)
        net.initialize(mx.init.Xavier(), device="cpu")
        net(torch.zeros(1, 3, 32, 32))
        if dev == "card":
            net.load_dict({k: p.data() for k, p in
                           nets["cpu"].collect_params().items()})
            net.reset_device(mx.gpu(0))
        nets[dev] = net
    x = _u32(2, 3, 32, 32, seed=4)
    _vision_close(nets["card"](torch.tensor(x, device=card)),
                  nets["cpu"](torch.from_numpy(x)))
    big = _u32(2, 3, 128, 128, seed=5)
    y = np.array([3, 7], np.float32)
    res = {}
    for dev, net in nets.items():
        d = card if dev == "card" else torch.device("cpu")
        tr = mx.gluon.Trainer(net.collect_params(), "nag",
                              {"learning_rate": 0.05, "momentum": 0.9,
                               "wd": 1e-4})
        kernels.reset_launch_counts()
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(torch.tensor(big, device=d)), torch.tensor(y, device=d))
        mx.autograd.backward(loss)
        tr.step(2)
        res[dev] = (loss.detach(), kernels.launch_counts())
    assert {k: res["card"][1][k] for k in (
        "softmax_xent_fwd", "softmax_xent_bwd", "fused_optimizer_chunk")} \
        == {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
            "fused_optimizer_chunk": 1}
    _vision_close(res["card"][0], res["cpu"][0])
    cpu = nets["cpu"].collect_params()
    for k, p in nets["card"].collect_params().items():
        _vision_close(p.data().detach(), cpu[k].data().detach(), tol=1e-3)


def test_iterators_feed_the_card(card):
    """`NDArrayIter` and `MNISTIter` batches land on the card equal to the
    same iterators' batches on the CPU."""
    import os
    import mxnet_tpu_torch as mx
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "mnist")
    data = _u32(10, 3, 4, seed=6)

    def batches():
        np.random.seed(1)
        it = mx.io.NDArrayIter(data, np.arange(10, dtype=np.float32), 4,
                               shuffle=True)
        mn = mx.io.MNISTIter(os.path.join(root, "train-images-idx3-ubyte.gz"),
                             os.path.join(root, "train-labels-idx1-ubyte.gz"),
                             batch_size=8, seed=2)
        return [b.data + b.label for b in list(it) + list(mn)]
    on_card = batches()
    with mx.cpu():
        on_cpu = batches()
    assert len(on_card) == len(on_cpu) == 3 + 6
    for a, b in zip(on_card, on_cpu):
        for x, y in zip(a, b):
            assert x.device == mx.gpu(0) and y.device == mx.cpu()
            assert torch.equal(x._data.cpu(), y._data)
