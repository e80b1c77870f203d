"""Port parity: flash attention (mxnet_tpu_torch.ops.flash_attention) and the
attention ops around it (mxnet_tpu_torch.ops.attention) against the JAX
package.

The same numpy inputs (from a seed) go through both packages.  The JAX
side runs its Pallas kernels in interpret mode (blocks 8/16, L a multiple
of 8, so it stays on the kernel path), enabled per test with
``monkeypatch``; the port runs its CPU dispatch, the plain versions of the
CUDA kernels.  Tolerance: atol/rtol 1e-5 in float32 (same f32 arithmetic,
different summation order); dropout keep masks are compared bit for bit.
The CUDA kernels' tile walk under a window and the GQA fold is mirrored in
plain Python (`_Walk`, its constants read from the ``.cu`` source) and
held against the plain version's mask on cases drawn by hypothesis.
"""
import pathlib
import re

import hypothesis as hyp
import hypothesis.strategies as st
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops.pallas import flash_attention as jfa

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MASK = -1e30


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _inputs(seed, B=2, H=2, Lq=16, Lk=16, D=16, G=None):
    rng = np.random.RandomState(seed)
    G = G or H
    q = rng.randn(B, H, Lq, D).astype(np.float32)
    k = rng.randn(B, G, Lk, D).astype(np.float32)
    v = rng.randn(B, G, Lk, D).astype(np.float32)
    g = rng.randn(B, H, Lq, D).astype(np.float32)
    return rng, q, k, v, g


def _jax(q, k, v, g, **kw):
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, block_q=8, block_k=16, **kw)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch(q, k, v, g, **kw):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [t.grad.numpy() for t in (qt, kt, vt)]


def _compare(q, k, v, g, jkw, tkw=None):
    want = _jax(q, k, v, g, **jkw)
    got = _torch(q, k, v, g, **(jkw if tkw is None else tkw))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    return got


def _padding_mask(rng, B, Lk):
    vl = rng.randint(Lk // 2, Lk + 1, B)
    return np.arange(Lk)[None, :] < vl[:, None]          # (B, Lk) bool


def _bias(mask):
    return np.where(mask, 0.0, MASK).astype(np.float32)


CASES = ["none", "pad_B_Lk", "pad_B_1_1_Lk", "per_row", "causal",
         "causal_bias", "per_head"]


@pytest.mark.parametrize("case", CASES)
def test_flash_matches_jax_kernel(interpret, case):
    rng, q, k, v, g = _inputs(1)
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    kw = {}
    if case in ("pad_B_Lk", "causal_bias"):
        kw["bias"] = _bias(_padding_mask(rng, B, Lk))
    elif case == "pad_B_1_1_Lk":
        kw["bias"] = _bias(_padding_mask(rng, B, Lk))[:, None, None, :]
    elif case == "per_row":
        kw["bias"] = rng.randn(B, Lq, Lk).astype(np.float32)
    elif case == "per_head":
        kw["bias"] = rng.randn(B, H, Lq, Lk).astype(np.float32)
    if case.startswith("causal"):
        kw["causal"] = True
    tkw = dict(kw)
    if "bias" in kw:
        kw["bias"] = jnp.asarray(kw["bias"])
        tkw["bias"] = torch.from_numpy(tkw["bias"])
    _compare(q, k, v, g, kw, tkw)


def test_fully_masked_rows_are_zero_with_zero_grads(interpret):
    rng, q, k, v, g = _inputs(2)
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    keep = rng.rand(B, Lq, Lk) < 0.7
    keep[1, [0, 3, 9]] = False                          # three dead rows
    bias = _bias(keep)
    out, dq, dk, dv = _compare(q, k, v, g, dict(bias=jnp.asarray(bias)),
                               dict(bias=torch.from_numpy(bias)))
    assert np.all(out[1, :, [0, 3, 9]] == 0.0)
    assert np.all(dq[1, :, [0, 3, 9]] == 0.0)
    _, lse = tfa.flash_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tfa.normalize_bias(torch.from_numpy(bias), B, H, Lq, Lk)[0])
    assert torch.all(lse.reshape(B, H, Lq)[1, :, [0, 3, 9]] == 0.0)


@pytest.mark.parametrize("seed", [7, -123456789])
def test_dropout_matches_jax_kernel(interpret, seed):
    rng, q, k, v, g = _inputs(3)
    bias = _bias(_padding_mask(rng, q.shape[0], k.shape[2]))
    jkw = dict(bias=jnp.asarray(bias), dropout_rate=0.3,
               dropout_seed=jnp.int32(seed))
    tkw = dict(bias=torch.from_numpy(bias), dropout_rate=0.3,
               dropout_seed=torch.tensor(seed, dtype=torch.int32))
    out = _compare(q, k, v, g, jkw, tkw)[0]
    # dropout really dropped: the undropped output differs
    plain = _torch(q, k, v, g, bias=torch.from_numpy(bias))[0]
    assert np.abs(out - plain).max() > 1e-2


@pytest.mark.parametrize("seed,bh,row0,col0,rate", [
    (0, 0, 0, 0, 0.1), (7, 5, 13, 37, 0.1), (-1, 767, 127, 65, 0.5),
    (2 ** 31 - 1, 3, 8191, 1, 0.9)])
def test_keep_mask_is_bit_equal(seed, bh, row0, col0, rate):
    want = np.asarray(jfa._keep_mask(jnp.asarray([[seed]], jnp.int32), bh,
                                     row0, col0, (24, 40), rate))
    got = tfa.keep_mask(seed, bh, row0, col0, (24, 40), rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got.mean() < 1.0


def test_grouped_kv_and_window_match_jax_kernel(interpret):
    _, q, k, v, g = _inputs(4, H=4, G=2)
    for kw in (dict(), dict(window=3), dict(window=5, causal=True),
               dict(window=4, window_symmetric=False)):
        _compare(q, k, v, g, kw)


# heads wider than 128: JAX runs D = 256 in its kernel (a multiple of 128)
# and D = 160 / 192 through `reference_attention`; the port's kernels take
# them all (padded to 256 columns).  MHA and a fold of 2 or 4 query heads
# onto each of 2 kv heads; causal, a causal window and padding (dropout
# only at 256, where both sides hash one mask: JAX's reference route
# draws its own)
WIDE = [(256, 1), (256, 2), (256, 4), (192, 1), (192, 2), (160, 4)]


def _wide_kwargs(rng, mask, B, Lk, D):
    if mask == "causal":
        return dict(causal=True), {}
    if mask == "window":
        return dict(causal=True, window=5), {}
    bias = _bias(_padding_mask(rng, B, Lk))
    drop = {} if D % 128 else dict(dropout_rate=0.2)
    return (dict(bias=jnp.asarray(bias), **drop,
                 **({"dropout_seed": jnp.int32(11)} if drop else {})),
            dict(bias=torch.from_numpy(bias), **drop,
                 **({"dropout_seed": torch.tensor(11, dtype=torch.int32)}
                    if drop else {})))


@pytest.mark.parametrize("D,rep", WIDE)
@pytest.mark.parametrize("mask", ["causal", "window", "pad"])
def test_wide_heads_match_jax(interpret, D, rep, mask):
    rng, q, k, v, g = _inputs(21, B=2, H=2 * rep, G=2, D=D)
    jkw, tkw = _wide_kwargs(rng, mask, 2, 16, D)
    _compare(q, k, v, g, jkw, tkw or jkw)


def test_wide_heads_match_jax_in_bf16(interpret):
    """bf16 q, k, v at D = 256 over one kv head, causal: both sides
    round p to bf16 before P V; held to 2e-2 of the output's scale, as
    the card's bf16 kernel cases are."""
    _, q, k, v, g = _inputs(22, B=2, H=2, G=1, D=256)
    bf = [x.astype(jnp.bfloat16) for x in (q, k, v, g)]
    want = _jax(*bf, causal=True)
    qt, kt, vt = (torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
                  .requires_grad_() for x in bf[:3])
    out = tfa.flash_attention(qt, kt, vt, causal=True)
    out.backward(torch.tensor(np.asarray(bf[3], np.float32))
                 .to(torch.bfloat16))
    got = [out.detach()] + [t.grad for t in (qt, kt, vt)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name


F16_CASES = {"pad_dropout": (64, 2, 2, "pad", False, 0.1),
             "causal": (64, 2, 2, "none", True, 0.0),
             "fold_causal": (64, 4, 2, "none", True, 0.0),
             "fold_pad_dropout": (64, 4, 1, "pad", False, 0.2),
             "d256_pad_dropout": (256, 2, 2, "pad", False, 0.1),
             "d256_fold_causal": (256, 4, 1, "none", True, 0.0)}


@pytest.mark.parametrize("case", sorted(F16_CASES))
def test_f16_flash_matches_jax_kernel(interpret, case):
    """f16 q, k, v (fp16 AMP's attention): JAX's kernels compute in the
    inputs' dtype with f32 products and round p and dS to f16 before their
    products, as the port's plain versions (the kernels' arithmetic) do.
    Padding with dropout, causal, H query heads folded onto G kv heads, D
    64 and 256; held to 5e-3 of each output's scale (a few f16 steps, as
    the card's f16 kernel cases are)."""
    D, H, G, mask, causal, rate = F16_CASES[case]
    rng, q, k, v, g = _inputs(23, B=2, H=H, G=G, D=D)
    hs = [x.astype(jnp.float16) for x in (q, k, v, g)]
    jkw, tkw = dict(causal=causal), dict(causal=causal)
    if mask == "pad":
        bias = _bias(_padding_mask(rng, 2, 16))
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    if rate:
        jkw.update(dropout_rate=rate, dropout_seed=jnp.int32(5))
        tkw.update(dropout_rate=rate,
                   dropout_seed=torch.tensor(5, dtype=torch.int32))
    want = _jax(*hs, **jkw)
    qt, kt, vt, gt = (torch.tensor(np.asarray(x, np.float32)).to(
        torch.float16) for x in hs)
    qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
    out = tfa.flash_attention(qt, kt, vt, **tkw)
    out.backward(gt)
    got = [out.detach()] + [t.grad for t in (qt, kt, vt)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float16 and b.dtype == jnp.float16, name
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 5e-3 * np.abs(b).max(), name


def test_plain_version_matches_the_einsum_reference():
    """The dispatch on CPU is the plain flash version; with a float64
    einsum-and-softmax oracle it agrees too (no JAX in the loop)."""
    rng, q, k, v, _ = _inputs(5)
    bias = _bias(_padding_mask(rng, q.shape[0], k.shape[2]))
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              bias=torch.from_numpy(bias), causal=True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / 4.0
    s = s + bias[:, None, None, :]
    s = np.where(np.tril(np.ones((16, 16), bool)), s, MASK)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), np.einsum("bhqk,bhkd->bhqd",
                                                      p, v), **TOL)


MASK_SHAPES = ["B_Lk", "B_1_Lk", "B_Lq_Lk", "B_1_1_Lk", "B_H_Lq_Lk"]


def _mask(rng, shape_name, B, H, Lq, Lk):
    shape = {"B_Lk": (B, Lk), "B_1_Lk": (B, 1, Lk), "B_Lq_Lk": (B, Lq, Lk),
             "B_1_1_Lk": (B, 1, 1, Lk),
             "B_H_Lq_Lk": (B, H, Lq, Lk)}[shape_name]
    m = rng.rand(*shape) < 0.75
    m[..., 0] = True                    # no fully masked row
    return m.astype(np.float32)


@pytest.mark.parametrize("shape_name", MASK_SHAPES)
@pytest.mark.parametrize("jax_flash", [True, False])
def test_dot_product_attention_mask_broadcasting(monkeypatch, shape_name,
                                                 jax_flash):
    """B == Lq, so a mask broadcast along the wrong axis would not raise;
    both the flash route and the reference route must match JAX's."""
    if jax_flash:
        monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("MXTPU_PALLAS_INTERPRET", raising=False)
    rng, q, k, v, _ = _inputs(6, B=8, H=2, Lq=8, Lk=16)
    m = _mask(rng, shape_name, 8, 2, 8, 16)
    want = np.asarray(jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(m)))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    for use_flash in (True, False):
        got = tattn.dot_product_attention(*args, mask=torch.from_numpy(m),
                                          use_flash=use_flash)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    rng, q, k, v, _ = _inputs(7, B=4, Lq=4, Lk=12)
    bias = _bias(_padding_mask(rng, 4, 12))
    want = np.asarray(jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bias=jnp.asarray(bias)))
    got = tattn.reference_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        tattn.band_bias(6, 9, 2, causal).numpy(),
        np.asarray(jattn.band_bias(6, 9, 2, causal)))


def test_multi_head_attention_matches_jax(interpret):
    """Projected (B, L, E) inputs with a (B, 1, 1, L) float mask, as the
    BERT layer calls it; GQA splits k/v at fewer heads."""
    import mxnet_tpu as mx
    rng = np.random.RandomState(8)
    B, L, E, H = 2, 16, 32, 4
    q, k, v = (rng.randn(B, L, E).astype(np.float32) for _ in range(3))
    kv2 = rng.randn(B, L, E // 2).astype(np.float32)
    m = (np.arange(L)[None, :] < np.array([[11], [16]])).astype(
        np.float32).reshape(B, 1, 1, L)
    for kk, vv, g in ((k, v, None), (kv2, kv2, 2)):
        want = jattn.multi_head_attention(
            mx.np.array(q), mx.np.array(kk), mx.np.array(vv), H,
            mask=mx.np.array(m), num_kv_heads=g).asnumpy()
        got = tattn.multi_head_attention(
            *(torch.from_numpy(a) for a in (q, kk, vv)), H,
            mask=torch.from_numpy(m), num_kv_heads=g)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_attention_dropout_is_seeded_by_the_generator():
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(2, 16, 32).astype(np.float32))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tattn.multi_head_attention(x, x, x, 4, dropout_p=0.2,
                                          training=True, generator=gen)
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    eval_out = tattn.multi_head_attention(x, x, x, 4, dropout_p=0.2)
    assert torch.equal(eval_out, tattn.multi_head_attention(x, x, x, 4))


@pytest.mark.parametrize("entry", ["flash", "multi_head", "layer"])
def test_reference_entries_equal_the_dispatch(entry):
    """The oracle entries (`flash_attention_reference`,
    `multi_head_attention_reference`, and a `FusedSelfAttention` whose
    ``_attend`` is swapped for the latter) compute what the CPU dispatch
    computes, dropout masks and gradients included."""
    from mxnet_tpu_torch import autograd as tag
    from mxnet_tpu_torch.models.layers import FusedSelfAttention
    rng, q, k, v, g = _inputs(10)
    bias = torch.from_numpy(_bias(_padding_mask(rng, 2, 16)))
    x = torch.from_numpy(rng.randn(2, 16, 32).astype(np.float32))
    torch.manual_seed(0)
    layer = FusedSelfAttention(32, 4, dropout=0.2).initialize(device="cpu")

    def run(ref):
        ins = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        if entry == "flash":
            fn = tfa.flash_attention_reference if ref else tfa.flash_attention
            out = fn(*ins, bias=bias, dropout_rate=0.3,
                     dropout_seed=torch.tensor(5, dtype=torch.int32))
        elif entry == "multi_head":
            fn = tattn.multi_head_attention_reference if ref \
                else tattn.multi_head_attention
            ins = [t.reshape(2, 16, 32).detach().requires_grad_()
                   for t in ins]
            out = fn(*ins, 2, mask=bias[:, None, None, :] == 0.0,
                     dropout_p=0.3, training=True,
                     generator=torch.Generator().manual_seed(11))
        else:
            layer._attend = tattn.multi_head_attention_reference if ref \
                else tattn.multi_head_attention
            layer.dropout.generator = torch.Generator().manual_seed(11)
            ins = [x.clone().requires_grad_()]
            with tag.train_mode():
                out = layer(ins[0], (bias == 0.0).float()[:, None, None, :])
        out.backward(torch.ones_like(out))
        return [out.detach()] + [t.grad for t in ins]
    for a, b in zip(run(False), run(True)):
        assert torch.equal(a, b)


def test_flash_rejects_bad_inputs():
    q = torch.zeros(2, 4, 8, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q, torch.zeros(2, 3, 8, 16),
                            torch.zeros(2, 3, 8, 16))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="bias row dim"):
        tfa.flash_attention(q, q, q, bias=torch.zeros(2, 5, 8))
    with pytest.raises(MXNetError, match="cuda or cpu"):
        tfa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# ---------------------------------------------------------------------------
# the backward kernel's launch plan (plain Python, no card needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plan_at_bert_shape_is_one_key_tile(dtype):
    # BERT-base's attention: B 64, H 12, L 128, D 64 -- a 128-key tile holds
    # the whole head, so the block writes dQ and no partials exist
    p = tfa._bwd_plan(64, 12, 128, 128, 64, dtype, 132)
    assert (p.bk, p.dmax, p.bq) == (128, 64, 64)
    assert (p.key_tiles, p.q_tiles, p.blocks) == (1, 2, 768)
    assert (p.tickets, p.workspace) == (0, 0)
    # bf16: one persistent block an SM walks the items; f32: one an item
    assert p.grid == (132 if dtype == torch.bfloat16 else 768)


@pytest.mark.parametrize("D,dmax,bq", [(64, 64, 64), (128, 128, 32)])
def test_bwd_plan_at_gpt2_shape_splits_keys(D, dmax, bq):
    # GPT-2 small's training attention: B 8, H 12, L 1024 -- eight 128-key
    # tiles a head, each writing f32 dQ partials; one ticket a (bh, q tile);
    # one block an item in both dtypes (in bf16 the persistent walk of one
    # block an SM balances the causal items' sizes worse: 1.64 ms against
    # 0.72 on an H100)
    B, H, L = 8, 12, 1024
    p = tfa._bwd_plan(B, H, L, L, D, torch.float32, 132)
    assert (p.bk, p.dmax, p.bq, p.key_tiles) == (128, dmax, bq, 8)
    assert p.q_tiles == L // bq and p.blocks == p.grid == B * H * 8
    assert tfa._bwd_plan(B, H, L, L, D, torch.bfloat16, 132).grid == \
        B * H * 8
    # 1024 rows a head: no q split
    assert (p.q_splits, p.kv_tickets, p.kv_workspace) == (1, 0, 0)
    assert p.tickets == B * H * (L // bq)
    assert p.workspace == 8 * B * H * L * D


def test_bwd_plan_small_heads_and_grids_take_64_key_tiles():
    # Lk within 64: one 64-key tile, no partials
    for lk in (1, 33, 64):
        p = tfa._bwd_plan(64, 12, 128, lk, 64, torch.float32, 132)
        assert (p.bk, p.key_tiles, p.tickets, p.workspace) == (64, 1, 0, 0)
    # 128-key tiles would leave the grid short of one block an SM
    p = tfa._bwd_plan(2, 3, 128, 128, 64, torch.float32, 132)
    assert (p.bk, p.key_tiles, p.blocks) == (64, 2, 12)
    # a bf16 grid never exceeds the items
    assert tfa._bwd_plan(2, 3, 128, 128, 64, torch.bfloat16, 132).grid == 12
    assert (p.tickets, p.workspace) == (2 * 3 * 2, 2 * 2 * 3 * 128 * 64)
    # ragged shapes round up; D over 64 pads to 128 with 32-row q steps
    p = tfa._bwd_plan(2, 3, 257, 300, 80, torch.bfloat16, 132)
    assert (p.bk, p.dmax, p.bq, p.key_tiles, p.q_tiles) == (64, 128, 32, 5,
                                                            9)


def test_bwd_plan_override_and_bad_tile():
    p = tfa._bwd_plan(2, 3, 200, 300, 64, torch.float32, 132, bk=128)
    assert (p.bk, p.key_tiles, p.workspace) == (128, 3, 3 * 6 * 200 * 64)
    p = tfa._bwd_plan(2, 3, 100, 100, 64, torch.float32, 132, bk=128)
    assert (p.key_tiles, p.tickets, p.workspace) == (1, 0, 0)
    with pytest.raises(MXNetError, match="key tile"):
        tfa._bwd_plan(2, 3, 100, 100, 64, torch.float32, 132, bk=32)


def test_plans_count_items_under_the_fold():
    # the slice's GPT: 12 query heads over 3 kv heads, L 1024 -- 8 x 3
    # folded heads of 4 x 1024 rows; K/V tiles a folded head as unfolded
    fwd = tfa._fwd_plan(8, 12, 1024, 1024, 64, torch.bfloat16, 64, 64,
                        kv_heads=3)
    assert fwd.items == 8 * 3 * (4 * 1024 // 64)
    assert tfa._fwd_plan(8, 12, 1024, 1024, 64, torch.bfloat16, 64, 64
                         ).items == 8 * 12 * 1024 // 64
    bwd = tfa._bwd_plan(8, 12, 1024, 1024, 64, torch.bfloat16, 132,
                        kv_heads=3)
    assert (bwd.bk, bwd.key_tiles, bwd.q_tiles) == (128, 8, 4 * 1024 // 64)
    # 4096 folded rows: each key tile's q tiles in 4 splits of 1024 rows,
    # with f32 dK / dV partials and one ticket a (folded head, key tile)
    assert bwd.q_splits == 4
    assert bwd.blocks == bwd.grid == 8 * 3 * 8 * 4
    assert bwd.tickets == 8 * 3 * 64
    assert bwd.workspace == 8 * 8 * 12 * 1024 * 64     # as unfolded
    assert bwd.kv_tickets == 8 * 3 * 8
    assert bwd.kv_workspace == bwd.blocks * 2 * 128 * 64
    # MQA: one folded head a batch row; a ragged fold rounds up its rows
    # (1800 rows: two splits of 15 and 14 q tiles)
    p = tfa._bwd_plan(2, 12, 150, 260, 64, torch.bfloat16, 132, kv_heads=1)
    assert (p.bk, p.key_tiles, p.q_tiles, p.q_splits) == (64, 5, 29, 2)
    assert p.blocks == p.grid == 20 and p.tickets == 2 * 29
    # bf16 with one key tile a head keeps one persistent block an SM
    assert tfa._bwd_plan(64, 12, 128, 128, 64, torch.bfloat16, 132,
                         kv_heads=3).grid == 132
    assert tfa._fwd_plan(2, 3, 150, 260, 64, torch.float32, 64, 64,
                         kv_heads=1).items == 2 * -(-450 // 64)
    # without the fold, kv_heads = H changes nothing
    assert tfa._bwd_plan(8, 12, 1024, 1024, 64, torch.float32, 132,
                         kv_heads=12) == tfa._bwd_plan(
        8, 12, 1024, 1024, 64, torch.float32, 132)


_SMEM_CU = int(re.search(r"constexpr size_t SMEM_BLOCK = (\d+);",
                         (pathlib.Path(tfa.__file__).resolve().parents[1]
                          / "csrc" / "flash_attention.cu").read_text())[1])
_BQ_BK = {(64, 64), (64, 128), (128, 64), (128, 128), (32, 32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_plan_fits_a_blocks_shared_memory(dtype):
    """Every plan `_fwd_plan` and `_bwd_plan` return for D 1..256, at Lq,
    Lk in {1, 64, 1024} and any blocks asked for, fits the 227 KB a block
    may take (the .cu's `FITS` and its backward's static_assert), in
    tiles the C entry takes; heads over 128 wide pad to 256 columns."""
    assert tfa.SMEM_BLOCK == _SMEM_CU
    for D in range(1, 257):
        dmax = 64 if D <= 64 else 128 if D <= 128 else 256
        for lq in (1, 64, 1024):
            for lk in (1, 64, 1024):
                for bq in (8, 64, 128, 256):
                    for bk in (8, 64, 128, 256):
                        p = tfa._fwd_plan(2, 3, lq, lk, D, dtype, bq, bk)
                        assert p.dmax == dmax and (p.bq, p.bk) in _BQ_BK
                        assert p.smem == tfa._fwd_smem(dtype, dmax, p.bq,
                                                       p.bk)
                        assert p.smem <= tfa.SMEM_BLOCK, (D, p)
                b = tfa._bwd_plan(2, 3, lq, lk, D, dtype, 132)
                assert b.dmax == dmax and b.bk in tfa._bwd_key_tiles(
                    dmax, dtype)
                for bk in tfa._bwd_key_tiles(dmax, dtype):
                    assert tfa._bwd_smem(dtype, dmax, bk) <= \
                        tfa.SMEM_BLOCK, (D, bk)


@pytest.mark.parametrize("rows", [1, 64, 1024, 1025, 2048, 3072, 16384,
                                  16385])
def test_bwd_q_splits_cap_the_rows_a_block_sums(rows):
    """A key tile's q tiles are cut into the fewest splits of at most
    `BWD_SPLIT_ROWS` rows each (whole q tiles, none empty), as the kernel
    walks them: split s takes q tiles [s qper, (s + 1) qper) with qper =
    ceil(q tiles / q_splits)."""
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128, 256):
            p = tfa._bwd_plan(2, 1, rows, 300, D, dtype, 132)
            qper = -(-p.q_tiles // p.q_splits)
            assert qper * p.bq <= max(tfa.BWD_SPLIT_ROWS, p.bq)
            assert (p.q_splits - 1) * qper < p.q_tiles <= p.q_splits * qper
            assert p.q_splits == max(1, -(-rows // tfa.BWD_SPLIT_ROWS))
            assert p.blocks == 2 * p.key_tiles * p.q_splits
            cut = p.q_splits > 1
            assert p.kv_tickets == (2 * p.key_tiles if cut else 0)
            assert p.kv_workspace == (p.blocks * 2 * p.bk * D if cut else 0)


def test_wide_head_plans_take_the_tiles_that_fit():
    """Over 128 wide: forward 64 x 64 in bf16 and 32 x 32 in f32 whatever
    the blocks asked; backward 64-key tiles in bf16 and 32 in f32, any
    other raising; the tunable offers that one plan."""
    for dt, fwd, bk in ((torch.bfloat16, (64, 64), 64),
                        (torch.float32, (32, 32), 32)):
        p = tfa._fwd_plan(8, 3, 1024, 1024, 256, dt, 128, 128, kv_heads=1)
        assert (p.bq, p.bk, p.dmax) == fwd + (256,)
        assert p.items == 8 * 3 * 1024 // fwd[0]
        b = tfa._bwd_plan(8, 3, 1024, 1024, 256, dt, 132, kv_heads=1)
        assert (b.bk, b.dmax, b.bq) == (bk, 256, 32)
        assert b.key_tiles == 1024 // bk
        assert b.workspace == b.key_tiles * 8 * 3 * 1024 * 256
        with pytest.raises(MXNetError, match="key tile"):
            tfa._bwd_plan(8, 3, 1024, 1024, 256, dt, 132, bk=128)
        cands = tfa._at_candidates((8, 3, 1024, 1024, 256), str(dt)[6:])
        assert [(c.block_q, c.block_k) for c in cands] == [fwd]


# ---------------------------------------------------------------------------
# the kernels' tile walk under a window and the fold, mirrored in Python:
# which key tiles a forward item and warp step compute (and which steps
# need no mask), which q tiles a backward key tile visits, and which key
# tiles a dQ ticket waits for -- against the brute-force mask of `_scores`
# ---------------------------------------------------------------------------

_FA_CU = (pathlib.Path(tfa.__file__).resolve().parents[1] / "csrc"
          / "flash_attention.cu").read_text()


def _fa_const(pattern):
    (v,) = re.findall(pattern, _FA_CU)
    return v


# a band edge that never binds, the forward warp's step of keys (for
# heads over 128 wide, then the rest), and the backward's q tile (64 rows
# for heads up to 64 wide, else 32)
NO_EDGE = 1 << int(_fa_const(r"constexpr int NO_EDGE = 1 << (\d+);"))
KC_WIDE, KC = (int(x) for x in _fa_const(
    r"static constexpr int KC = QSMEM \? (\d+) : (\d+);"))
BWD_Q = tuple(int(x) for x in _fa_const(
    r"static constexpr int v = DMAX <= 64 \? (\d+) : (\d+);"))


class _Walk:
    """`make_params`' band and the kernels' `pos_span` / `key_span`, the
    forward's `tiles_of` and warp steps, the backward's `visitors` and
    `next_q`, over R = rep * seg rows against Lk keys."""

    def __init__(self, R, seg, Lk, causal, window, symmetric):
        win = window is not None and window >= 0
        self.R, self.seg, self.Lk = R, seg, Lk
        self.lo = min(window, NO_EDGE) if win else NO_EDGE
        self.hi = 0 if causal or (win and not symmetric) else (
            min(window, NO_EDGE) if win else NO_EDGE)

    def pos_span(self, r0, n):
        p0 = r0 % self.seg
        pe = p0 + min(n, self.R - r0) - 1
        return (p0, pe) if pe < self.seg else (0, self.seg - 1)

    def key_span(self, ps):
        return max(0, ps[0] - self.lo), min(self.Lk - 1, ps[1] + self.hi)

    def tiles(self, r0, n, bk):
        first, last = self.key_span(self.pos_span(r0, n))
        return (first // bk, last // bk) if first <= last else None

    def fwd_steps(self, q0, bq, bk, warp, step=KC):
        """(kc, full) of every `step`-key step warp `warp` of item q0
        runs."""
        tiles = self.tiles(q0, bq, bk) or (0, 0)
        wr0 = q0 + 16 * warp
        if wr0 >= self.R:
            return []
        wps = self.pos_span(wr0, 16)
        steps = []
        for kt in range(tiles[0], tiles[1] + 1):
            for c0 in range(0, bk, step):
                kc = kt * bk + c0
                if kc >= self.Lk or kc > wps[1] + self.hi:
                    break
                if kc + step <= wps[0] - self.lo:
                    continue
                full = (kc + step <= self.Lk and wr0 + 16 <= self.R
                        and kc >= wps[1] - self.lo
                        and kc + step - 1 <= wps[0] + self.hi)
                steps.append((kc, full))
        return steps

    def visitors(self, qt, bq, bk):
        return self.tiles(qt * bq, bq, bk)

    def bwd_walk(self, kt, bq, bk):
        nqt = -(-self.R // bq)
        out = []
        for qt in range(nqt):           # `next_q`, one tile at a time
            v = self.visitors(qt, bq, bk)
            if v is not None and v[0] <= kt <= v[1]:
                out.append(qt)
        return out


def _live(R, lq, Lk, causal, window, symmetric):
    """The plain version's mask: True where row r may attend key c."""
    s = tfa._scores(torch.zeros(1, 1, R, 1), torch.zeros(1, 1, Lk, 1), None,
                    1.0, causal, False, window, symmetric, lq)
    return (s[0, 0] > 0.5 * tfa.MASK_VALUE).numpy()


def _runs(xs):
    return sum(1 for i, x in enumerate(xs) if i == 0 or xs[i - 1] != x - 1)


def _pos_of(r, seg):
    """The kernels' `pos_of`: r % seg from the high half of r * seg_m,
    corrected once each way (`make_params`' seg_m)."""
    m = 0xFFFFFFFF if seg == 1 else ((1 << 32) + seg - 1) // seg
    x = r - seg * ((r * m) >> 32)
    x += seg if x < 0 else 0
    return x - seg if x >= seg else x


@pytest.mark.parametrize("seg", [1, 2, 3, 7, 64, 150, 1024, 4097, 65535,
                                 1 << 20, (1 << 30) - 1])
def test_kernel_position_division_is_the_remainder(seg):
    rng = np.random.RandomState(seg % 1000)
    rows = list(range(0, 300)) + [seg - 1, seg, seg + 1, 2 * seg - 1,
                                  (1 << 31) - 1] + \
        rng.randint(0, 1 << 31, 500).tolist()
    assert all(_pos_of(r, seg) == r % seg for r in rows if r < 1 << 31)


def test_walk_mirror_reads_the_kernel_constants():
    assert NO_EDGE == tfa._NO_EDGE and (KC, KC_WIDE) == (64, 32)
    assert BWD_Q == (64, 32)


@hyp.settings(max_examples=60, deadline=None, derandomize=True)
@hyp.given(lq=st.integers(1, 300), lk=st.integers(1, 300),
           window=st.one_of(st.none(), st.integers(0, 40)),
           causal=st.booleans(), symmetric=st.booleans(),
           rep=st.integers(1, 4),
           fwd_tiles=st.sampled_from([(64, 64, KC), (64, 128, KC),
                                      (128, 64, KC), (128, 128, KC),
                                      (64, 64, KC_WIDE),
                                      (32, 32, KC_WIDE)]),
           bwd_tiles=st.sampled_from([(bq, bk) for bq in BWD_Q
                                      for bk in tfa.BWD_KEY_TILES]
                                     + [(BWD_Q[1], 32)]))
def test_kernel_tile_walk_covers_the_band_exactly(lq, lk, window, causal,
                                                  symmetric, rep, fwd_tiles,
                                                  bwd_tiles):
    R = rep * lq
    live = _live(R, lq, lk, causal, window, symmetric)
    walk = _Walk(R, lq, lk, causal, window, symmetric)
    # the forward: an item's key tiles span its live tiles, tight at both
    # ends unless its rows straddle two head segments (then the span of
    # every position's band, a superset); each warp's steps hold every live
    # key of its rows, and a step run unmasked is live throughout
    bq, bk, kc_step = fwd_tiles
    for q0 in range(0, R, bq):
        cols = np.flatnonzero(live[q0:q0 + bq].any(0))
        tiles = walk.tiles(q0, bq, bk)
        if q0 % lq + min(bq, R - q0) > lq:
            assert cols.size == 0 or (
                tiles[0] <= cols[0] // bk and cols[-1] // bk <= tiles[1])
        elif cols.size:
            assert tiles == (cols[0] // bk, cols[-1] // bk)
        else:
            assert tiles is None
        for warp in range(bq // 16):
            rows = live[q0 + 16 * warp:q0 + 16 * warp + 16]
            steps = walk.fwd_steps(q0, bq, bk, warp, kc_step)
            ran = np.zeros(lk, bool)
            for kc, full in steps:
                ran[kc:kc + kc_step] = True
                if full:
                    assert rows.shape == (16, lk) and kc + kc_step <= lk
                    assert rows[:, kc:kc + kc_step].all()
            assert not (rows.any(0) & ~ran).any()
    # the backward: each key tile visits every q tile it has a live pair
    # with; a q tile's ticket waits for exactly the key tiles that visit
    # it, a range; a q tile no key tile visits has no live row, and the
    # wrapper zeroes its dQ
    bq, bk = bwd_tiles
    nqt, nk = -(-R // bq), -(-lk // bk)
    walks = [walk.bwd_walk(kt, bq, bk) for kt in range(nk)]
    straddles = lq % bq and rep > 1        # a q tile may hold two segments
    for qt in range(nqt):
        v = walk.visitors(qt, bq, bk)
        visiting = [kt for kt in range(nk) if qt in walks[kt]]
        assert visiting == ([] if v is None else list(range(v[0], v[1] + 1)))
        block = live[qt * bq:(qt + 1) * bq]
        for kt in range(nk):
            pair = block[:, kt * bk:(kt + 1) * bk].any()
            assert qt in walks[kt] or not pair
            if not straddles:
                assert pair == (qt in walks[kt])
        if v is None:
            assert not block.any()
            assert window is not None and lq - 1 - window > lk - 1
    if not straddles:                      # one q-tile range a segment
        assert all(_runs(w) <= rep for w in walks)


# ---------------------------------------------------------------------------
# the forward's block sizes: JAX's `resolve_blocks`, the plan, the tunable
# ---------------------------------------------------------------------------

from mxnet_tpu.ops.pallas import autotune as jat          # noqa: E402
from mxnet_tpu_torch.ops import autotune as tat           # noqa: E402

BERT = (64, 12, 128, 128, 64)
GPT2 = (8, 12, 1024, 1024, 64)


@pytest.fixture
def tuner(monkeypatch, tmp_path):
    """One autotune cache directory for both packages (their keys agree on
    the CPU: op, shape bucket, dtype, device kind "cpu"), no block
    overrides, and both memory caches cleared before and after."""
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    for name in ("MXTPU_FLASH_BLOCK_Q", "MXTPU_FLASH_BLOCK_K",
                 "MXTPU_AUTOTUNE"):
        monkeypatch.delenv(name, raising=False)
    jat.clear_memory_cache()
    tat.clear_memory_cache()
    yield tmp_path
    jat.clear_memory_cache()
    tat.clear_memory_cache()


def _keep_config(path, shapes, dtype, **config):
    """Write a tuned flash config as both packages persist it."""
    import json
    key = jat._key("flash_attention", shapes, dtype, "cpu")
    assert key == tat._key("flash_attention", shapes, dtype, "cpu")
    with open(path / "autotune_flash_attention.json", "w") as f:
        json.dump({key: {"config": config}}, f)


# (explicit arguments, env, tuned config): each decided before the default
RESOLVE_CASES = {
    "explicit": (dict(block_q=128, block_k=64), {}, None),
    "explicit_beats_env": (dict(block_q=64, block_k=128),
                           dict(Q="128", K="64"), None),
    "explicit_beats_tuned": (dict(block_q=64, block_k=64), {},
                             dict(block_q=128, block_k=128)),
    "env": ({}, dict(Q="64", K="128"), None),
    "env_beats_tuned": ({}, dict(Q="128", K="64"),
                        dict(block_q=64, block_k=128)),
    "env_q_tuned_k": ({}, dict(Q="128"), dict(block_q=64, block_k=64)),
    "explicit_q_env_k": (dict(block_q=64), dict(K="128"), None),
    "explicit_k_tuned_q": (dict(block_k=64), {},
                           dict(block_q=128, block_k=128)),
    "tuned": ({}, {}, dict(block_q=64, block_k=128)),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resolve_blocks_matches_jax(tuner, monkeypatch, case, dtype):
    args, env, tuned = RESOLVE_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(f"MXTPU_FLASH_BLOCK_{k}", v)
    if tuned is not None:
        _keep_config(tuner, BERT, dtype, **tuned)
    want = jfa.resolve_blocks(*BERT, jnp.zeros((), dtype).dtype, **args)
    got = tfa.resolve_blocks(*BERT, getattr(torch, dtype), **args)
    assert got == want
    sources = [s for _, s in tfa._resolve(*BERT, getattr(torch, dtype),
                                          args.get("block_q"),
                                          args.get("block_k"))]
    assert all(s in ("explicit", "env", "tuned") for s in sources)


def test_resolve_blocks_defaults_are_the_cards_plan(tuner, monkeypatch):
    """Where nothing chooses, JAX falls back to 256 and the port to its own
    plan (`DEFAULT_BLOCKS`); so does an env value that is not a number,
    and ``MXTPU_AUTOTUNE=0`` hides a tuned config from both."""
    dt = jnp.zeros((), "float32").dtype
    assert tfa.DEFAULT_BLOCKS == (64, 64)
    assert jfa.resolve_blocks(*BERT, dt) == (256, 256)
    assert tfa.resolve_blocks(*BERT, torch.float32) == (64, 64)
    assert tfa.resolve_blocks(*GPT2, torch.bfloat16) == (64, 64)
    monkeypatch.setenv("MXTPU_FLASH_BLOCK_Q", "many")
    monkeypatch.setenv("MXTPU_FLASH_BLOCK_K", "128")
    assert jfa.resolve_blocks(*BERT, dt) == (256, 128)
    assert tfa.resolve_blocks(*BERT, torch.float32) == (64, 128)
    monkeypatch.delenv("MXTPU_FLASH_BLOCK_Q")
    monkeypatch.delenv("MXTPU_FLASH_BLOCK_K")
    _keep_config(tuner, BERT, "float32", block_q=128, block_k=128)
    jat.clear_memory_cache()        # both remember the miss above
    tat.clear_memory_cache()
    monkeypatch.setenv("MXTPU_AUTOTUNE", "0")
    assert jfa.resolve_blocks(*BERT, dt) == (256, 256)
    assert tfa.resolve_blocks(*BERT, torch.float32) == (64, 64)
    monkeypatch.delenv("MXTPU_AUTOTUNE")
    assert jfa.resolve_blocks(*BERT, dt) == (128, 128)
    assert tfa.resolve_blocks(*BERT, torch.float32) == (128, 128)


def test_fwd_plan_snaps_and_fits_shared_memory():
    # BERT-base: 768 heads of one 128-row tile, 8 warps a block
    p = tfa._fwd_plan(*BERT, torch.bfloat16, 128, 128, "default")
    assert (p.bq, p.bk, p.dmax, p.items) == (128, 128, 64, 768)
    assert p.smem == 2 * (2 * 128 + 4 * 128) * 72 and p.source == "default"
    assert p.grid == 0          # the card's occupancy decides
    # JAX's block sizes snap to the card's tiles
    assert tfa._fwd_plan(*BERT, torch.float32, 256, 512)[:2] == (128, 128)
    assert tfa._fwd_plan(*BERT, torch.float32, 8, 16)[:2] == (64, 64)
    # ragged rows round up; D over 64 pads to 128 and takes 64-row items
    p = tfa._fwd_plan(2, 3, 200, 77, 80, torch.bfloat16, 128, 128)
    assert (p.bq, p.bk, p.dmax, p.items) == (64, 128, 128, 6 * 4)
    # f32 128-wide heads: only 64 x 64 tiles fit a block's 227 KB
    for bq in (64, 128):
        for bk in (64, 128):
            p = tfa._fwd_plan(2, 3, 256, 256, 128, torch.float32, bq, bk)
            assert (p.bq, p.bk) == (64, 64) and p.smem <= tfa.SMEM_BLOCK
    assert tfa._fwd_smem(torch.float32, 128, 64, 128) > tfa.SMEM_BLOCK
    assert tfa._fwd_smem(torch.float32, 64, 128, 128) <= tfa.SMEM_BLOCK


@pytest.mark.parametrize("shapes,dtype,want", [
    (BERT, "bfloat16", [(64, 64), (64, 128), (128, 64), (128, 128)]),
    (BERT, "float32", [(64, 64), (64, 128), (128, 64), (128, 128)]),
    (GPT2, "bfloat16", [(64, 64), (64, 128), (128, 64), (128, 128)]),
    ((2, 2, 100, 100, 64), "float32", [(64, 64)]),
    ((2, 2, 100, 300, 64), "float32", [(64, 64), (64, 128)]),
    ((2, 2, 40, 40, 32), "bfloat16", [(64, 64)]),
    ((8, 12, 1024, 1024, 128), "float32", [(64, 64)]),
    ((8, 12, 1024, 1024, 128), "bfloat16", [(64, 64), (64, 128)]),
])
def test_flash_tunable_candidates(shapes, dtype, want):
    """The card's menu pruned by JAX's rule on Lq and Lk, by a block's
    shared memory (f32 128-wide heads keep 64 x 64 alone) and to 64 rows
    for heads over 64 wide; a shape no block fits keeps (64, 64)."""
    got = [(c.block_q, c.block_k) for c in tfa._at_candidates(shapes, dtype)]
    assert got == want


@pytest.mark.parametrize("shapes", [BERT, GPT2, (2, 2, 100, 300, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_tunable_roofline_is_jaxs(shapes, dtype):
    for c in tfa._at_candidates(shapes, dtype):
        cfg = jat.BlockConfig(block_q=c.block_q, block_k=c.block_k)
        assert tfa._at_roofline(c, shapes, dtype) == \
            jfa._at_roofline(cfg, shapes, dtype)


def test_flash_tunable_build_matches_jax_and_tunes_on_cpu(tuner,
                                                          monkeypatch):
    """The trial launch runs the causal forward on JAX's seeded inputs (the
    plain version on the CPU, JAX's kernel in interpret mode); a cold
    search keeps a config that `resolve_blocks` then returns, and a warm
    one runs no trial."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    shapes = (1, 2, 64, 64, 16)
    cfg = tat.BlockConfig(block_q=64, block_k=64)
    got = tfa._at_build(cfg, shapes, "float32")()
    want = jfa._at_build(jat.BlockConfig(block_q=64, block_k=64), shapes,
                         "float32")()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cold = tat.tune("flash_attention", shapes, "float32", warmup=0, runs=1)
    assert not cold.cache_hit and cold.trials == 1
    warm = tat.tune("flash_attention", shapes, "float32")
    assert warm.cache_hit and warm.trials == 0
    assert tfa.resolve_blocks(*shapes, torch.float32) == (64, 64)


@pytest.mark.parametrize("block_q,block_k", [(8, 16), (16, 8), (16, 16)])
def test_flash_blocks_argument_matches_jax(interpret, block_q, block_k):
    """`flash_attention(..., block_q=, block_k=)` on the CPU against the JAX
    kernel at the same blocks (interpret mode): the plain version ignores
    them, JAX tiles by them, the results agree."""
    rng, q, k, v, g = _inputs(11)
    bias = _bias(_padding_mask(rng, q.shape[0], k.shape[2]))
    want_fn = lambda q_, k_, v_: jfa.flash_attention(      # noqa: E731
        q_, k_, v_, causal=True, block_q=block_q, block_k=block_k,
        bias=jnp.asarray(bias))
    out, vjp = jax.vjp(want_fn, jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    want = [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _torch(q, k, v, g, causal=True, block_q=block_q, block_k=block_k,
                 bias=torch.from_numpy(bias))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    ref = tfa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
        block_q=block_q, block_k=block_k, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(ref.numpy(), want[0], **TOL)
