"""Port parity: weight-only int8/int4 quantization and the dequant-matmul
(mxnet_tpu_torch.ops.quantized_matmul) against the JAX package.

Quantization must agree BIT FOR BIT (planes and scales): both sides round
half to even over the same f32 arithmetic.  The matmul is compared at
rtol 1e-5 / atol 1e-6 in float32 (same dequantized weight, summation order
differs).  The int8-activation path (``MXTPU_QUANT_ACT``) must give JAX's
int8 activations and int32 sums bit for bit, and its outputs within 1e-6
of their scale.  f16 activations: the output in f16, within one f16 step
of JAX's reference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops.pallas import quantized_matmul as jqm

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import quantized_matmul as tqm

torch.set_num_threads(1)


def _weight(seed, n, k):
    rng = np.random.RandomState(seed)
    w = (rng.randn(n, k) * 0.3).astype(np.float32)
    w[1] = 0.0                     # an all-zero channel: scale 0
    # a row whose scaled values land exactly on .5: amax 127 -> inv 1
    w[2, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    w[2, 6:] = 0.0
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [16, 17])
def test_quantize_weight_bit_identical(bits, k):
    w = _weight(0, 6, k)
    ref = jqm.quantize_weight(jnp.asarray(w), bits)
    out = tqm.quantize_weight(torch.from_numpy(w), bits)
    assert out.bits == ref.bits and out.in_features == ref.in_features
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(
        tqm.dequantize_weight(out).numpy(),
        np.asarray(jqm.dequantize_weight(ref)))


def test_round_half_to_even_as_the_code_does():
    w = _weight(0, 6, 16)
    q = tqm.quantize_weight(torch.from_numpy(w), 8).q.numpy()
    # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2 (half to even), signs mirrored
    assert q[2, :6].tolist() == [127, 0, 2, 2, 0, -2]
    assert (q[1] == 0).all()


@pytest.mark.parametrize("k", [16, 15])
def test_int4_pack_roundtrip_full_range(k):
    rng = np.random.RandomState(1)
    vals = rng.randint(-8, 8, (5, k)).astype(np.int8)
    vals[0, :2] = [-8, 7]
    vals[1, -2:] = [7, -8]
    packed = tqm.pack_int4(torch.from_numpy(vals))
    assert packed.dtype == torch.int8 and packed.shape == (5, (k + 1) // 2)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jqm.pack_int4(vals)))
    np.testing.assert_array_equal(tqm.unpack_int4(packed, k).numpy(), vals)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [32, 33])
def test_quantized_matmul_matches_jax_reference(bits, k):
    rng = np.random.RandomState(2)
    w = _weight(3, 24, k)
    x = rng.randn(2, 5, k).astype(np.float32)
    jq = jqm.quantize_weight(jnp.asarray(w), bits)
    ref = jqm.quantized_matmul_reference(jnp.asarray(x.reshape(10, k)), jq)
    tq = tqm.quantize_weight(torch.from_numpy(w), bits)
    kernels.reset_launch_counts()
    out = tqm.quantized_matmul(torch.from_numpy(x), tq)
    assert out.shape == (2, 5, 24)
    assert kernels.launch_counts()["quantized_matmul"] == 0
    np.testing.assert_allclose(out.reshape(10, 24).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    # matmul_nt routes quantized weights, and the plain route agrees
    np.testing.assert_array_equal(tqm.matmul_nt(torch.from_numpy(x),
                                                tq).numpy(), out.numpy())
    np.testing.assert_array_equal(
        tqm.matmul_nt_reference(torch.from_numpy(x), tq).numpy(),
        out.numpy())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [32, 33])
def test_f16_activations_match_jax_reference(bits, k):
    """The plain K2 (the CPU dispatch) on f16 activations: the f32
    product of the f16 values with the dequantized weight, rounded once to
    f16 -- JAX's reference on the same inputs bit for bit but where the
    two f32 sums straddle an f16 rounding (one f16 step, 2**-10 of the
    value) -- and the output in x's f16, as JAX's (its kernel's
    ``out_shape`` takes x's dtype)."""
    rng = np.random.RandomState(4)
    w = _weight(5, 24, k)
    x = rng.randn(2, 5, k).astype(np.float16)
    jq = jqm.quantize_weight(jnp.asarray(w), bits)
    ref = jqm.quantized_matmul_reference(jnp.asarray(x.reshape(10, k)), jq)
    tq = tqm.quantize_weight(torch.from_numpy(w), bits)
    kernels.reset_launch_counts()
    out = tqm.quantized_matmul(torch.from_numpy(x), tq)
    assert out.dtype == torch.float16 and str(ref.dtype) == "float16"
    assert kernels.launch_counts()["quantized_matmul"] == 0
    got = out.reshape(10, 24).float().numpy()
    want = np.asarray(ref, np.float32)
    assert np.all(np.abs(got - want) <= 2.0 ** -10 * np.abs(want))


@pytest.mark.parametrize("bits", [8, 4])
def test_f16_tuning_key_round_trips(bits):
    """The K2 tunable's key for f16 activations is ``int<bits>_float16``
    and reads back as f16 (a key that does not end in bfloat16 used to
    tune f32 activations), bf16's and f32's as before; the trial launch
    builds its x in the key's dtype."""
    from mxnet_tpu_torch.ops import autotune as at
    for dt, key in ((torch.float16, f"int{bits}_float16"),
                    (torch.bfloat16, f"int{bits}_bfloat16"),
                    (torch.float32, f"int{bits}")):
        assert tqm._tune_dtype(bits, dt) == key
        assert tqm._x_dtype(key) == dt
        assert tqm._bits_of(key) == bits
    thunk = tqm._build(at.BlockConfig(variant=0, split=1), (8, 24, 32),
                       f"int{bits}_float16")
    assert thunk().dtype == torch.float16


@pytest.mark.parametrize("bits", [8, 4])
def test_gather_rows_and_nbytes_match_jax(bits):
    w = _weight(4, 10, 9)
    idx = np.array([[3, 0], [9, 3]], np.int32)
    jq = jqm.quantize_weight(jnp.asarray(w), bits)
    tq = tqm.quantize_weight(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(
        tqm.gather_rows(tq, torch.from_numpy(idx).long()).numpy(),
        np.asarray(jqm.gather_rows(jq, jnp.asarray(idx))))
    assert tq.nbytes() == jqm.weight_nbytes(jq)
    assert tqm.weight_nbytes(torch.from_numpy(w)) == \
        jqm.weight_nbytes(jnp.asarray(w))


def test_guards_raise():
    tq = tqm.quantize_weight(torch.randn(4, 8), 8)
    with pytest.raises(MXNetError, match="in_features"):
        tqm.quantized_matmul(torch.randn(2, 7), tq)
    with pytest.raises(MXNetError, match="QuantizedTensor"):
        tqm.quantized_matmul(torch.randn(2, 8), torch.randn(4, 8))
    with pytest.raises(MXNetError, match="bits"):
        tqm.quantize_weight(torch.randn(4, 8), 2)
    with pytest.raises(MXNetError, match="2-D"):
        tqm.quantize_weight(torch.randn(4), 8)


def test_int8_activation_path_raises_until_ported(monkeypatch):
    """The int8-activation path is ported: ``MXTPU_QUANT_ACT=1`` no longer
    raises, takes `int8_act_matmul` and launches no kernel."""
    monkeypatch.setenv("MXTPU_QUANT_ACT", "1")
    tq = tqm.quantize_weight(torch.randn(4, 8), 8)
    x = torch.randn(2, 8)
    kernels.reset_launch_counts()
    assert torch.equal(tqm.quantized_matmul(x, tq),
                       tqm.int8_act_matmul(x, tq))
    assert torch.equal(tqm.matmul_nt_reference(x, tq),
                       tqm.int8_act_matmul(x, tq))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("mode,on_card", [("auto", True), ("kernel", True),
                                          ("reference", False),
                                          ("off", False)])
def test_routing_follows_the_kernel_policy(monkeypatch, mode, on_card):
    """``MXTPU_PALLAS``: a card launches K2 under auto and kernel, the
    plain version under reference and off; the CPU always runs the plain
    version (no launch)."""
    from mxnet_tpu_torch import kernels
    monkeypatch.setenv("MXTPU_PALLAS", mode)
    assert tqm.launches_kernel(torch.device("cuda", 0)) is on_card
    assert tqm.launches_kernel(torch.device("cpu")) is False
    tq = tqm.quantize_weight(torch.randn(4, 8), 8)
    x = torch.randn(3, 8)
    kernels.reset_launch_counts()
    assert torch.equal(tqm.quantized_matmul(x, tq),
                       tqm.quantized_matmul_reference(x, tq))
    assert kernels.launch_counts()["quantized_matmul"] == 0


# ---------------------------------------------------------------------------
# K2's launch plan and its tunable (plain Python: no card needed)
# ---------------------------------------------------------------------------

GPT2_SHAPES = [(2304, 768), (768, 768), (3072, 768), (768, 3072)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 128])
@pytest.mark.parametrize("N,K", GPT2_SHAPES)
def test_plan_at_gpt2_shapes(dtype, bits, M, N, K):
    p = tqm._plan(M, N, K, bits, dtype, 132)
    # the variant switch: streaming up to M 16, tiles above
    assert p.variant == ("small" if M <= 16 else "large")
    if p.variant == "small":
        assert p.tile == (8, 16) and p.tiles == -(-N // 8)
        # the staged x chunk fits 40 KB
        assert (8 if M <= 8 else 16) * p.kc * 4 <= 40 * 1024
    else:
        assert p.tile == (64, 64, 32)
        assert p.tiles == -(-M // 64) * -(-N // 64)
    # the grid fills at least one wave of the 132 SMs
    assert p.blocks == p.tiles * p.split >= 132
    # the split tiles K: granule-aligned chunks, the last one not empty
    assert p.kc % tqm._granule(p.variant, bits) == 0
    assert p.split == -(-K // p.kc) and (p.split - 1) * p.kc < K
    assert p.workspace == (p.split * M * N if p.split > 1 else 0)


def test_plan_fills_the_card_and_overrides():
    # N = 768 alone gives 96 streaming blocks: split K until several per SM
    p = tqm._plan(8, 768, 768, 8, torch.float32, 132)
    assert (p.split, p.kc, p.blocks) == (3, 256, 288)
    # ... and until no lane loads more than three 16-byte vectors a split
    p = tqm._plan(8, 768, 3072, 8, torch.float32, 132)
    assert (p.split, p.kc, p.blocks) == (4, 768, 384)
    # the tile kernel: one wave, at most 12 K steps of 32 a split
    p = tqm._plan(128, 768, 3072, 8, torch.float32, 132)
    assert (p.split, p.kc, p.blocks) == (8, 384, 192)
    # grids already past two blocks an SM (two waves of tiles) not split
    for m in (8, 128):
        head = tqm._plan(m, 50257, 768, 8, torch.float32, 132)
        assert (head.split, head.workspace) == (1, 0)
    # overrides (the tuner's candidates) clamp to K's granules
    one = tqm._plan(8, 2304, 768, 8, torch.float32, 132, "large", 100)
    assert (one.variant, one.split, one.kc) == ("large", 24, 32)
    assert tqm._plan(128, 64, 33, 4, torch.float32, 132).split == 2
    with pytest.raises(MXNetError, match="M <= 16"):
        tqm._plan(17, 64, 64, 8, torch.float32, 132, "small")
    with pytest.raises(MXNetError, match="variant"):
        tqm._plan(8, 64, 64, 8, torch.float32, 132, "huge")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shapes", [(8, 2304, 768), (128, 768, 3072),
                                    (37, 70, 33)])
def test_tunable_roofline_matches_jax(bits, shapes):
    from mxnet_tpu.ops.pallas import autotune as jat
    dt = f"int{bits}"
    jcfg = jat.BlockConfig(block_m=64, block_n=128, block_k=128)
    want = jqm._roofline(jcfg, shapes, dt)
    cands = tqm._candidates(shapes, dt)
    assert cands
    for c in cands:
        got = tqm._roofline(c, shapes, dt)
        assert got["flops"] == want["flops"]
        assert got["bytes"] == want["bytes"]
        plan = tqm._plan(*shapes, bits, None, 132, tqm.VARIANTS[c.variant],
                         c.split)
        assert got["steps"] == plan.blocks and plan.split == c.split
    # the menu: both variants at M <= 16, the tile kernel alone above
    assert {c.variant for c in cands} == ({0, 1} if shapes[0] <= 16
                                          else {1})
    assert len({(c.variant, c.split) for c in cands}) == len(cands)


def test_tuned_plan_is_looked_up_once_per_generation(monkeypatch, tmp_path):
    from mxnet_tpu_torch.ops import autotune as at
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    at.clear_memory_cache()
    calls = []
    real = at.cached_config
    monkeypatch.setattr(tqm, "_sms", lambda device: 132)
    monkeypatch.setattr(at, "cached_config",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    try:
        dev = torch.device("cpu")
        p = tqm._tuned_plan(8, 2304, 768, 8, torch.float32, dev)
        assert p == tqm._plan(8, 2304, 768, 8, torch.float32, 132)
        for _ in range(47):
            tqm._tuned_plan(8, 2304, 768, 8, torch.float32, dev)
        assert len(calls) == 1
        assert calls[0][1:] == ((8, 2304, 768), "int8")
        # a tuned config moves the generation: the next call takes it
        cold = at.tune("quantized_matmul", (8, 2304, 768), "int8", runs=1,
                       top_k=2)
        assert cold.trials == 2
        p = tqm._tuned_plan(8, 2304, 768, 8, torch.float32, dev)
        assert len(calls) == 3          # tune's own lookup, then ours
        assert (tqm.VARIANTS.index(p.variant), p.split) == (
            cold.config.variant, cold.config.split)
        tqm._tuned_plan(8, 2304, 768, 4, torch.bfloat16, dev)
        assert calls[-1][1:] == ((8, 2304, 768), "int4_bfloat16")
    finally:
        at.clear_memory_cache()


# ---------------------------------------------------------------------------
# int8 activations (MXTPU_QUANT_ACT) against JAX's int8_act_matmul
# ---------------------------------------------------------------------------

def _jax_act_quant(x, jq, act_amax):
    """JAX's `int8_act_matmul` up to its int32 sums (xq, x_scale, acc), in
    its own expressions: the function returns only the scaled output."""
    import jax
    xf = x.astype(jnp.float32)
    if act_amax is None:
        act_amax = jq.act_amax
    amax = jnp.max(jnp.abs(xf)) if act_amax is None else \
        jnp.asarray(act_amax, jnp.float32)
    x_scale = amax / 127.0
    inv = jnp.where(x_scale > 0.0, 1.0 / jnp.maximum(x_scale, 1e-30), 0.0)
    xq = jnp.clip(jnp.round(xf * inv), -127, 127).astype(jnp.int8)
    q = jq.q if jq.bits == 8 else jqm.unpack_int4(jq.q, jq.in_features)
    acc = jax.lax.dot_general(xq, q, (((xf.ndim - 1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return xq, x_scale, acc


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("calib", ["dynamic", "argument", "on_weight",
                                   "clipping"])
def test_int8_act_matmul_matches_jax(bits, dtype, calib):
    rng = np.random.RandomState(11)
    w = _weight(3, 24, 40)
    x = (rng.randn(3, 5, 40) * 1.7).astype(np.float32)
    x[0, 0] = 0.0
    thr = {"dynamic": None, "argument": 3.5, "on_weight": 4.25,
           "clipping": 0.75}[calib]
    on_w = calib == "on_weight"
    arg = None if on_w else thr
    jq = jqm.quantize_weight(jnp.asarray(w), bits,
                             act_amax=thr if on_w else None)
    tq = tqm.quantize_weight(torch.from_numpy(w), bits,
                             act_amax=thr if on_w else None)
    assert tq.act_amax == jq.act_amax
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jxq, jscale, jacc = _jax_act_quant(jx, jq, arg)
    txq, tscale = tqm._quantize_act(tx, tq, arg)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    assert np.float32(float(tscale)) == np.asarray(jscale)
    tacc = tqm.int8_mm_nt(txq.reshape(-1, 40), tqm._rhs_planes(tq))
    np.testing.assert_array_equal(tacc.numpy(),
                                  np.asarray(jacc).reshape(-1, 24))
    jout = np.asarray(jqm.int8_act_matmul(jx, jq, act_amax=arg)
                      .astype(jnp.float32))
    tout = tqm.int8_act_matmul(tx, tq, act_amax=arg)
    assert tout.dtype == tx.dtype and tout.shape == (3, 5, 24)
    scale = float(np.abs(jout).max())
    assert float(np.abs(tout.float().numpy() - jout).max()) <= 1e-6 * scale


@pytest.mark.parametrize("M,K,N", [(8, 768, 2304), (1, 33, 50), (5, 40, 7),
                                   (17, 16, 24), (64, 100, 50257 % 64)])
def test_int_mm_padding_keeps_the_sums(M, K, N):
    """The card's ``torch._int_mm`` refuses M <= 16 and K or N off a
    multiple of 8: `_int_mm_padded` pads with zeros and slices back, which
    must give the unpadded sums exactly (here through the CPU's
    ``_int_mm``, which takes every shape), also over planes `_rhs_planes`
    already padded."""
    g = torch.Generator().manual_seed(M * 7 + K)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    want = a.int() @ b.int().T
    assert torch.equal(tqm.int8_mm_nt(a, b), want)
    assert torch.equal(tqm._int_mm_padded(a, b), want)
    bp = tqm._pad_to(b, -(-N // 8) * 8, -(-K // 8) * 8)
    assert torch.equal(tqm._int_mm_padded(a, bp)[:, :N], want)


def test_act_quant_env_routes(monkeypatch):
    """JAX's `test_act_quant_env_routes`: the env flag equals an explicit
    ``act_quant=True``, and ``act_quant=False`` is the weight-only path."""
    monkeypatch.setenv("MXTPU_QUANT_ACT", "1")
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 16).astype(np.float32))
    tq = tqm.quantize_weight(
        torch.from_numpy(rng.randn(6, 16).astype(np.float32)), 8)
    env_routed = tqm.quantized_matmul(x, tq)
    explicit = tqm.quantized_matmul(x, tq, act_quant=True)
    assert torch.equal(env_routed, explicit)
    weight_only = tqm.quantized_matmul(x, tq, act_quant=False)
    assert torch.equal(weight_only, tqm.quantized_matmul_reference(x, tq))
    monkeypatch.delenv("MXTPU_QUANT_ACT")
    assert not tqm.act_quant_enabled()
    assert torch.equal(tqm.quantized_matmul(x, tq), weight_only)
    assert torch.equal(tqm.matmul_nt(x, tq, act_amax=2.0),
                       weight_only)
    monkeypatch.setenv("MXTPU_QUANT_ACT", "1")
    assert torch.equal(tqm.matmul_nt(x, tq, act_amax=2.0),
                       tqm.int8_act_matmul(x, tq, act_amax=2.0))


def test_act_quant_backward_is_dx_against_the_dequantized_weight():
    """JAX's ``custom_vjp``: under act quant the cotangent of x is dy times
    the dequantized weight; the rounding passes no gradient of its own."""
    import jax
    rng = np.random.RandomState(8)
    w = _weight(4, 12, 16)
    x = rng.randn(3, 16).astype(np.float32)
    dy = rng.randn(3, 12).astype(np.float32)
    jq = jqm.quantize_weight(jnp.asarray(w), 8)
    jdx = jax.grad(lambda v: jnp.sum(jqm.quantized_matmul(
        v, jq, act_quant=True) * dy))(jnp.asarray(x))
    tq = tqm.quantize_weight(torch.from_numpy(w), 8)
    tx = torch.from_numpy(x).requires_grad_()
    (tqm.quantized_matmul(tx, tq, act_quant=True)
     * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)


def test_quantize_decode_weights_thresholds_match_jax():
    """`quantize_decode_weights(thresholds=)` puts the same ``act_amax`` on
    every leaf as JAX's: a leaf's own name first, then its kind."""
    from mxnet_tpu.serve import decode as jdecode
    from mxnet_tpu_torch.serve import decode as tdecode
    rng = np.random.RandomState(9)
    shapes = dict(wqkv=(48, 16), wo=(16, 16), w1=(32, 16), w2=(16, 32))
    layers = [{k: rng.randn(*s).astype(np.float32)
               for k, s in shapes.items()} for _ in range(2)]
    for L in layers:
        L["bqkv"] = rng.randn(48).astype(np.float32)
    embed = rng.randn(40, 16).astype(np.float32)
    thr = {"layers.0.wqkv": 2.0, "layers.1.w2": 7.5, "wo": 3.0,
           "embed": 1.5}

    def tree(conv):
        return dict(embed=conv(embed), pos=None, head=None,
                    lnf_g=conv(np.ones(16, np.float32)),
                    lnf_b=conv(np.zeros(16, np.float32)),
                    layers=[{k: conv(v) for k, v in L.items()}
                            for L in layers])
    for include in ((), ("embed",)):
        jP, jinfo = jdecode.quantize_decode_weights(
            tree(jnp.asarray), 8, include=include, thresholds=thr)
        tP, tinfo = tdecode.quantize_decode_weights(
            tree(torch.from_numpy), 8, include=include, thresholds=thr)
        assert tinfo == jinfo
        for li in range(2):
            for k in shapes:
                assert tP["layers"][li][k].act_amax == \
                    jP["layers"][li][k].act_amax, (li, k)
        assert getattr(tP["embed"], "act_amax", None) == \
            getattr(jP["embed"], "act_amax", None)
    assert tP["layers"][0]["wqkv"].act_amax == 2.0
    assert tP["layers"][1]["wqkv"].act_amax is None
    assert tP["layers"][1]["wo"].act_amax == 3.0
    # a quantized weight carries its threshold to another device
    assert tP["layers"][1]["w2"].to("cpu").act_amax == 7.5
