"""Port parity for the serving slice as a whole: a JAX ``GPTForCausalLM``
is initialised from a seed, its parameters are carried into the port with
`load_jax_params`, and the port must then reproduce the JAX package:

- the decode core (`transformer_step` + `lm_logits`) on one prefill chunk
  to atol 1e-4 (f32; summation order differs between XLA and torch);
- greedy streams token for token: `GPTForCausalLM.generate` against JAX
  `generate`, and the port's `InferenceEngine(device="cpu")` against JAX's
  `InferenceEngine` with 6 concurrent requests over a pool small enough to
  force an eviction, for MHA, GQA, RoPE and int8/int4 weights;
- the int8 KV pool (``kv_dtype="int8"``) against JAX's int8 engine, alone,
  under int8/int4 weights and under ``MXTPU_QUANT_ACT=1`` with calibrated
  thresholds: greedy streams token for token except where JAX's top-2
  logit gap (over int8 K/V) is below 1e-4; the int8 planes after a prefill
  step equal JAX's in at least 99.9% of entries and never off by more than
  one, the scales within 1e-6 relative; pool bytes, page bytes and the auto
  pool's bonus pages equal;
- an f16 model over an f16 pool: the decode core's hidden state and
  logits within 5e-3 of their scale, and the engine's streams (dense and
  int8 weights) token for token against JAX's f16 engine.

Sampled streams cannot match JAX's PRNG: they are held to determinism from
the engine seed and to the top-k/top-p support.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.models.gpt import GPTConfig as JGPTConfig
from mxnet_tpu.models.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.models.gpt import _filter_logits as j_filter_logits
from mxnet_tpu.serve import InferenceEngine as JEngine
from mxnet_tpu.serve import ServeConfig as JServeConfig
from mxnet_tpu.serve import decode as jdecode
from mxnet_tpu.serve.kv_cache import PageAllocator as JPageAllocator

from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from mxnet_tpu_torch.models.gpt import _filter_logits
from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig, decode
from mxnet_tpu_torch.serve.kv_cache import PageAllocator

torch.set_num_threads(1)

BASE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=128, dropout=0.0)
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}, "rope": {"rope": True}}
_MODELS = {}


def _pair(variant, dtype="float32"):
    """(jax model, port model) with identical weights, cached per variant
    and dtype (built once per test process)."""
    if (variant, dtype) not in _MODELS:
        kw = dict(BASE, dtype=dtype, **VARIANTS[variant])
        mx.random.seed(7)
        jm = JGPT(JGPTConfig(**kw))
        jm.initialize(mx.init.Normal(0.2))
        jm(mx.np.array([[1, 2]], dtype="int32"))
        params = {k: p.data().asnumpy()
                  for k, p in jm.collect_params().items()}
        tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
        load_jax_params(tm, params, device="cpu")
        _MODELS[variant, dtype] = (jm, tm)
    return _MODELS[variant, dtype]


def _jax_generate(jm, prompt, n):
    ids = mx.np.array([prompt], dtype="int32")
    return np.asarray(jm.generate(ids, max_new_tokens=n).asnumpy())[0] \
        .tolist()


PROMPTS = [[3, 9, 1, 7, 2], [5], [10, 20, 30, 40, 50, 60, 70, 80, 90],
           [44, 2, 44, 2], [1, 2, 3, 4, 5, 6, 7], [96, 0, 50]]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_core_matches_jax_on_a_prefill_chunk(variant):
    jm, tm = _pair(variant)
    C = 7
    tok = np.array([[3, 9, 1, 7, 2, 55, 12], [8, 8, 1, 0, 96, 4, 31]],
                   np.int32)
    pos = np.tile(np.arange(C, dtype=np.int32), (2, 1))
    cfg = jm.cfg
    Hkv = cfg.num_kv_heads or cfg.num_heads
    D = cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, 2, Hkv, 16, D)

    jP = jdecode.extract_decode_weights(jm)
    jkv, _ = jdecode.dense_kv_fn(jnp.zeros(shape), jnp.zeros(shape),
                                 jnp.asarray(pos))
    jh = jdecode.transformer_step(jP, cfg, jnp.asarray(tok),
                                  jnp.asarray(pos), jkv)
    jlog = jdecode.lm_logits(jP, jh)

    tP = decode.extract_decode_weights(tm)
    tkv = decode.dense_kv_fn(torch.zeros(shape), torch.zeros(shape),
                             torch.from_numpy(pos))
    with torch.inference_mode():
        th = decode.transformer_step(tP, tm.cfg, torch.from_numpy(tok),
                                     torch.from_numpy(pos), tkv)
        tlog = decode.lm_logits(tP, th)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_greedy_matches_jax(variant):
    jm, tm = _pair(variant)
    for prompt in PROMPTS[:3]:
        ref = _jax_generate(jm, prompt, 10)
        out = tm.generate(torch.tensor([prompt]), max_new_tokens=10)
        assert out[0].tolist() == ref


def _serve_six(engine):
    hs = [engine.submit(p, max_new_tokens=8) for p in PROMPTS]
    engine.run_until_idle()
    return [h.result(timeout=0) for h in hs], sum(h.evictions for h in hs)


# 3 slots over 6 allocatable 4-token pages: six requests of up to 17
# tokens (5 pages each) cannot all grow side by side -> evictions
_SC = dict(max_slots=3, page_size=4, num_pages=7, prefill_chunk=4,
           max_len=40)


@pytest.mark.parametrize("variant,bits", [("mha", 0), ("gqa", 0),
                                          ("rope", 0), ("mha", 8),
                                          ("mha", 4)])
def test_engine_streams_match_jax_engine_with_eviction(variant, bits):
    jm, tm = _pair(variant)
    jeng = JEngine(jm, JServeConfig(quant_bits=bits, **_SC))
    teng = InferenceEngine(tm, ServeConfig(quant_bits=bits, **_SC),
                           device="cpu")
    assert teng.quant_bits == jeng.quant_bits == bits
    assert teng.weight_bytes() == jeng.weight_bytes()
    jout, jev = _serve_six(jeng)
    tout, tev = _serve_six(teng)
    assert jev >= 1 and tev >= 1
    assert tout == jout
    if bits == 0:
        # ... and the unbatched dense-cache generate, on both sides
        for prompt, got in zip(PROMPTS, tout):
            assert got == _jax_generate(jm, prompt, 8)


def test_f16_decode_core_logits_match_jax_over_an_f16_pool():
    """An f16 model's decode core on one prefill chunk over an f16 paged
    pool, as the engine runs it: f32 queries after the first LayerNorm's
    f32 gain read K/V rounded into the f16 pool, on both sides; the hidden
    state and the logits f32, within 5e-3 of their scale (f16 pages and
    f16 weights widened into f32 products)."""
    from mxnet_tpu.serve import kv_cache as jkv
    from mxnet_tpu_torch.serve import kv_cache as tkv
    jm, tm = _pair("gqa", "float16")
    cfg = jm.cfg
    Hkv = cfg.num_kv_heads or cfg.num_heads
    D = cfg.hidden_size // cfg.num_heads
    tok = np.array([[3, 9, 1, 7, 2, 55, 12], [8, 8, 1, 0, 96, 4, 31]],
                   np.int32)
    C = tok.shape[1]
    pos = np.tile(np.arange(C, dtype=np.int32), (2, 1))
    tables = np.array([[1, 2], [3, 4]], np.int32)
    start = np.zeros(2, np.int32)
    n = np.full(2, C, np.int32)
    shape = (cfg.num_layers, 5, 4, Hkv, D)
    jpools = {"k": jnp.zeros(shape, jnp.float16),
              "v": jnp.zeros(shape, jnp.float16)}
    jkv_fn = jkv.make_paged_kv_fn(jpools, jnp.asarray(tables),
                                  jnp.asarray(start), jnp.asarray(n),
                                  jnp.asarray(n), 4, False)
    jP = jdecode.extract_decode_weights(jm)
    jh = jdecode.transformer_step(jP, cfg, jnp.asarray(tok),
                                  jnp.asarray(pos), jkv_fn)
    jlog = np.asarray(jdecode.lm_logits(jP, jh))
    pools = tkv.KVPools(cfg.num_layers, 5, 4, Hkv, D, torch.float16,
                        torch.device("cpu"))
    tkv_fn = tkv.make_paged_kv_fn(pools, torch.from_numpy(tables),
                                  torch.from_numpy(start),
                                  torch.from_numpy(n), torch.from_numpy(n))
    tP = decode.extract_decode_weights(tm)
    with torch.inference_mode():
        th = decode.transformer_step(tP, tm.cfg, torch.from_numpy(tok),
                                     torch.from_numpy(pos), tkv_fn)
        tlog = decode.lm_logits(tP, th)
    assert pools.k.dtype == torch.float16
    assert th.dtype == tlog.dtype == torch.float32
    assert np.asarray(jh).dtype == jlog.dtype == np.float32
    for got, want in ((th.numpy(), np.asarray(jh)), (tlog.numpy(), jlog)):
        assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()


def test_f16_pool_write_rounds_as_jax_astype():
    """The KV write into an f16 pool rounds f32 K/V once, to nearest even,
    with +-inf past f16's range and no clamp -- JAX's ``.astype(float16)``
    (numpy's cast, bit for bit), subnormals and halfway ties included."""
    from mxnet_tpu_torch.serve import kv_cache as tkv
    from mxnet_tpu_torch.ops.paged_attention import paged_attention_reference
    rng = np.random.RandomState(3)
    D, Hkv, C = 8, 2, 3
    vals = np.concatenate([[7e4, -1e5, 65504.0, 65520.0, 1 + 2.0 ** -11,
                            1 + 3 * 2.0 ** -11, 3e-8, -6e-8],
                           rng.randn(Hkv * C * D - 8) * 100])
    k = vals.astype(np.float32).reshape(1, Hkv, C, D)
    v = (-k).copy()
    pools = tkv.KVPools(1, 3, 4, Hkv, D, torch.float16, torch.device("cpu"))
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)       # noqa: E731
    kv = tkv.make_paged_kv_fn(pools, i32([[1, 2]]), i32([0]), i32([C]),
                              i32([C]), attend=paged_attention_reference)
    q = torch.zeros(1, Hkv, C, D)
    kv(0, q, torch.from_numpy(k), torch.from_numpy(v))
    got_k = pools.k[0, 1, :C].permute(1, 0, 2).numpy()
    got_v = pools.v[0, 1, :C].permute(1, 0, 2).numpy()
    with np.errstate(over="ignore"):         # inf past the range, as JAX
        want_k, want_v = k[0].astype(np.float16), v[0].astype(np.float16)
    np.testing.assert_array_equal(got_k.view(np.uint16),
                                  want_k.view(np.uint16))
    np.testing.assert_array_equal(got_v.view(np.uint16),
                                  want_v.view(np.uint16))
    assert np.isinf(got_k).sum() == 3


@pytest.mark.parametrize("bits", [0, 8])
def test_f16_engine_streams_match_jax_f16_engine(bits):
    """An f16 model served over an f16 pool (the pool takes the model's
    dtype on both sides), dense and with int8 weights, six requests with
    an eviction: the streams equal JAX's f16 engine's token for token."""
    jm, tm = _pair("mha", "float16")
    jeng = JEngine(jm, JServeConfig(quant_bits=bits, **_SC))
    teng = InferenceEngine(tm, ServeConfig(quant_bits=bits, **_SC),
                           device="cpu")
    assert teng.pools.k.dtype == torch.float16
    assert teng.pools.nbytes() == jeng.pools.nbytes()
    assert teng._page_nbytes() == jeng._page_nbytes(jeng._kv_dtype)
    jout, jev = _serve_six(jeng)
    tout, tev = _serve_six(teng)
    assert jev >= 1 and tev >= 1
    assert tout == jout


def test_engine_auto_pool_bonus_pages_match_jax():
    jm, tm = _pair("mha")
    sc = dict(max_slots=2, page_size=4, prefill_chunk=4, max_len=32,
              quant_bits=8)
    jeng = JEngine(jm, JServeConfig(**sc))
    teng = InferenceEngine(tm, ServeConfig(**sc), device="cpu")
    assert teng.bonus_pages == jeng.bonus_pages > 0
    assert teng.allocator.num_pages == jeng.allocator.num_pages
    assert teng.quant_info == jeng.quant_info


def test_allocator_page_ids_follow_jax_lifo_order():
    rng = np.random.RandomState(0)
    ja, ta = JPageAllocator(12, 4), PageAllocator(12, 4)
    held = []
    for _ in range(40):
        if held and rng.rand() < 0.4:
            pages = held.pop(rng.randint(len(held)))
            ja.free(pages)
            ta.free(pages)
        else:
            n = int(rng.randint(1, 4))
            got_j, got_t = ja.alloc(n), ta.alloc(n)
            assert got_t == got_j
            if got_t is not None:
                held.append(got_t)
        assert ta.free_pages == ja.free_pages


def test_allocator_refcounts_and_fork():
    a = PageAllocator(4, 2)
    (p,) = a.alloc(1)
    a.share([p])
    assert a.refcount(p) == 2 and a.shared_pages() == 1
    new, copied = a.fork(p)
    assert copied and new != p and a.refcount(p) == 1
    assert a.fork(p) == (p, False)
    a.free([p, new])
    with pytest.raises(MXNetError, match="double free"):
        a.free([p])
    with pytest.raises(MXNetError, match="null page"):
        a.free([0])


def test_filter_logits_matches_jax_with_ties():
    rng = np.random.RandomState(1)
    logits = rng.randint(0, 6, (4, 23)).astype(np.float32)   # many ties
    for top_k, top_p in ((0, 1.0), (5, 1.0), (0, 0.6), (7, 0.8), (1, 1.0)):
        ref = j_filter_logits(jnp.asarray(logits), top_k, top_p)
        out = _filter_logits(torch.from_numpy(logits), top_k, top_p)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_streams_repeat_from_the_engine_seed():
    _, tm = _pair("mha")

    def run(seed, **kw):
        eng = InferenceEngine(tm, ServeConfig(max_slots=3, page_size=4,
                                              prefill_chunk=4, max_len=40,
                                              **kw),
                              device="cpu", seed=seed)
        hs = [eng.submit(p, max_new_tokens=8, greedy=False,
                         temperature=1.5) for p in PROMPTS[:4]]
        eng.run_until_idle()
        return [h.result(timeout=0) for h in hs]

    a = run(11, top_k=5)
    assert a == run(11, top_k=5)
    assert all(0 <= t < 97 for s in a for t in s)
    # the support: top_k=1 or a vanishing nucleus leaves only the argmax,
    # so sampling reproduces the greedy streams
    greedy = [tm.generate(torch.tensor([p]), max_new_tokens=8)[0].tolist()
              for p in PROMPTS[:4]]
    assert run(3, top_k=1) == greedy
    assert run(4, top_p=1e-6) == greedy


def test_generate_sampling_is_seeded():
    _, tm = _pair("gqa")
    outs = [tm.generate(torch.tensor([[3, 9, 1]]), max_new_tokens=12,
                        greedy=False, temperature=2.0, top_k=10,
                        generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_engine_eos_deadline_failure_and_drain(monkeypatch):
    _, tm = _pair("mha")
    sc = dict(max_slots=2, page_size=4, prefill_chunk=4, max_len=40)
    eng = InferenceEngine(tm, ServeConfig(**sc), device="cpu")
    eng.warmup()
    gen = eng.generate([3, 9, 1], max_new_tokens=6)[3:]
    stop = next(i for i, t in enumerate(gen) if i and t not in gen[:i])
    h = eng.submit([3, 9, 1], max_new_tokens=6, eos_token_id=gen[stop])
    eng.run_until_idle()
    assert h.tokens == gen[:stop + 1] and h.state == "finished"

    h = eng.submit([3, 9, 1], max_new_tokens=6, deadline_ms=1e-6)
    eng.run_until_idle()
    assert h.state == "failed" and "deadline" in h.error
    assert eng.allocator.free_pages == eng.allocator.total_pages

    h1 = eng.submit([3, 9, 1], max_new_tokens=4)
    h2 = eng.submit([5, 2], max_new_tokens=4)

    def boom(*a, **kw):
        raise RuntimeError("device exploded")

    monkeypatch.setattr(eng, "_execute", boom)
    with pytest.raises(RuntimeError, match="device exploded"):
        eng.step()
    for h in (h1, h2):
        assert h.state == "failed"
        with pytest.raises(MXNetError, match="device exploded"):
            h.result(timeout=0)
    monkeypatch.undo()

    eng = InferenceEngine(tm, ServeConfig(max_slots=1, **{
        k: v for k, v in sc.items() if k != "max_slots"}), device="cpu")
    h1 = eng.submit([3, 9, 1], max_new_tokens=4)
    h2 = eng.submit([5, 2], max_new_tokens=4)
    eng.step()
    assert eng.drain() == [h2]
    assert h1.state == "finished" and h2.state == "queued"
    with pytest.raises(MXNetError, match="draining"):
        eng.submit([1], max_new_tokens=1)
    st = eng.stats()
    assert st["device"] == "cpu" and st["active_slots"] == 0


def test_submit_validation_matches_jax_messages():
    _, tm = _pair("mha")
    eng = InferenceEngine(tm, ServeConfig(max_slots=2, page_size=4,
                                          num_pages=4, prefill_chunk=4,
                                          max_len=16), device="cpu")
    with pytest.raises(MXNetError, match="KV pages"):
        eng.submit(list(range(8)), max_new_tokens=6)
    with pytest.raises(MXNetError, match="context cap"):
        eng.submit(list(range(12)), max_new_tokens=10)
    with pytest.raises(MXNetError, match="empty prompt"):
        eng.submit([], max_new_tokens=1)
    with pytest.raises(MXNetError, match="max_new_tokens"):
        eng.submit([1, 2], max_new_tokens=0)


# ---------------------------------------------------------------------------
# the int8 KV pool and int8 activations against JAX's engine
# ---------------------------------------------------------------------------

GAP = 1e-4


def _jax_gap(jeng, cfg, prefix):
    """JAX's top-2 logit gap for the token after `prefix`, through its
    decode core with the engine's weights and K/V rounded through
    `quantize_kv` as its int8 pool stores them."""
    from mxnet_tpu.contrib.quantization import dequantize_kv, quantize_kv
    T = len(prefix)
    Hkv = cfg.num_kv_heads or cfg.num_heads
    D = cfg.hidden_size // cfg.num_heads
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    shape = (cfg.num_layers, 1, Hkv, T, D)
    kv, _ = jdecode.dense_kv_fn(jnp.zeros(shape), jnp.zeros(shape), pos)

    def int8_kv(li, q, k, v):
        k, v = (dequantize_kv(*quantize_kv(x)) for x in (k, v))
        return kv(li, q, k, v)
    h = jdecode.transformer_step(jeng.P, cfg, jnp.asarray([prefix],
                                                          jnp.int32),
                                 pos, int8_kv)
    top = np.sort(np.asarray(jdecode.lm_logits(jeng.P, h[:, -1])[0]))
    return float(top[-1] - top[-2])


def _assert_streams_match(tout, jout, jeng, cfg):
    for t, j in zip(tout, jout):
        if t != j:
            k = next(i for i, (a, b) in enumerate(zip(t, j)) if a != b)
            assert _jax_gap(jeng, cfg, j[:k]) < GAP, (t, j)


def _thresholds(tm):
    """Calibrated activation thresholds of every quantized projection: a
    `LayerCalibrator` over the inputs each one sees in a forward of the
    six prompts (layers.<i>.<name>, as the JAX package keys them)."""
    from mxnet_tpu_torch.contrib.quantization import LayerCalibrator
    cal = LayerCalibrator()
    P = decode.extract_decode_weights(tm)

    def observing(x, w, name):
        cal.observe(name, x)
        return x @ w.T

    for prompt in PROMPTS:
        tok = torch.tensor([prompt])
        pos = torch.arange(len(prompt))[None]
        T, cfg = len(prompt), tm.cfg
        Hkv = cfg.num_kv_heads or cfg.num_heads
        shape = (cfg.num_layers, 1, Hkv, T, cfg.hidden_size // cfg.num_heads)
        kv = decode.dense_kv_fn(torch.zeros(shape), torch.zeros(shape), pos)
        names = iter(f"layers.{li}.{k}" for li in range(cfg.num_layers)
                     for k in ("wqkv", "wo", "w1", "w2"))
        with torch.inference_mode():
            decode.transformer_step(P, cfg, tok, pos, kv,
                                    matmul=lambda x, w: observing(
                                        x, w, next(names)))
    return cal.thresholds()


@pytest.mark.parametrize("variant,bits,act", [
    ("mha", 0, False), ("gqa", 0, False), ("rope", 0, False),
    ("mha", 8, False), ("mha", 4, False), ("mha", 8, True),
    ("gqa", 4, True), ("mha", 8, "calibrated")])
def test_int8_pool_streams_match_jax_engine(monkeypatch, variant, bits,
                                            act):
    if act:
        monkeypatch.setenv("MXTPU_QUANT_ACT", "1")
    jm, tm = _pair(variant)
    thr = _thresholds(tm) if act == "calibrated" else None
    sc = dict(_SC, kv_dtype="int8", quant_bits=bits)
    jeng = JEngine(jm, JServeConfig(**sc), act_thresholds=thr)
    teng = InferenceEngine(tm, ServeConfig(**sc), device="cpu",
                           act_thresholds=thr)
    assert teng.quantized and jeng.quantized
    assert teng.pools.k.dtype == torch.int8
    if thr:
        assert teng.P["layers"][1]["w1"].act_amax == \
            jeng.P["layers"][1]["w1"].act_amax == thr["layers.1.w1"]
    assert teng.pools.nbytes() == jeng.pools.nbytes()
    assert teng._page_nbytes() == jeng._page_nbytes(jeng._kv_dtype)
    jout, jev = _serve_six(jeng)
    tout, tev = _serve_six(teng)
    assert jev >= 1 and tev >= 1
    _assert_streams_match(tout, jout, jeng, jm.cfg)


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_int8_pool_planes_after_prefill_match_jax(variant):
    jm, tm = _pair(variant)
    sc = dict(max_slots=3, page_size=4, prefill_chunk=8, max_len=40,
              kv_dtype="int8")
    jeng = JEngine(jm, JServeConfig(**sc))
    teng = InferenceEngine(tm, ServeConfig(**sc), device="cpu")
    for eng in (jeng, teng):
        for p in PROMPTS[:3]:
            eng.submit(p, max_new_tokens=4)
        eng.step()
    arrs = jeng.pools.arrays
    # page 0 is the null page: padded rows land there in either order
    for name in ("k", "v"):
        got = getattr(teng.pools, name)[:, 1:].numpy().astype(np.int32)
        want = np.asarray(arrs[name])[:, 1:].astype(np.int32)
        off = np.abs(got - want)
        assert off.max() <= 1
        assert (off == 0).mean() >= 0.999
        gs = getattr(teng.pools, name + "_scale")[:, 1:].numpy()
        ws = np.asarray(arrs[name + "_scale"])[:, 1:]
        assert np.any(ws > 0)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_int8_pool_bytes_and_auto_bonus_pages_match_jax(bits):
    jm, tm = _pair("gqa")
    sc = dict(max_slots=2, page_size=4, prefill_chunk=4, max_len=32,
              kv_dtype="int8", quant_bits=bits)
    jeng = JEngine(jm, JServeConfig(**sc))
    teng = InferenceEngine(tm, ServeConfig(**sc), device="cpu")
    assert teng.bonus_pages == jeng.bonus_pages
    assert (teng.bonus_pages > 0) == (bits > 0)
    assert teng.allocator.num_pages == jeng.allocator.num_pages
    assert teng.pools.nbytes() == jeng.pools.nbytes()
    assert teng._page_nbytes() == jeng._page_nbytes(jeng._kv_dtype)
    # D + 4 bytes a stored vector (K and V, every layer)
    cfg = tm.cfg
    D = cfg.hidden_size // cfg.num_heads
    assert teng._page_nbytes() == 2 * cfg.num_layers * 4 * 2 * (D + 4)
    assert tuple(teng.pools.k_scale.shape) == \
        tuple(jeng.pools.arrays["k_scale"].shape)
    assert teng.stats()["kv_dtype"] == "int8"


def test_serve_config_env_defaults_and_unported_features(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_SLOTS", "3")
    monkeypatch.setenv("MXTPU_SERVE_PAGE_SIZE", "32")
    monkeypatch.setenv("MXTPU_QUANT_BITS", "4")
    sc = ServeConfig()
    assert (sc.max_slots, sc.page_size, sc.quant_bits) == (3, 32, 4)
    monkeypatch.delenv("MXTPU_QUANT_BITS")
    with pytest.raises(MXNetError, match="max_slots"):
        ServeConfig(max_slots=0)
    with pytest.raises(MXNetError, match="quant_bits"):
        ServeConfig(quant_bits=3)
    _, tm = _pair("mha")
    for kw in ({"tp": 2}, {"role": "prefill"}):
        with pytest.raises(MXNetError, match="ROADMAP"):
            InferenceEngine(tm, ServeConfig(**kw), device="cpu")
    # the int8 KV pool is ported (and MXTPU_SERVE_KV_DTYPE reaches it)
    monkeypatch.setenv("MXTPU_SERVE_KV_DTYPE", "int8")
    eng = InferenceEngine(tm, ServeConfig(max_slots=1, max_len=32),
                          device="cpu")
    assert eng.quantized and eng.pools.k_scale is not None
    monkeypatch.delenv("MXTPU_SERVE_KV_DTYPE")
    # speculation and the prefix cache are ported
    eng = InferenceEngine(tm, ServeConfig(max_slots=1, max_len=32,
                                          spec_tokens=2, prefix_cache=True),
                          device="cpu")
    assert eng.drafter is not None and eng.prefix_index is not None
    eng = InferenceEngine(tm, ServeConfig(max_slots=1, max_len=32),
                          device="cpu")
    for call in (lambda: eng.export("x"), lambda: eng.load_export("x"),
                 lambda: eng.adopt_executables(eng)):
        with pytest.raises(MXNetError, match="ROADMAP"):
            call()
