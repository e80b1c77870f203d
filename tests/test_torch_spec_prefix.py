"""Port parity for the decode fast path: speculative decoding
(`serve.spec`), the cross-request prefix cache (`PrefixIndex`) and its
copy-on-write page forks, against the JAX package on the CPU.

A 2-layer, hidden-64 JAX ``GPTForCausalLM`` (``Normal(0.2)``: JAX's
default init makes tiny models emit one repeated token) is carried into
the port with `load_jax_params`.  The JAX objects are the oracle: page ids
and reference counts of `PageAllocator` + `PrefixIndex` over one seeded op
sequence; streams, `spec_stats()` counts, prefix hits and COW forks of
JAX's `InferenceEngine` with the same `ServeConfig`, token for token.  The
port's engine with speculation off is held to the same streams.  The
property tests mirror ``tests/unittest/test_spec_prefix.py``.  An int8 KV
pool (``kv_dtype="int8"``) under speculation and the prefix cache is held
to JAX's int8 engine the same way: its copy-on-write forks must carry the
scale planes with the rows.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.gpt import GPTConfig as JGPTConfig
from mxnet_tpu.models.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.serve import InferenceEngine as JEngine
from mxnet_tpu.serve import ServeConfig as JServeConfig
from mxnet_tpu.serve.kv_cache import PageAllocator as JPageAllocator
from mxnet_tpu.serve.kv_cache import PrefixIndex as JPrefixIndex

from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig
from mxnet_tpu_torch.serve.kv_cache import PageAllocator, PrefixIndex
from mxnet_tpu_torch.serve.spec import Drafter, NGramDrafter

torch.set_num_threads(1)

BASE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=128, dropout=0.0)
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}, "rope": {"rope": True}}
_MODELS = {}


def _pair(variant="mha"):
    """(jax model, port model) with identical weights, cached per variant."""
    if variant not in _MODELS:
        kw = dict(BASE, **VARIANTS[variant])
        mx.random.seed(7)
        jm = JGPT(JGPTConfig(**kw))
        jm.initialize(mx.init.Normal(0.2))
        jm(mx.np.array([[1, 2]], dtype="int32"))
        tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
        load_jax_params(tm, {k: p.data().asnumpy()
                             for k, p in jm.collect_params().items()},
                        device="cpu")
        _MODELS[variant] = (jm, tm)
    return _MODELS[variant]


def _engines(variant="mha", **sc):
    jm, tm = _pair(variant)
    return (JEngine(jm, JServeConfig(**sc)),
            InferenceEngine(tm, ServeConfig(**sc), device="cpu"))


def _periodic_prompts(seed, n, prefix_len=10):
    """Prompts sharing a `prefix_len`-token prefix, each followed by a
    distinct short period repeated (so the n-gram drafter proposes)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 97, prefix_len).tolist()
    return prefix, [prefix + rng.randint(0, 97, rng.randint(2, 6)).tolist()
                    * 2 for _ in range(n)]


def _serve(eng, prompts, max_new, primer=None, **kw):
    if primer is not None:
        eng.generate(primer, max_new_tokens=max_new)
    hs = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    eng.run_until_idle()
    return [h.result(timeout=0) for h in hs], hs


# ---------------------------------------------------------------------------
# PageAllocator + PrefixIndex against JAX's
# ---------------------------------------------------------------------------

def _state(alloc, index):
    return ([alloc.refcount(p) for p in range(alloc.num_pages)],
            alloc.free_pages, alloc.shared_pages(), len(index),
            index.stats())


def test_prefix_index_follows_jax_over_a_seeded_op_sequence():
    """alloc / free / insert / lookup / longest_match / evict_pages on
    both packages' objects: every returned page id and count, and every
    page's reference count after each op, equal JAX's."""
    rng = np.random.RandomState(11)
    ps = 4
    ja, ta = JPageAllocator(24, ps), PageAllocator(24, ps)
    ji, ti = JPrefixIndex(ja, ps), PrefixIndex(ta, ps)
    stems = [rng.randint(0, 9, 14).tolist() for _ in range(3)]
    held = []                     # page lists a "sequence" still owns
    for _ in range(300):
        op = rng.randint(6)
        toks = stems[rng.randint(3)][:rng.randint(1, 15)] + \
            rng.randint(0, 9, rng.randint(0, 3)).tolist()
        if op == 0:
            n = int(rng.randint(1, 5))
            got_j, got_t = ja.alloc(n), ta.alloc(n)
            assert got_t == got_j
            if got_t is not None:
                held.append(got_t)
        elif op == 1 and held:
            pages = held.pop(rng.randint(len(held)))
            ja.free(pages)
            ta.free(pages)
        elif op == 2 and held:
            pages = held[rng.randint(len(held))]
            n = min(len(toks), len(pages) * ps)
            assert ti.insert(toks[:n], pages) == ji.insert(toks[:n], pages)
        elif op == 3:
            got_t, got_j = ti.lookup(toks), ji.lookup(toks)
            assert got_t == got_j
            if got_t[0]:
                held.append(got_t[0])
        elif op == 4:
            assert ti.longest_match(toks) == ji.longest_match(toks)
        elif op == 5:
            n = int(rng.randint(1, 4))
            assert ti.evict_pages(n) == ji.evict_pages(n)
        assert _state(ta, ti) == _state(ja, ji)
    for pages in held:
        ja.free(pages)
        ta.free(pages)
    assert ti.clear() == ji.clear()
    assert ta.free_pages == ja.free_pages == ta.total_pages


def test_pool_accounting_random_ops_vs_model():
    rng = np.random.RandomState(3)
    a = PageAllocator(num_pages=17, page_size=4)
    model = {}                           # page -> refcount oracle
    for _ in range(600):
        op = rng.randint(4)
        if op == 0:
            got = a.alloc(int(rng.randint(1, 4)))
            if got is not None:
                for p in got:
                    model[p] = 1
        elif op == 1 and model:
            p = int(rng.choice(list(model)))
            a.share([p])
            model[p] += 1
        elif op == 2 and model:
            p = int(rng.choice(list(model)))
            a.free([p])
            model[p] -= 1
            if model[p] == 0:
                del model[p]
        elif op == 3 and model:
            p = int(rng.choice(list(model)))
            got = a.fork(p)
            if got is None:
                continue
            new, copied = got
            if copied:
                model[p] -= 1
                model[new] = 1
            else:
                assert new == p and model[p] == 1
        assert a.free_pages + len(model) == a.total_pages
        for p, r in model.items():
            assert a.refcount(p) == r


def _index(num_pages=17, ps=4):
    a = PageAllocator(num_pages=num_pages, page_size=ps)
    return a, PrefixIndex(a, ps)


def test_prefix_insert_lookup_roundtrip_with_partial():
    a, idx = _index()
    toks = list(range(10))               # 2 full blocks + partial of 2
    pages = a.alloc(3)
    assert idx.insert(toks, pages) == 3
    assert all(a.refcount(p) == 2 for p in pages)   # one for the index
    got, n = idx.lookup(toks + [99])     # extends the cached prompt
    assert got == pages and n == 10
    assert all(a.refcount(p) == 3 for p in pages)   # caller attached
    a.free(got)
    # the partial only matches when its tokens are a prefix of the rest
    got2, n2 = idx.lookup(toks[:8] + [77, 78])
    assert got2 == pages[:2] and n2 == 8
    a.free(got2)
    assert idx.longest_match(toks) == 10
    assert idx.longest_match([42]) == 0
    with pytest.raises(MXNetError, match="span"):
        idx.insert(list(range(20)), pages)


def test_prefix_insert_existing_entries_refresh_not_duplicate():
    a, idx = _index()
    toks = list(range(8))
    p1 = a.alloc(2)
    assert idx.insert(toks, p1) == 2
    p2 = a.alloc(2)
    assert idx.insert(toks, p2) == 0     # first writer wins
    got, _ = idx.lookup(toks)
    assert got == p1                     # the original pages serve
    a.free(got)


def test_lru_eviction_never_reclaims_shared_pages():
    a, idx = _index(num_pages=9, ps=4)   # 8 allocatable
    old = a.alloc(2)
    idx.insert(list(range(8)), old)      # 2 entries (LRU-oldest)
    new = a.alloc(2)
    idx.insert(list(range(100, 108)), new)
    a.free(old)                          # only the index owns `old` now
    assert a.free_pages == 4
    assert idx.evict_pages(8) == 2       # both `old` entries, LRU first
    assert a.free_pages == 6
    assert all(a.refcount(p) == 2 for p in new)
    assert idx.longest_match(list(range(8))) == 0
    assert idx.longest_match(list(range(100, 108))) == 8
    a.free(new)
    assert idx.evict_pages(8) == 2
    assert a.free_pages == 8


def test_eviction_respects_chain_parents():
    a, idx = _index(num_pages=9, ps=2)
    pages = a.alloc(3)
    idx.insert([1, 2, 3, 4, 5, 6], pages)    # chain of 3 entries
    a.free(pages)
    assert idx.evict_pages(1) == 1           # must take the LEAF
    assert idx.longest_match([1, 2, 3, 4, 5, 6]) == 4


# ---------------------------------------------------------------------------
# engine: COW, speculation, both together — against JAX's engine
# ---------------------------------------------------------------------------

_SC = dict(max_slots=3, page_size=4, prefill_chunk=4, max_len=60)


def test_cow_fork_isolates_writer_and_cache_survives():
    """B attaches A's cached prompt pages (the partial block included),
    forks the partial one before writing past it; C then re-reads the
    cache and streams what A did.  Streams, hits and forks equal JAX's."""
    rng = np.random.RandomState(5)
    base = rng.randint(0, 97, 10).tolist()   # 2.5 pages at ps=4
    tail = base + [7, 9]
    sc = dict(_SC, prefix_cache=True)
    out = []
    for eng in _engines(**sc):
        a = eng.generate(base, max_new_tokens=8)
        assert len(eng.prefix_index) >= 3
        forks0 = eng.scheduler.cow_forks
        b = eng.generate(tail, max_new_tokens=8)
        assert eng.scheduler.cow_forks > forks0
        c = eng.generate(base, max_new_tokens=8)
        assert c == a                    # the cache survived B's writes
        assert eng.allocator.shared_pages() == 0
        st = eng.scheduler.spec_stats()
        out.append((a, b, st["prefix_hit_tokens"], st["cow_forks"]))
    assert out[1] == out[0]
    _, tm = _pair()
    for prompt, got in ((base, out[1][0]), (tail, out[1][1])):
        want = tm.generate(torch.tensor([prompt]), max_new_tokens=8)
        assert got == want[0].tolist()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_speculative_streams_match_jax_and_the_plain_decode(variant):
    """Greedy streams with an eos under speculation equal JAX's spec
    engine and the port's engine without speculation token for token; the
    spec_stats() counts equal JAX's."""
    _, tm = _pair(variant)
    _, prompts = _periodic_prompts(9, 5)
    base = InferenceEngine(tm, ServeConfig(**_SC), device="cpu")
    plain, _ = _serve(base, prompts, 12)
    eos = plain[0][len(prompts[0]) + 4]
    sc = dict(_SC, spec_tokens=3, prefill_chunk=5)
    jeng, teng = _engines(variant, **sc)
    jout, _ = _serve(jeng, prompts, 12, eos_token_id=eos)
    tout, _ = _serve(teng, prompts, 12, eos_token_id=eos)
    want, _ = _serve(InferenceEngine(tm, ServeConfig(**_SC), device="cpu"),
                     prompts, 12, eos_token_id=eos)
    assert tout == jout == want
    assert tout[0][-1] == eos and len(tout[0]) < len(prompts[0]) + 12
    tst, jst = teng.scheduler.spec_stats(), jeng.scheduler.spec_stats()
    assert tst == jst
    assert tst["proposed"] > 0 and tst["accepted"] > 0
    assert tst["tokens"] == sum(len(s) - len(p)
                                for s, p in zip(tout, prompts))


class _Recorder(Drafter):
    """An n-gram drafter that remembers every sequence it drafted for."""

    def __init__(self):
        self.inner = NGramDrafter()
        self.seen = []

    def propose(self, tokens, k):
        self.seen.append(list(tokens))
        return self.inner.propose(tokens, k)


def test_speculation_skips_non_greedy_slots():
    _, tm = _pair()
    rec = _Recorder()
    eng = InferenceEngine(tm, ServeConfig(spec_tokens=3, **_SC),
                          device="cpu", drafter=rec)
    assert eng.drafter is rec
    g = eng.submit([3, 1, 4, 1, 3, 1, 4, 1], max_new_tokens=6)
    s = eng.submit([2, 7, 1, 8, 2, 7], max_new_tokens=6, greedy=False,
                   temperature=0.9)
    eng.run_until_idle()
    want = tm.generate(torch.tensor([[3, 1, 4, 1, 3, 1, 4, 1]]),
                       max_new_tokens=6)[0].tolist()
    assert g.result(timeout=0) == want
    out = s.result(timeout=0)            # sampled: completes, in vocab
    assert len(out) == 12 and all(0 <= t < 97 for t in out)
    assert rec.seen and all(seq[:8] == [3, 1, 4, 1, 3, 1, 4, 1]
                            for seq in rec.seen)


def test_spec_with_int8_weights_matches_jax():
    _, prompts = _periodic_prompts(4, 4)
    jeng, teng = _engines(spec_tokens=4, quant_bits=8, **_SC)
    jout, _ = _serve(jeng, prompts, 10)
    tout, _ = _serve(teng, prompts, 10)
    assert tout == jout
    assert teng.scheduler.spec_stats() == jeng.scheduler.spec_stats()
    assert teng.quant_bits == 8


def test_spec_and_prefix_cache_together_match_jax_and_release_every_page():
    """A primer run to idle fills the cache, then six requests share its
    non-page-aligned prefix (a fork is certain) under speculation:
    streams, counts, free pages and index size equal JAX's; after drain
    and clear every page is free."""
    prefix, prompts = _periodic_prompts(0, 6)
    sc = dict(_SC, spec_tokens=3, prefix_cache=True)
    jeng, teng = _engines(**sc)
    jout, jh = _serve(jeng, prompts, 12, primer=prefix)
    tout, th = _serve(teng, prompts, 12, primer=prefix)
    assert tout == jout
    tst = teng.scheduler.spec_stats()
    assert tst == jeng.scheduler.spec_stats()
    assert tst["prefix_hit_tokens"] > 0 and tst["cow_forks"] >= 1
    assert [h.prefix_hits for h in th] == [h.prefix_hits for h in jh]
    assert teng.allocator.free_pages == jeng.allocator.free_pages
    assert len(teng.prefix_index) == len(jeng.prefix_index)
    st = teng.stats()
    assert st["spec_tokens"] == 3 and st["spec"] == tst
    assert st["prefix_cache"] == teng.prefix_index.stats()
    teng.drain()
    teng.prefix_index.clear()
    assert teng.allocator.free_pages == teng.allocator.total_pages
    # the streams are the engine's without either feature
    _, tm = _pair()
    want, _ = _serve(InferenceEngine(tm, ServeConfig(**_SC), device="cpu"),
                     prompts, 12)
    assert tout == want


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_int8_pool_spec_and_prefix_cache_match_jax(variant):
    """The int8 pool under speculation and the prefix cache: a fork is
    certain (a non-page-aligned shared prefix), so a copy that left the
    scale planes behind would read stale scales and change streams."""
    prefix, prompts = _periodic_prompts(1, 6)
    sc = dict(_SC, spec_tokens=4, prefix_cache=True, kv_dtype="int8")
    jeng, teng = _engines(variant, **sc)
    jout, jh = _serve(jeng, prompts, 12, primer=prefix)
    tout, th = _serve(teng, prompts, 12, primer=prefix)
    assert tout == jout
    tst = teng.scheduler.spec_stats()
    assert tst == jeng.scheduler.spec_stats()
    assert tst["prefix_hit_tokens"] > 0 and tst["cow_forks"] >= 1
    assert tst["accepted"] > 0
    assert teng.allocator.free_pages == jeng.allocator.free_pages
    # without the scale planes in the copy, the forked pages read zeros
    _, tm = _pair(variant)
    broken = InferenceEngine(tm, ServeConfig(**sc), device="cpu")
    broken.copy_page = lambda src, dst: [
        p[:, dst].copy_(p[:, src]) for p in (broken.pools.k, broken.pools.v)]
    bout, _ = _serve(broken, prompts, 12, primer=prefix)
    assert bout != tout


def test_copy_page_copies_the_int8_scale_planes():
    _, tm = _pair()
    eng = InferenceEngine(tm, ServeConfig(prefix_cache=True,
                                          kv_dtype="int8", **_SC),
                          device="cpu")
    for t in eng.pools.planes():
        t[:, 3] = torch.randint(1, 100, t[:, 3].shape).to(t.dtype)
    eng.copy_page(3, 5)
    assert len(eng.pools.planes()) == 4
    for t in eng.pools.planes():
        assert torch.equal(t[:, 5], t[:, 3]) and not t[:, 4].any()


def test_step_widths_and_warmup_cover_the_verify_width():
    _, tm = _pair()
    eng = InferenceEngine(tm, ServeConfig(spec_tokens=4, **_SC),
                          device="cpu")
    assert eng._step_widths() == [1, 4, 5]
    seen = []
    real = eng._step

    def spy(*a):
        seen.append(a[-2])
        return real(*a)

    eng._step = spy
    eng.warmup()
    assert seen == [1, 4, 5]
    assert InferenceEngine(tm, ServeConfig(spec_tokens=3, **_SC),
                           device="cpu")._step_widths() == [1, 4]
    assert eng.allocator.free_pages == eng.allocator.total_pages


def test_copy_page_copies_every_layer_k_and_v():
    _, tm = _pair()
    eng = InferenceEngine(tm, ServeConfig(prefix_cache=True, **_SC),
                          device="cpu")
    eng.pools.k[:, 3].normal_()
    eng.pools.v[:, 3].normal_()
    eng.copy_page(3, 5)
    assert torch.equal(eng.pools.k[:, 5], eng.pools.k[:, 3])
    assert torch.equal(eng.pools.v[:, 5], eng.pools.v[:, 3])
    assert not eng.pools.k[:, 4].any()


# ---------------------------------------------------------------------------
# NGramDrafter (JAX's two cases)
# ---------------------------------------------------------------------------

def test_ngram_drafter_prefers_longest_recent_suffix():
    d = NGramDrafter(max_ngram=3)
    seq = [1, 2, 3, 9, 1, 2, 3, 9]
    assert d.propose(seq, 3) == [1, 2, 3]
    assert d.propose(seq, 1) == [1]
    assert d.propose([7, 7, 7, 7], 4) == [7, 7, 7, 7]
    assert d.propose([5, 6, 5, 6], 4) == [5, 6, 5, 6]


def test_ngram_drafter_misses_cleanly():
    d = NGramDrafter(max_ngram=4)
    assert d.propose([1, 2, 3, 4, 5], 4) == []
    assert d.propose([1], 4) == []
    assert d.propose([1, 2, 1, 9], 0) == []
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=2, min_ngram=3)
