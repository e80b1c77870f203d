"""Port parity for beam search in ``GPTForCausalLM.generate`` against the
JAX package's ``generate(num_beams=K)`` / ``_generate_beam`` on the CPU.

The 2-layer, hidden-64 GPT of ``tests/test_torch_serve.py`` (``Normal(0.2)``
in JAX, carried over by `load_jax_params`); both sides take the same numpy
prompts, and the beams must equal JAX's token for token (the port breaks
top-k ties to the lower index, as ``lax.top_k``).  The properties of
``tests/unittest/test_models.py:500-560`` (beam beats greedy in joint
log-probability, a finished beam freezes on eos) hold on the port alone.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.gpt import GPTConfig as JGPTConfig
from mxnet_tpu.models.gpt import GPTForCausalLM as JGPT

from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

torch.set_num_threads(1)

BASE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=128, dropout=0.0)
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}, "rope": {"rope": True}}
_MODELS = {}
PROMPTS = np.array([[3, 9, 1, 7, 2], [44, 2, 44, 2, 5]], np.int32)


def _pair(variant="mha"):
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


def _eos(tm):
    """A token the free 4-beam search emits mid-stream in row 0."""
    free = tm.generate(torch.from_numpy(PROMPTS), 10, num_beams=4)
    return int(free[0, PROMPTS.shape[1] + 3])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("with_eos", [False, True])
def test_beam_search_equals_jax(variant, K, with_eos):
    jm, tm = _pair(variant)
    eos = _eos(tm) if with_eos else None
    want = jm.generate(mx.np.array(PROMPTS), max_new_tokens=10,
                       num_beams=K, eos_token_id=eos).asnumpy()
    got = tm.generate(torch.from_numpy(PROMPTS), 10, num_beams=K,
                      eos_token_id=eos)
    assert got.dtype == torch.int32 and got.shape == (2, 15)
    assert got.tolist() == want.tolist()


def test_beam_search_length_penalty_equals_jax():
    jm, tm = _pair()
    eos = _eos(tm)
    want = jm._generate_beam(mx.np.array(PROMPTS), 10, 3, eos,
                             length_penalty=2.0).asnumpy()
    got = tm._generate_beam(torch.from_numpy(PROMPTS), 10, 3, eos,
                            length_penalty=2.0)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("knob", [dict(greedy=False), dict(temperature=0.7),
                                  dict(top_k=5), dict(top_p=0.9)])
def test_sampling_knobs_with_beams_raise_as_in_jax(knob):
    jm, tm = _pair()
    p = torch.from_numpy(PROMPTS)
    with pytest.raises(ValueError, match="deterministic beam"):
        tm.generate(p, 2, num_beams=2, **knob)
    with pytest.raises(ValueError, match="deterministic beam"):
        jm.generate(mx.np.array(PROMPTS), max_new_tokens=2, num_beams=2,
                    **knob)


def test_generate_takes_jax_parameter_order():
    """``generate(ids, n, temperature, greedy, use_cache, num_beams,
    eos_token_id, top_k, top_p)`` positionally, as JAX's."""
    jm, tm = _pair()
    args = (10, 1.0, True, True, 3, 44)
    want = jm.generate(mx.np.array(PROMPTS), *args).asnumpy()
    assert tm.generate(torch.from_numpy(PROMPTS), *args).tolist() == \
        want.tolist()


def test_beam_search_beats_greedy_logprob():
    """The beam's joint log-probability is at least greedy's and the
    prompt prefix stays intact (JAX's ``test_models.py`` property)."""
    _, tm = _pair()
    p = torch.from_numpy(PROMPTS)
    plen = p.shape[1]
    greedy = tm.generate(p, max_new_tokens=6)
    beam = tm.generate(p, max_new_tokens=6, num_beams=4)
    assert torch.equal(beam[:, :plen], p)

    def joint_logp(ids):
        with torch.no_grad():
            lp = torch.log_softmax(tm(ids.long()).float(), dim=-1)
        return float(sum(lp[b, t, ids[b, t + 1]]
                         for b in range(ids.shape[0])
                         for t in range(plen - 1, ids.shape[1] - 1)))

    assert joint_logp(beam) >= joint_logp(greedy) - 1e-4


def test_beam_search_eos_freezes():
    """With the first token the free beam emits as eos, the returned
    sequence holds eos from its first emission onward."""
    _, tm = _pair("gqa")
    p = torch.tensor([[3, 7]])
    free = tm.generate(p, max_new_tokens=8, num_beams=2)[0]
    eos = int(free[2])
    out = tm.generate(p, max_new_tokens=8, num_beams=2,
                      eos_token_id=eos)[0]
    hit = (out[2:] == eos).nonzero()
    assert hit.numel() > 0
    assert bool((out[2 + int(hit[0]):] == eos).all())
