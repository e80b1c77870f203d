"""Port parity: GPT causal-LM training (mxnet_tpu_torch.models.gpt) against
the JAX package's ``GPTForCausalLM``.

A 2-layer, hidden-32, 4-head, FFN-64, vocab-97 GPT is initialised in JAX
(``Normal(0.2)``: JAX's default init makes tiny models emit one repeated
token), carried over by `load_jax_params`, and both sides run the same
numpy batch: a (4, 13) token stream from a seed, inputs ``[:, :-1]`` and
labels ``[:, 1:]``, with dropout 0 where the two packages are compared
(their PRNGs differ).  The JAX side runs its flash, cross-entropy, norm and
optimizer kernels in the Pallas interpreter (``MXTPU_PALLAS_INTERPRET=1``,
per test); the routes are ``MXTPU_PALLAS=reference`` (per-leaf optimizer,
the norms' reference math) and ``kernel`` (the fused norm and the
multi-tensor optimizer; on the port's side the CUDA kernels' plain
versions).

The modern GPT (RoPE, 2 or 1 kv heads, a window of 4; hidden 64) runs the
same checks through the flash kernels' folded, banded plain version.

Tolerances: f32 logits, every gradient of the causal-LM loss, losses and
weights after three `TrainStep` / five `Trainer` steps at atol/rtol 1e-4
(a dozen products deep, summation order differs); remat against no remat
at rtol 1e-5 (JAX's own limit, ``test_models.py:328``; the port
recomputes the same bits); bf16 logits within 2e-2 of their scale, f16
ones within 5e-3; three f16 `TrainStep` steps' losses at rtol 1e-4 and
weights within two learning rates (see the test); greedy streams token
for token.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import autograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import numpy_extension as npx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.models import gpt as jgpt
from mxnet_tpu.ops.pallas.softmax_xent import softmax_cross_entropy as jxent
from mxnet_tpu.parallel import make_mesh, make_sharded_train_step
from mxnet_tpu.serve import InferenceEngine as JEngine
from mxnet_tpu.serve import ServeConfig as JServeConfig
from mxnet_tpu.serve import decode as jdecode
from mxnet_tpu.serve import kv_cache as jkv

from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.models import gpt as tgpt
from mxnet_tpu_torch.ops import fused_norm, softmax_cross_entropy
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.optimizer import AdamW
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig, decode
from mxnet_tpu_torch.serve import kv_cache as tkv

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
V = 97
SMALL = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position=16)
B, L = 4, 12


@pytest.fixture(params=["reference", "kernel"])
def route(request, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXTPU_PALLAS", request.param)
    return request.param


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _jax_params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _pair(dtype="float32", **kw):
    cfg = dict(SMALL, dropout=0.0, dtype=dtype, **kw)
    mx.random.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    jm.initialize(mx.init.Normal(0.2))
    jm(mx.np.array(np.zeros((1, 2), np.int32)))         # deferred shapes
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu")
    load_jax_params(tm, _jax_params(jm), device="cpu")
    tm.eval()
    return jm, tm


def _stream(seed=1, batch=B, length=L):
    ids = np.random.RandomState(seed).randint(0, V, (batch, length + 1))
    ids = ids.astype(np.int32)
    return ids[:, :-1].copy(), ids[:, 1:].copy()


# ---------------------------------------------------------------------------
# the forward, causality, the gradients
# ---------------------------------------------------------------------------

def test_logits_match(route):
    jm, tm = _pair()
    ids, _ = _stream()
    want = jm(mx.np.array(ids)).asnumpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_causality():
    """Perturbing a future token must not change earlier logits (JAX's
    ``test_gpt_forward_and_causality``)."""
    _, tm = _pair()
    ids, _ = _stream()
    ids2 = ids.copy()
    ids2[:, 7] = (ids2[:, 7] + 1) % V
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
        out2 = tm(torch.from_numpy(ids2)).numpy()
    np.testing.assert_allclose(out[:, :7], out2[:, :7], rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(out[:, 7:], out2[:, 7:])


def test_every_gradient_of_the_causal_lm_loss_matches(route):
    jm, tm = _pair()
    ids, lab = _stream()
    with autograd.record():
        logits = jm(mx.np.array(ids))
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            logits.reshape(-1, V), mx.np.array(lab).reshape(-1)).mean()
    jloss.backward()
    logits = tm(torch.from_numpy(ids))
    tloss = SoftmaxCrossEntropyLoss()(logits.reshape(-1, V),
                                      torch.from_numpy(lab).reshape(-1))
    tloss = tloss.mean()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.asnumpy()), **TOL)
    jp = jm.collect_params()
    checked = 0
    for name, p in tm.named_parameters():
        want = jp[name].grad().asnumpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        checked += int(np.abs(want).max() > 0)
    assert checked == len(list(tm.parameters()))   # the loss reaches all


def test_the_residual_norm_has_a_plain_twin():
    """`LayerNorm.residual` (the block's fused second norm) and its oracle
    `fused_layer_norm_residual_reference` give the same values and
    gradients on the kernel route's plain version."""
    rng = np.random.RandomState(4)
    x, r = (torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32))
            .requires_grad_() for _ in range(2))
    g = torch.from_numpy(rng.rand(32).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    out = []
    for fn in (tnn.layer_norm_residual,
               fused_norm.fused_layer_norm_residual_reference):
        y, s = fn(x, r, g, b, eps=1e-3)
        dx, dr = torch.autograd.grad((y * y).sum() + s.sum(), (x, r))
        out.append((y, s, dx, dr))
    with_kernel_route = fused_norm.layer_norm_residual(x, r, g, b, eps=1e-3,
                                                       use_kernel=True)
    for a, c in zip(out[0], out[1]):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(with_kernel_route[0].detach().numpy(),
                               out[1][0].detach().numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# training: TrainStep against make_sharded_train_step, Trainer against JAX's
# ---------------------------------------------------------------------------

def _jax_loss(out, ids, lab):
    return jnp.mean(jxent(out.reshape(-1, V),
                          lab.reshape(-1).astype(jnp.int32)))


def _torch_loss(out, ids, lab):
    return softmax_cross_entropy(out.reshape(-1, V), lab.reshape(-1)).mean()


def _assert_params_match(jm, tm, tol=TOL):
    jp = jm.collect_params()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name].data().asnumpy(), err_msg=name,
                                   **tol)


def test_three_adamw_train_steps_match_jax(route):
    """epsilon 1e-6: the key part of the QKV bias has an exactly zero
    gradient (softmax ignores a per-row shift), so both sides see round-off
    there that Adam with epsilon 1e-8 would blow up into full steps."""
    jm, tm = _pair()
    kw = dict(learning_rate=3e-3, wd=0.1, epsilon=1e-6)
    mesh = make_mesh({"dp": 1}, jax.devices()[:1])
    jstep = make_sharded_train_step(jm, jopt.AdamW(**kw), _jax_loss, mesh,
                                    num_model_args=1)
    tstep = TrainStep(tm, AdamW(**kw), _torch_loss, num_model_args=1)
    ids, lab = _stream()
    jl = [float(jstep(mx.np.array(ids), mx.np.array(lab)))
          for _ in range(3)]
    tl = [float(tstep(ids, lab)) for _ in range(3)]
    jstep.sync_params_to_block()
    assert tstep._fused_opt_kernel == jstep._fused_opt_kernel == \
        (route == "kernel")
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    _assert_params_match(jm, tm)


def test_five_trainer_steps_match_jax(route):
    jm, tm = _pair()
    kw = {"learning_rate": 3e-3, "wd": 0.1, "epsilon": 1e-6}
    ids, lab = _stream()
    jtr = jgluon.Trainer(jm.collect_params(), "adamw", dict(kw))
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    jl = []
    for _ in range(5):
        with autograd.record():
            loss = jloss_fn(jm(mx.np.array(ids)).reshape(-1, V),
                            mx.np.array(lab).reshape(-1)).mean()
        loss.backward()
        jtr.step(1)
        jl.append(float(loss.asnumpy()))
    tr = Trainer(dict(tm.named_parameters()), "adamw", dict(kw))
    loss_fn = SoftmaxCrossEntropyLoss()
    tm.train()
    tl = []
    for _ in range(5):
        loss = loss_fn(tm(torch.from_numpy(ids)).reshape(-1, V),
                       torch.from_numpy(lab).reshape(-1)).mean()
        loss.backward()
        tr.step(1)
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    _assert_params_match(jm, tm)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _gpt(remat, dropout=0.1):
    return tgpt.GPTForCausalLM(
        tgpt.GPTConfig(**dict(SMALL, dropout=dropout, remat=remat)),
        device="cpu", seed=5)


def _bert(remat):
    cfg = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=64, max_position=16, dropout=0.1,
               remat=remat)
    return tbert.BertForPretraining(tbert.BertConfig(**cfg), device="cpu",
                                    seed=5)


def _loss_and_grads(model):
    ids, lab = (torch.from_numpy(a) for a in _stream())
    with tautograd.train_mode():
        if isinstance(model, tgpt.GPTForCausalLM):
            out = model(ids)
        else:
            out = model(ids, valid_length=torch.tensor([12, 7, 12, 9]))[0]
    loss = softmax_cross_entropy(out.reshape(-1, V), lab.reshape(-1)).mean()
    params = [p for p in model.parameters()]
    return loss.detach(), torch.autograd.grad(loss, params,
                                              allow_unused=True)


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
@pytest.mark.parametrize("build", [_gpt, _bert], ids=["gpt", "bert"])
def test_remat_matches_no_remat(build, policy):
    """JAX's ``test_remat_matches_no_remat``, with dropout 0.1 from a seed:
    the recompute draws the forward's masks and seeds, and each generator
    ends where the run without remat leaves it."""
    plain, remat = build(False), build(policy)
    l0, g0 = _loss_and_grads(plain)
    l1, g1 = _loss_and_grads(remat)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-5)
    for a, b in zip(g0, g1):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert torch.equal(plain.generator.get_state(),
                       remat.generator.get_state())


def test_remat_without_restored_generators_departs():
    """The control: a recompute that draws fresh masks gives other
    gradients, so the test above can see a generator left unrestored."""
    l0, g0 = _loss_and_grads(_gpt(False))
    orig = tnn._generator_contexts
    tnn._generator_contexts = lambda gens: (contextlib.nullcontext(),
                                            contextlib.nullcontext())
    try:
        _, g1 = _loss_and_grads(_gpt("full"))
    finally:
        tnn._generator_contexts = orig
    dev = max(float((a - b).abs().max()) for a, b in zip(g0, g1))
    assert dev > 1e-3


def test_remat_train_steps_match_and_warmup_keeps_the_generator():
    """Three `TrainStep` steps under ``remat="full"`` with dropout give the
    losses of no remat, and `warmup` leaves the dropout generator where it
    found it."""
    ids, lab = _stream()
    losses = []
    for remat in (False, "full"):
        m = _gpt(remat)
        step = TrainStep(m, AdamW(learning_rate=3e-3), _torch_loss,
                         num_model_args=1)
        before = m.generator.get_state()
        step.warmup(ids, lab)
        assert torch.equal(m.generator.get_state(), before)
        losses.append([float(step(ids, lab)) for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@pytest.mark.parametrize("value,want", [
    (False, (False, None)), (None, (False, None)), ("none", (False, None)),
    ("off", (False, None)), ("0", (False, None)), ("false", (False, None)),
    ("no", (False, None)), (True, (True, None)), ("full", (True, None)),
    ("1", (True, None)), ("true", (True, None)),
    ("nothing_saveable", (True, "nothing_saveable")),
    ("everything_saveable", (True, "everything_saveable")),
    ("dots_saveable", (True, "dots_saveable")),
    ("checkpoint_dots", (True, "checkpoint_dots")),
    ("dots_with_no_batch_dims_saveable",
     (True, "dots_with_no_batch_dims_saveable")),
    ("checkpoint_dots_with_no_batch_dims",
     (True, "checkpoint_dots_with_no_batch_dims"))])
def test_remat_knob_reads_as_jax_reads_it(monkeypatch, value, want):
    monkeypatch.delenv("MXTPU_REMAT_POLICY", raising=False)
    assert tnn.resolve_remat_policy(value) == want
    j_on, j_pol = npx.resolve_remat_policy(value)
    assert j_on == want[0]
    assert (j_pol is None) == (want[1] is None)


def test_remat_env_override_and_unknown_names(monkeypatch):
    monkeypatch.setenv("MXTPU_REMAT_POLICY", "dots_saveable")
    assert tnn.resolve_remat_policy(False) == (True, "dots_saveable")
    # an explicit policy argument is taken literally
    assert tnn.resolve_remat_policy("none", env_override=False) == \
        (False, None)
    monkeypatch.setenv("MXTPU_REMAT_POLICY", "dots_savable")
    with pytest.raises(MXNetError, match="dots_saveable"):
        tnn.resolve_remat_policy(False)
    # the override reaches the model knob, and a typo raises there too
    with pytest.raises(MXNetError, match="unknown remat policy"):
        _gpt(False)(torch.zeros(1, 4, dtype=torch.int64))
    monkeypatch.setenv("MXTPU_REMAT_POLICY", "full")
    l0, _ = _loss_and_grads(_gpt(False))
    monkeypatch.delenv("MXTPU_REMAT_POLICY")
    l1, _ = _loss_and_grads(_gpt(False))
    np.testing.assert_allclose(l0.numpy(), l1.numpy(), rtol=1e-6)
    with pytest.raises(MXNetError, match="unknown remat policy"):
        tnn.remat_call(lambda t: t, torch.ones(2), policy="save_only_these")


# ---------------------------------------------------------------------------
# generate(use_cache=False)
# ---------------------------------------------------------------------------

PROMPTS = [[3, 9, 1, 7, 2], [44, 2, 44, 2, 5, 6]]


def test_generate_without_cache_equals_cached_and_jax():
    """The full-context recompute, the dense-cache path and JAX's greedy
    stream (its cached scan, which JAX's own tests hold equal to its
    recompute) token for token."""
    jm, tm = _pair()
    for prompt in PROMPTS:
        p = np.array([prompt], np.int32)
        slow = tm.generate(torch.from_numpy(p), 8, use_cache=False)
        fast = tm.generate(torch.from_numpy(p), 8)
        want = jm.generate(mx.np.array(p), max_new_tokens=8).asnumpy()
        assert slow.dtype == torch.int32
        assert slow.tolist() == fast.tolist() == want.tolist()


def test_sampled_generate_without_cache_draws_from_the_generator():
    _, tm = _pair()
    p = torch.tensor([PROMPTS[0]])

    def sample(seed):
        g = torch.Generator().manual_seed(seed)
        return tm.generate(p, 6, greedy=False, use_cache=False, top_k=5,
                           temperature=1.3, generator=g)
    a, b = sample(3), sample(3)
    assert a.tolist() == b.tolist() and a.shape == (1, 11)
    assert a[0, :5].tolist() == PROMPTS[0]
    assert not tm.training and int(a.max()) < V
    # beam search is ported; with the sampling knobs it raises, as JAX's
    with pytest.raises(ValueError, match="deterministic beam"):
        tm.generate(p, 2, greedy=False, use_cache=False, num_beams=2)


# ---------------------------------------------------------------------------
# the repairs: f32 norms in a bf16 or f16 GPT, layer_norm_eps
# ---------------------------------------------------------------------------

def _check_16bit_carry_over(dtype):
    """A 16-bit JAX GPT carried over by `load_jax_params`: every leaf's
    dtype and value as JAX keeps it, f32 LayerNorm gains and biases."""
    jm, tm = _pair(dtype)
    params = _jax_params(jm)
    norms = 0
    for name, p in tm.named_parameters():
        want = params[name]
        assert str(p.dtype) == "torch." + str(want.dtype), name
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      want.astype(np.float32), err_msg=name)
        norms += name.endswith(("gamma", "beta"))
    assert norms == 2 * (2 * SMALL["num_layers"] + 1)
    assert tm.transformer.final_norm.gamma.dtype == torch.float32
    assert tm.transformer.word_embed.weight.dtype == getattr(torch, dtype)
    assert isinstance(tm.transformer.word_embed, tgnn.Embedding)
    # ids out of range clip to the table, as Gluon's nn.Embedding does
    ids = torch.tensor([[V + 5, -1, 3]])
    with torch.no_grad():
        np.testing.assert_array_equal(
            tm.transformer.word_embed(ids)[0, :2].float().numpy(),
            tm.transformer.word_embed.weight.data()[[V - 1, 0]].float()
            .numpy())


def test_bf16_gpt_carries_over_with_f32_layer_norms():
    _check_16bit_carry_over("bfloat16")


def test_f16_gpt_carries_over_with_f32_layer_norms():
    """`GPTConfig(dtype="float16")`: f16 weights (numpy's float16 arrays
    carried as they are) beside f32 LayerNorm parameters, as JAX keeps
    them; an unknown dtype still raises by name."""
    _check_16bit_carry_over("float16")
    with pytest.raises(MXNetError, match="unsupported model dtype"):
        tgpt.torch_dtype("float64")


def test_bf16_forward_promotes_as_jax_does(monkeypatch, interpret):
    """On the reference route a bf16 activation meeting an f32 LayerNorm
    gain comes out f32, in JAX and in the port; the logits agree within
    bf16 rounding."""
    monkeypatch.setenv("MXTPU_PALLAS", "reference")
    jm, tm = _pair("bfloat16")
    ids, _ = _stream()
    want = jm(mx.np.array(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    want = want.asnumpy()
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_f16_forward_promotes_as_jax_does(route):
    """An f16 GPT's logits take JAX's dtype on each route: f32 after the
    first LayerNorm's f32 gain on the reference route, x's f16 on the
    kernel route (the fused norm returns x's dtype); within 5e-3 of their
    scale (f16 keeps 11 bits; a dozen products deep)."""
    jm, tm = _pair("float16")
    ids, _ = _stream()
    want = jm(mx.np.array(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    dt = "float32" if route == "reference" else "float16"
    assert str(got.dtype) == "torch." + dt and str(want.dtype) == dt
    want = want.asnumpy().astype(np.float32)
    assert np.abs(got.float().numpy() - want).max() <= \
        5e-3 * np.abs(want).max()


def test_three_f16_train_steps_match_jax(route):
    """Three AdamW steps of the f16 GPT through `TrainStep` against JAX's
    `make_sharded_train_step` on each route: f32 optimizer state for the
    f16 weights on both sides (``_master_dtype``; the kernel route runs
    the chunk kernel over (f16 weights, f32 state) and the f32 LayerNorm
    group), losses within 1e-4 relative (measured 2.1e-5), every leaf in
    its dtype, weights within two learning rates: Adam's early steps are
    about lr each whatever the gradient's size, so a near-zero gradient
    that f16 rounds to the other sign on one side moves a weight up to
    2 lr away (measured 3.9e-3 at lr 3e-3, the QKV key bias).  epsilon
    1e-6 as the f32 test."""
    jm, tm = _pair("float16")
    kw = dict(learning_rate=3e-3, wd=0.1, epsilon=1e-6)
    mesh = make_mesh({"dp": 1}, jax.devices()[:1])
    jstep = make_sharded_train_step(jm, jopt.AdamW(**kw), _jax_loss, mesh,
                                    num_model_args=1)
    tstep = TrainStep(tm, AdamW(**kw), _torch_loss, num_model_args=1)
    assert {s.dtype for st in tstep.opt_state.values() for s in st} == \
        {torch.float32}
    ids, lab = _stream()
    jl = [float(jstep(mx.np.array(ids), mx.np.array(lab)))
          for _ in range(3)]
    tl = [float(tstep(ids, lab)) for _ in range(3)]
    jstep.sync_params_to_block()
    assert tstep._fused_opt_kernel == jstep._fused_opt_kernel == \
        (route == "kernel")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    jp = jm.collect_params()
    for name, p in tm.named_parameters():
        want = jp[name].data().asnumpy()
        assert str(p.dtype) == "torch." + str(want.dtype), name
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   want.astype(np.float32), rtol=0,
                                   atol=2 * kw["learning_rate"],
                                   err_msg=name)


@pytest.mark.parametrize("eps", [1e-3, 0.5])
def test_layer_norm_eps_reaches_every_norm(route, eps):
    jm, tm = _pair(layer_norm_eps=eps)
    norms = [m for m in tm.modules() if isinstance(m, tgnn.LayerNorm)]
    assert len(norms) == 2 * SMALL["num_layers"] + 1
    assert all(m._epsilon == eps for m in norms)
    ids, _ = _stream()
    want = jm(mx.np.array(ids)).asnumpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


BF16_SC = dict(max_slots=3, page_size=4, num_pages=12, prefill_chunk=4,
               max_len=16)


def test_bf16_decode_core_logits_match_jax_over_a_bf16_pool():
    """One prefill chunk through the decode core over a bf16 paged pool:
    f32 queries after the first LayerNorm meet the bf16 pool (K/V cast
    into it) on both sides."""
    jm, tm = _pair("bfloat16")
    cfg = jm.cfg
    D = cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, 5, 4, cfg.num_heads, D)
    tok = np.array([[3, 9, 1, 7, 2, 55, 12], [8, 8, 1, 0, 96, 4, 31]],
                   np.int32)
    C = tok.shape[1]
    pos = np.tile(np.arange(C, dtype=np.int32), (2, 1))
    tables = np.array([[1, 2], [3, 4]], np.int32)
    start = np.zeros(2, np.int32)
    n = np.full(2, C, np.int32)

    jpools = {"k": jnp.zeros(shape, jnp.bfloat16),
              "v": jnp.zeros(shape, jnp.bfloat16)}
    jkv_fn = jkv.make_paged_kv_fn(jpools, jnp.asarray(tables),
                                  jnp.asarray(start), jnp.asarray(n),
                                  jnp.asarray(n), 4, False)
    jP = jdecode.extract_decode_weights(jm)
    jh = jdecode.transformer_step(jP, cfg, jnp.asarray(tok),
                                  jnp.asarray(pos), jkv_fn)
    jlog = np.asarray(jdecode.lm_logits(jP, jh))

    pools = tkv.KVPools(cfg.num_layers, 5, 4, cfg.num_heads, D,
                        torch.bfloat16, torch.device("cpu"))
    tkv_fn = tkv.make_paged_kv_fn(pools, torch.from_numpy(tables),
                                  torch.from_numpy(start),
                                  torch.from_numpy(n), torch.from_numpy(n))
    tP = decode.extract_decode_weights(tm)
    with torch.inference_mode():
        th = decode.transformer_step(tP, tm.cfg, torch.from_numpy(tok),
                                     torch.from_numpy(pos), tkv_fn)
        tlog = decode.lm_logits(tP, th)
    assert tlog.dtype == torch.float32 and jlog.dtype == np.float32
    assert pools.k.dtype == torch.bfloat16
    assert np.abs(tlog.numpy() - jlog).max() <= 2e-2 * np.abs(jlog).max()


def test_bf16_generate_and_engine_streams_match_jax_engine():
    """bf16 serving computes in f32 after the first LayerNorm, as JAX's
    decode step does: the port's engine streams equal JAX's engine's, and
    the port's dense-cache `generate` (K/V cast into a bf16 cache, as the
    engine casts them into its bf16 pool) equals both.  JAX's own bf16
    dense-cache `generate` raises (``lax.dynamic_update_slice`` refuses
    f32 K/V into its bf16 cache), so its engine is the reference."""
    jm, tm = _pair("bfloat16")
    prompts = [[3, 9, 1, 7, 2], [5], [10, 20, 30, 40, 50, 60, 70]]
    jeng = JEngine(jm, JServeConfig(**BF16_SC))
    teng = InferenceEngine(tm, ServeConfig(**BF16_SC), device="cpu")
    assert teng.pools.k.dtype == torch.bfloat16

    def serve(engine):
        hs = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_idle()
        return [h.result(timeout=0) for h in hs]
    jout, tout = serve(jeng), serve(teng)
    assert tout == jout
    for prompt, got in zip(prompts, tout):
        gen = tm.generate(torch.tensor([prompt]), 6)
        assert gen[0].tolist() == got


def test_f16_generate_and_engine_streams_match_jax_engine():
    """f16 serving computes in f32 after the first LayerNorm, over an f16
    pool (K/V rounded into it as JAX's ``.astype`` rounds): the port's
    engine streams equal JAX's f16 engine's, and the port's dense-cache
    `generate` (K/V cast into an f16 cache) equals both.  JAX's own f16
    dense-cache `generate` raises, as its bf16 one does."""
    jm, tm = _pair("float16")
    prompts = [[3, 9, 1, 7, 2], [5], [10, 20, 30, 40, 50, 60, 70]]
    jeng = JEngine(jm, JServeConfig(**BF16_SC))
    teng = InferenceEngine(tm, ServeConfig(**BF16_SC), device="cpu")
    assert teng.pools.k.dtype == torch.float16

    def serve(engine):
        hs = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_idle()
        return [h.result(timeout=0) for h in hs]
    jout, tout = serve(jeng), serve(teng)
    assert tout == jout
    for prompt, got in zip(prompts, tout):
        gen = tm.generate(torch.tensor([prompt]), 6)
        assert gen[0].tolist() == got


def test_flops_per_token_matches_jax():
    for kw in ({}, {"window": 4}, {"num_kv_heads": 2}):
        cfg = dict(SMALL, **kw)
        assert tgpt.GPTForCausalLM.flops_per_token(
            tgpt.GPTConfig(**cfg), 12) == \
            jgpt.GPTForCausalLM.flops_per_token(jgpt.GPTConfig(**cfg), 12)


def test_bert_reads_the_remat_override(monkeypatch):
    """BERT reads the same knob, ``MXTPU_REMAT_POLICY`` included (JAX's
    `BertModel.forward`), with the same loss and gradients."""
    l0, g0 = _loss_and_grads(_bert(False))
    monkeypatch.setenv("MXTPU_REMAT_POLICY", "dots_saveable")
    l1, g1 = _loss_and_grads(_bert(False))
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-5)
    for a, b in zip(g0, g1):
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-7)
    assert jbert.BertConfig(remat="full").remat == \
        tbert.BertConfig(remat="full").remat


# ---------------------------------------------------------------------------
# the modern GPT: RoPE, grouped K/V and a sliding window (Mistral's scheme)
# ---------------------------------------------------------------------------

# hidden 64 over 4 heads of 16; a window of 4 keys inside the 12 positions
MODERN = dict(hidden_size=64, rope=True, rope_theta=10000.0, window=4)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_modern_gpt_logits_and_every_gradient_match(route, kv_heads):
    """GQA (2 kv heads) and MQA (1) with RoPE and a window of 4: the
    folded, banded flash path's logits and every gradient of the causal-LM
    loss against JAX's (its Pallas kernel, interpreted)."""
    jm, tm = _pair(num_kv_heads=kv_heads, **MODERN)
    ids, lab = _stream()
    want = jm(mx.np.array(ids)).asnumpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the window binds: the same weights unwindowed answer otherwise
    _, full = _pair(num_kv_heads=kv_heads, **dict(MODERN, window=None))
    with torch.no_grad():
        assert not np.allclose(full(torch.from_numpy(ids)).numpy(), want,
                               atol=1e-3)
    with autograd.record():
        logits = jm(mx.np.array(ids))
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            logits.reshape(-1, V), mx.np.array(lab).reshape(-1)).mean()
    jloss.backward()
    tloss = SoftmaxCrossEntropyLoss()(
        tm(torch.from_numpy(ids)).reshape(-1, V),
        torch.from_numpy(lab).reshape(-1)).mean()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.asnumpy()), **TOL)
    jp = jm.collect_params()
    assert tm.transformer.layers[0].attention.attn_qkv.weight.shape[0] == \
        64 + 2 * 16 * kv_heads                # K/V at kv_heads heads
    for name, p in tm.named_parameters():
        want = jp[name].grad().asnumpy()
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=name, **TOL)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_modern_gpt_three_adamw_train_steps_match_jax(route, kv_heads):
    jm, tm = _pair(num_kv_heads=kv_heads, **MODERN)
    kw = dict(learning_rate=3e-3, wd=0.1, epsilon=1e-6)
    mesh = make_mesh({"dp": 1}, jax.devices()[:1])
    jstep = make_sharded_train_step(jm, jopt.AdamW(**kw), _jax_loss, mesh,
                                    num_model_args=1)
    tstep = TrainStep(tm, AdamW(**kw), _torch_loss, num_model_args=1)
    ids, lab = _stream()
    jl = [float(jstep(mx.np.array(ids), mx.np.array(lab)))
          for _ in range(3)]
    tl = [float(tstep(ids, lab)) for _ in range(3)]
    jstep.sync_params_to_block()
    assert tstep._fused_opt_kernel == jstep._fused_opt_kernel == \
        (route == "kernel")
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    _assert_params_match(jm, tm)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_modern_gpt_generate_without_cache_equals_cached_and_jax(kv_heads):
    """The uncached path runs the folded, windowed flash forward over the
    whole context; the cached path the decode core's window; JAX's greedy
    stream the same, token for token (prompts past the window)."""
    jm, tm = _pair(num_kv_heads=kv_heads, **MODERN)
    for prompt in PROMPTS:
        p = np.array([prompt], np.int32)
        slow = tm.generate(torch.from_numpy(p), 8, use_cache=False)
        fast = tm.generate(torch.from_numpy(p), 8)
        want = jm.generate(mx.np.array(p), max_new_tokens=8).asnumpy()
        assert slow.tolist() == fast.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# Gemma 2B's attention (256-wide heads over one kv head, RoPE) at a small
# width: hidden 512 over 2 query heads of 256, one kv head
# ---------------------------------------------------------------------------

D256 = dict(hidden_size=512, num_heads=2, num_kv_heads=1, rope=True,
            rope_theta=10000.0)
D256_SC = dict(max_slots=3, page_size=4, num_pages=12, prefill_chunk=4,
               max_len=16)


def test_d256_gpt_logits_and_every_gradient_match(route):
    """The folded flash path at D = 256 (JAX's Pallas kernel, interpreted:
    256 is a multiple of 128): logits and every gradient of the causal-LM
    loss, with the parameters carried over by `load_jax_params` (the QKV
    projection at 512 + 2 x 256 rows)."""
    jm, tm = _pair(**D256)
    assert tm.transformer.layers[0].attention.attn_qkv.weight.shape[0] == \
        512 + 2 * 256
    ids, lab = _stream()
    want = jm(mx.np.array(ids)).asnumpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with autograd.record():
        logits = jm(mx.np.array(ids))
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            logits.reshape(-1, V), mx.np.array(lab).reshape(-1)).mean()
    jloss.backward()
    tloss = SoftmaxCrossEntropyLoss()(
        tm(torch.from_numpy(ids)).reshape(-1, V),
        torch.from_numpy(lab).reshape(-1)).mean()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.asnumpy()), **TOL)
    jp = jm.collect_params()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[name].grad().asnumpy(),
                                   err_msg=name, **TOL)


def test_d256_gpt_adamw_train_step_matches_jax(route):
    """epsilon 1e-4: at hidden 512 the smallest gradients of the QKV
    weight are near 1e-7 against a median of 3e-2, and Adam's step
    g / (sqrt(v) + eps) turns their round-off (summation order) into
    steps 2e-4 apart at epsilon 1e-6; the gradients themselves are held
    at 1e-4 above."""
    jm, tm = _pair(**D256)
    kw = dict(learning_rate=3e-3, wd=0.1, epsilon=1e-4)
    mesh = make_mesh({"dp": 1}, jax.devices()[:1])
    jstep = make_sharded_train_step(jm, jopt.AdamW(**kw), _jax_loss, mesh,
                                    num_model_args=1)
    tstep = TrainStep(tm, AdamW(**kw), _torch_loss, num_model_args=1)
    ids, lab = _stream()
    jl = float(jstep(mx.np.array(ids), mx.np.array(lab)))
    tl = float(tstep(ids, lab))
    jstep.sync_params_to_block()
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_match(jm, tm)


def test_d256_gpt_serving_and_uncached_generate_match_jax():
    """Greedy streams of the port's engine (K1's plain version at D = 256
    over one kv head) equal JAX's engine's; `generate` with and without
    the cache equals both."""
    jm, tm = _pair(**D256)
    prompts = [[3, 9, 1, 7, 2], [5], [10, 20, 30, 40, 50, 60, 70]]
    jeng = JEngine(jm, JServeConfig(**D256_SC))
    teng = InferenceEngine(tm, ServeConfig(**D256_SC), device="cpu")

    def serve(engine):
        hs = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_idle()
        return [h.result(timeout=0) for h in hs]
    jout, tout = serve(jeng), serve(teng)
    assert tout == jout
    for prompt, got in zip(prompts, tout):
        p = torch.tensor([prompt])
        assert tm.generate(p, 6, use_cache=False)[0].tolist() == got
        assert tm.generate(p, 6)[0].tolist() == got
