"""Port parity: BERT for pretraining (mxnet_tpu_torch.models.bert) against
the JAX package's ``BertForPretraining``.

A 2-layer, hidden-64, 4-head, vocab-128, sequence-16 BERT is initialised
in JAX, carried over by `load_jax_params`, and both models run the same
numpy batch with ``valid_length`` (padded rows) and ``masked_positions``
with dropout 0.  The JAX side runs its flash and cross-entropy kernels in
interpret mode (enabled per test with ``monkeypatch``).  Tolerance:
atol/rtol 1e-4 in f32 for logits and every parameter gradient of the MLM
loss (twelve products deep, summation order differs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import numpy_extension as npx
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.models import layers as jlayers

from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.models import layers as tlayers
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import softmax_cross_entropy

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position=32, dropout=0.0)
B, L, M = 4, 16, 5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _jax_params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _pair(dtype="float32", **kw):
    mx.random.seed(0)
    cfg = dict(SMALL, dtype=dtype, **kw)
    jm = jbert.BertForPretraining(jbert.BertConfig(**cfg))
    jm.initialize(mx.init.Normal(0.2))
    ids, vl, mp, types, _ = _batch()
    jm(mx.np.array(ids), valid_length=mx.np.array(vl),
       masked_positions=mx.np.array(mp))                 # deferred shapes
    tm = tbert.BertForPretraining(tbert.BertConfig(**cfg), device="cpu")
    load_jax_params(tm, _jax_params(jm), device="cpu")
    tm.eval()
    return jm, tm


def _batch():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 128, (B, L)).astype(np.int32)
    vl = np.array([16, 9, 13, 16], np.int32)
    mp = np.sort(rng.rand(B, L).argsort(1)[:, :M], 1).astype(np.int32)
    types = (np.arange(L)[None, :] >= rng.randint(4, 12, (B, 1))).astype(
        np.int32)
    lab = rng.randint(0, 128, (B, M)).astype(np.int32)
    return ids, vl, mp, types, lab


def test_logits_match(interpret):
    jm, tm = _pair()
    ids, vl, mp, types, _ = _batch()
    for kw in (dict(valid_length=vl, masked_positions=mp),
               dict(valid_length=vl, token_types=types), dict()):
        jmlm, jnsp = jm(mx.np.array(ids), **{k: mx.np.array(v)
                                             for k, v in kw.items()})
        tmlm, tnsp = tm(torch.from_numpy(ids),
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(tmlm.detach().numpy(), jmlm.asnumpy(),
                                   **TOL)
        np.testing.assert_allclose(tnsp.detach().numpy(), jnsp.asnumpy(),
                                   **TOL)


def test_every_gradient_of_the_mlm_loss_matches(interpret):
    _check_mlm_gradients(*_pair())


def test_windowed_bert_logits_and_gradients_match(interpret):
    """``BertConfig(window=2)``: the symmetric band [q - 2, q + 2] beside
    the padding of ``valid_length``, through the flash kernel's plain
    version, against JAX's windowed BERT (its Pallas kernel, interpreted)."""
    jm, tm = _pair(window=2)
    ids, vl, mp, types, _ = _batch()
    jmlm, jnsp = jm(mx.np.array(ids), valid_length=mx.np.array(vl),
                    token_types=mx.np.array(types))
    with torch.no_grad():
        tmlm, tnsp = tm(torch.from_numpy(ids),
                        valid_length=torch.from_numpy(vl),
                        token_types=torch.from_numpy(types))
    np.testing.assert_allclose(tmlm.numpy(), jmlm.asnumpy(), **TOL)
    np.testing.assert_allclose(tnsp.numpy(), jnsp.asnumpy(), **TOL)
    # the band changes the answer: full attention lands elsewhere
    _, full = _pair()
    with torch.no_grad():
        fmlm, _ = full(torch.from_numpy(ids),
                       valid_length=torch.from_numpy(vl),
                       token_types=torch.from_numpy(types))
    assert not np.allclose(fmlm.numpy(), tmlm.numpy(), atol=1e-3)
    _check_mlm_gradients(jm, tm)


def _check_mlm_gradients(jm, tm):
    ids, vl, mp, _, lab = _batch()
    with mx.autograd.record():
        jmlm, _ = jm(mx.np.array(ids), valid_length=mx.np.array(vl),
                     masked_positions=mx.np.array(mp))
        jloss = npx.softmax_cross_entropy(jmlm, mx.np.array(lab)).mean()
    jloss.backward()
    tmlm, _ = tm(torch.from_numpy(ids), valid_length=torch.from_numpy(vl),
                 masked_positions=torch.from_numpy(mp))
    tloss = softmax_cross_entropy(tmlm, torch.from_numpy(lab)).mean()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.asnumpy()), **TOL)
    jp = jm.collect_params()
    checked = 0
    for name, p in tm.named_parameters():
        want = jp[name].grad().asnumpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        checked += int(np.abs(want).max() > 0)
    assert checked > 30          # the loss reaches every encoder weight


def test_bf16_weights_carry_over_with_f32_layer_norms(interpret):
    jm, tm = _pair("bfloat16")
    params = _jax_params(jm)
    for name, p in tm.named_parameters():
        want = params[name]
        assert str(p.dtype) == "torch." + str(want.dtype), name
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      want.astype(np.float32), err_msg=name)
    assert tm.bert.layers[0].attn_norm.gamma.dtype == torch.float32
    assert tm.mlm_decoder.weight.dtype == torch.bfloat16
    ids, vl, mp, _, _ = _batch()
    jmlm, _ = jm(mx.np.array(ids), valid_length=mx.np.array(vl),
                 masked_positions=mx.np.array(mp))
    tmlm, _ = tm(torch.from_numpy(ids), valid_length=torch.from_numpy(vl),
                 masked_positions=torch.from_numpy(mp))
    # JAX promotes a bf16 activation meeting an f32 LayerNorm gain to f32;
    # so does the port
    assert tmlm.dtype == torch.float32 and jmlm.dtype == np.float32
    want = jmlm.asnumpy()
    err = np.abs(tmlm.detach().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max()


def test_gelu_is_the_erf_form():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = tnn.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, npx.gelu(mx.np.array(x)).asnumpy(),
                               rtol=1e-6, atol=1e-6)
    tanh = tnn.gelu(torch.from_numpy(x), "tanh").numpy()
    assert np.abs(got - tanh).max() > 1e-4          # the two forms differ
    import jax
    np.testing.assert_allclose(
        tanh, np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
        rtol=1e-6, atol=1e-6)


def test_feed_forward_and_layer_norm_match():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 16).astype(np.float32)
    mx.random.seed(0)
    jff = jlayers.FeedForward(16, 32)
    jff.initialize(mx.init.Normal(0.3))
    want = jff(mx.np.array(x)).asnumpy()
    tff = tlayers.FeedForward(16, 32)
    load_jax_params(tff, _jax_params(jff), device="cpu")
    np.testing.assert_allclose(tff(torch.from_numpy(x)).detach().numpy(),
                               want, **TOL)
    g, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    want = npx.layer_norm(mx.np.array(x), mx.np.array(g), mx.np.array(b),
                          eps=1e-12).asnumpy()
    got = tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b), eps=1e-12)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dropout_is_seeded_and_off_in_eval():
    cfg = tbert.BertConfig(**dict(SMALL, dropout=0.1))
    ids, vl, mp, _, _ = _batch()
    args = (torch.from_numpy(ids),)
    kw = dict(valid_length=torch.from_numpy(vl),
              masked_positions=torch.from_numpy(mp))
    a = tbert.BertForPretraining(cfg, device="cpu", seed=3)
    b = tbert.BertForPretraining(cfg, device="cpu", seed=3)
    with tautograd.train_mode():
        assert torch.equal(a(*args, **kw)[0], b(*args, **kw)[0])
        assert not torch.equal(a(*args, **kw)[0], a(*args, **kw)[0])
    assert torch.equal(a(*args, **kw)[0], a(*args, **kw)[0])
    assert a.generator is not None and all(
        m.generator is a.generator for m in a.modules()
        if isinstance(m, tgnn.Dropout))


def test_parameter_names_follow_the_jax_tree():
    jm = jbert.BertForPretraining(jbert.BertConfig(**SMALL))
    jm.initialize()
    ids, vl, mp, _, _ = _batch()
    jm(mx.np.array(ids), valid_length=mx.np.array(vl),
       masked_positions=mx.np.array(mp))
    tm = tbert.BertForPretraining(tbert.BertConfig(**SMALL), device="cpu")
    assert sorted(n for n, _ in tm.named_parameters()) == \
        sorted(jm.collect_params())


def test_flops_per_token_matches_jax():
    for cfg in (dict(), dict(hidden_size=1024, num_layers=24)):
        assert tbert.BertForPretraining.flops_per_token(
            tbert.BertConfig(**cfg), 128, 20 / 128) == \
            jbert.BertForPretraining.flops_per_token(
                jbert.BertConfig(**cfg), 128, 20 / 128)


def test_unported_options_raise():
    # a window runs now (the flash kernels take the band); a sequence past
    # max_position still raises
    ids = torch.zeros(1, 8, dtype=torch.int64)
    m = tbert.BertForPretraining(tbert.BertConfig(**dict(SMALL, window=4)),
                                 device="cpu")
    assert m(ids)[0].shape == (1, 8, SMALL["vocab_size"])
    m = tbert.BertForPretraining(tbert.BertConfig(**SMALL), device="cpu")
    with pytest.raises(MXNetError, match="max_position"):
        m(torch.zeros(1, 33, dtype=torch.int64))
