"""Port parity: the Transformer encoder-decoder (mxnet_tpu_torch.models.
transformer) against the JAX package's ``TransformerNMT`` on the CPU.

A 2 + 2-layer, hidden-64, 4-head, FFN-128 model with source vocabulary 50
and target vocabulary 61 is initialised in JAX (``Normal(0.2)``), carried
over by `load_jax_params`, and both sides take the same numpy batch: (4,
10) sources padded by ``src_valid_length`` and (4, 7) targets, so
cross-attention has Lq != Lk.  The JAX side runs its flash, cross-entropy,
norm and optimizer kernels in the Pallas interpreter
(``MXTPU_PALLAS_INTERPRET=1``, per test) on both routes
(``MXTPU_PALLAS=reference`` and ``kernel``); the port runs the kernels'
plain versions.

Tolerances (f32): logits atol/rtol 1e-5; every gradient of the loss,
losses and weights after three `TrainStep` steps 1e-4 (a dozen products
deep, summation order differs); greedy translations token for token; the
masking and causality checks of ``tests/unittest/test_models.py:83-104``
at 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import autograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.block import HybridBlock
from mxnet_tpu.models import transformer as jnmt
from mxnet_tpu.ops.pallas.softmax_xent import softmax_cross_entropy as jxent
from mxnet_tpu.parallel import make_mesh, make_sharded_train_step

from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import TransformerNMT, transformer_base
from mxnet_tpu_torch.models import transformer as tnmt
from mxnet_tpu_torch.ops import softmax_cross_entropy
from mxnet_tpu_torch.optimizer import Adam
from mxnet_tpu_torch.parallel import TrainStep

torch.set_num_threads(1)

SV, TV = 50, 61
SMALL = dict(src_vocab_size=SV, tgt_vocab_size=TV, hidden_size=64,
             num_layers=2, num_heads=4, intermediate_size=128,
             max_position=32)
TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(params=["reference", "kernel"])
def route(request, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXTPU_PALLAS", request.param)
    return request.param


def _jax_params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _batch(seed=1, B=4, Ls=10, Lt=7):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, SV, (B, Ls)).astype(np.int32)
    vl = np.array([Ls, 6, 3, Ls - 1][:B], np.int32)
    tgt = rng.randint(0, TV, (B, Lt + 1)).astype(np.int32)
    return src, vl, tgt[:, :-1].copy(), tgt[:, 1:].copy()


def _pair(**kw):
    cfg = dict(SMALL, dropout=0.0, **kw)
    mx.random.seed(0)
    jm = jnmt.TransformerNMT(jnmt.TransformerConfig(**cfg))
    jm.initialize(mx.init.Normal(0.2))
    src, vl, tin, _ = _batch()
    jm(mx.np.array(src), mx.np.array(tin), mx.np.array(vl))
    tm = TransformerNMT(tnmt.TransformerConfig(**cfg), device="cpu")
    load_jax_params(tm, _jax_params(jm), device="cpu")
    tm.eval()
    return jm, tm


def test_base_config_is_the_papers_and_names_match_jax():
    c = transformer_base()
    assert (c.hidden_size, c.num_layers, c.num_heads, c.intermediate_size,
            c.src_vocab_size, c.tgt_vocab_size, c.max_position) == \
        (512, 6, 8, 2048, 32000, 32000, 1024)
    jm, tm = _pair()
    assert sorted(n for n, _ in tm.named_parameters()) == \
        sorted(_jax_params(jm))
    assert tm.encoder.layers[0].attn_norm.gamma.dtype == torch.float32


@pytest.mark.parametrize("with_vl", [False, True])
def test_logits_match(route, with_vl):
    jm, tm = _pair()
    src, vl, tin, _ = _batch()
    jvl = mx.np.array(vl) if with_vl else None
    want = jm(mx.np.array(src), mx.np.array(tin), jvl).asnumpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(tin),
                 torch.from_numpy(vl) if with_vl else None)
    assert got.shape == (4, 7, TV)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_every_gradient_matches(route):
    jm, tm = _pair()
    src, vl, tin, lab = _batch()
    with autograd.record():
        logits = jm(mx.np.array(src), mx.np.array(tin), mx.np.array(vl))
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            logits.reshape(-1, TV), mx.np.array(lab).reshape(-1)).mean()
    jloss.backward()
    logits = tm(torch.from_numpy(src), torch.from_numpy(tin),
                torch.from_numpy(vl))
    tloss = SoftmaxCrossEntropyLoss()(logits.reshape(-1, TV),
                                      torch.from_numpy(lab).reshape(-1))
    tloss.mean().backward()
    np.testing.assert_allclose(tloss.mean().item(), float(jloss.asnumpy()),
                               **TOL)
    jp = jm.collect_params()
    checked = 0
    for name, p in tm.named_parameters():
        want = jp[name].grad().asnumpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        checked += int(np.abs(want).max() > 0)
    assert checked == len(list(tm.parameters()))


@pytest.mark.parametrize("with_vl", [False, True])
def test_greedy_translate_equals_jax(with_vl):
    jm, tm = _pair()
    src, vl, _, _ = _batch(seed=3)
    jvl = mx.np.array(vl) if with_vl else None
    want = jm.greedy_translate(mx.np.array(src), max_len=12,
                               src_valid_length=jvl).asnumpy()
    got = tm.greedy_translate(torch.from_numpy(src), max_len=12,
                              src_valid_length=(torch.from_numpy(vl)
                                                if with_vl else None))
    assert got.dtype == torch.int32 and not tm.training
    assert got.tolist() == want.tolist()
    # eos that one row emits: that row freezes on it, the call can stop
    eos = int(got[0, 3])
    want = jm.greedy_translate(mx.np.array(src), eos_id=eos, max_len=12,
                               src_valid_length=jvl).asnumpy()
    got = tm.greedy_translate(torch.from_numpy(src), eos_id=eos, max_len=12,
                              src_valid_length=(torch.from_numpy(vl)
                                                if with_vl else None))
    assert got.tolist() == want.tolist()


class _JaxAdapter(HybridBlock):
    """(src, tgt_in, valid_length) positionally, as `TrainStep` feeds."""

    def __init__(self, cfg):
        super().__init__()
        self.model = jnmt.TransformerNMT(cfg)

    def forward(self, src, tgt, vl):
        return self.model(src, tgt, vl)


class _TorchAdapter(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.model = TransformerNMT(cfg, device="cpu")

    def forward(self, src, tgt, vl):
        return self.model(src, tgt, vl)


def _jax_loss(out, src, tgt, vl, lab):
    return jnp.mean(jxent(out.reshape(-1, TV),
                          lab.reshape(-1).astype(jnp.int32)))


def _torch_loss(out, src, tgt, vl, lab):
    return softmax_cross_entropy(out.reshape(-1, TV),
                                 lab.reshape(-1)).mean()


def test_three_adam_train_steps_match_jax(route):
    """`TrainStep` against ``make_sharded_train_step`` on a {"dp": 1} mesh:
    losses and every weight after three Adam steps.  epsilon 1e-6: the key
    part of each QKV bias has an exactly zero gradient, whose round-off
    Adam with epsilon 1e-8 would blow up into full steps."""
    cfg = dict(SMALL, dropout=0.0)
    mx.random.seed(0)
    jm = _JaxAdapter(jnmt.TransformerConfig(**cfg))
    jm.initialize(mx.init.Normal(0.2))
    src, vl, tin, lab = _batch()
    jm(mx.np.array(src), mx.np.array(tin), mx.np.array(vl))
    tm = _TorchAdapter(tnmt.TransformerConfig(**cfg))
    load_jax_params(tm, _jax_params(jm), device="cpu")
    kw = dict(learning_rate=1e-3, epsilon=1e-6)
    mesh = make_mesh({"dp": 1}, jax.devices()[:1])
    jstep = make_sharded_train_step(jm, jopt.Adam(**kw), _jax_loss, mesh,
                                    num_model_args=3)
    tstep = TrainStep(tm, Adam(**kw), _torch_loss, num_model_args=3)
    batch = (src, tin, vl, lab)
    jl = [float(jstep(*(mx.np.array(a) for a in batch))) for _ in range(3)]
    tl = [float(tstep(*batch)) for _ in range(3)]
    jstep.sync_params_to_block()
    assert tstep._fused_opt_kernel == jstep._fused_opt_kernel == \
        (route == "kernel")
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    jp = jm.collect_params()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name].data().asnumpy(), err_msg=name,
                                   **TOL)


def test_source_padding_and_decoder_causality():
    """Source tokens past ``src_valid_length`` do not reach the output;
    a later target token does not reach earlier positions (JAX's
    ``test_nmt_forward_masks_and_causality``)."""
    _, tm = _pair()
    src, vl, tin, _ = _batch(seed=2)
    with torch.no_grad():
        def run(s, t):
            return tm(torch.from_numpy(s), torch.from_numpy(t),
                      torch.from_numpy(vl)).numpy()
        out = run(src, tin)
        src2 = src.copy()
        src2[1, 6:] = (src2[1, 6:] + 3) % SV          # beyond vl = 6
        np.testing.assert_allclose(run(src2, tin)[1], out[1], **LOGIT_TOL)
        tin2 = tin.copy()
        tin2[:, 5] = (tin2[:, 5] + 1) % TV
        out3 = run(src, tin2)
    np.testing.assert_allclose(out3[:, :5], out[:, :5], **LOGIT_TOL)
    assert not np.allclose(out3[:, 5:], out[:, 5:])


def test_max_position_guard_and_dropout_generator():
    cfg = tnmt.TransformerConfig(**dict(SMALL, max_position=8,
                                        dropout=0.3))
    tm = TransformerNMT(cfg, device="cpu", seed=4)
    src = torch.zeros((1, 9), dtype=torch.int32)
    with pytest.raises(MXNetError, match="max_position"):
        tm(src, src[:, :4])
    gens = {id(m.generator) for m in tm.modules()
            if isinstance(m, tgnn.Dropout)}
    assert gens == {id(tm.generator)}
    # a seed gives the same weights; dropout draws from the generator
    again = TransformerNMT(cfg, device="cpu", seed=4)
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(),
                                                 again.parameters()))
    s = torch.randint(0, SV, (2, 6), generator=torch.Generator()
                      .manual_seed(0)).to(torch.int32)
    t = s[:, :5] % TV
    with tautograd.train_mode():
        a = tm(s, t)
        b = again(s, t)
    assert torch.equal(a, b)
