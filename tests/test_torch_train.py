"""Port parity: the training step (mxnet_tpu_torch.parallel.TrainStep)
against the JAX package's ``make_sharded_train_step`` on a one-device CPU
mesh, and the optimizer rules against JAX's.

The BERT pretraining step is the one ``bench.py`` measures, at a small
size (2 layers, hidden 64, sequence 16) with dropout 0, starting from the
same weights (`load_jax_params`); the JAX side runs its flash and
cross-entropy kernels in interpret mode.  Two routes: the reference route
(``MXTPU_PALLAS=reference``: LayerNorm and Adam on their reference paths)
and the kernel route (``MXTPU_PALLAS=kernel``: every LayerNorm through the
fused norm and the optimizer through the multi-tensor kernels, Adam and
LAMB — on the JAX side in the Pallas interpreter, on the port's the CUDA
kernels' plain versions).  Tolerance: atol/rtol 1e-4 on the losses and on
every parameter after the steps (f32, summation order); the rules alone at
1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.block import HybridBlock
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.ops.pallas.softmax_xent import softmax_cross_entropy as jxent
from mxnet_tpu.parallel import make_mesh, make_sharded_train_step

from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.ops import softmax_cross_entropy
from mxnet_tpu_torch.ops.fused_optimizer import apply_updates
from mxnet_tpu_torch.optimizer import Adam, AdamW, create
from mxnet_tpu_torch.parallel import TrainStep, make_train_step

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position=32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXTPU_PALLAS", "reference")


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXTPU_PALLAS", "kernel")


class JaxBench(HybridBlock):
    """``bench.py``'s positional adapter: (ids, valid_length,
    masked_positions)."""

    def __init__(self, cfg):
        super().__init__()
        self.model = jbert.BertForPretraining(cfg)

    def forward(self, ids, vl, mp):
        return self.model(ids, valid_length=vl, masked_positions=mp)


class TorchBench(torch.nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.model = tbert.BertForPretraining(cfg, **kw)

    def forward(self, ids, vl, mp):
        return self.model(ids, valid_length=vl, masked_positions=mp)


def _batch(B=4, L=16, M=5, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (B, L)).astype(np.int32)
    vl = rng.randint(int(0.5 * L), L + 1, (B,)).astype(np.int32)
    mp = np.sort(rng.rand(B, L).argsort(1)[:, :M], 1).astype(np.int32)
    lab = rng.randint(0, 128, (B, M)).astype(np.int32)
    return ids, vl, mp, lab


def _jax_loss(out, ids, vl, mp, lab):
    return jnp.mean(jxent(out[0], lab.astype(jnp.int32)))


def _torch_loss(out, ids, vl, mp, lab):
    return softmax_cross_entropy(out[0], lab).mean()


def _pair(dtype="float32"):
    mx.random.seed(0)
    cfg = dict(SMALL, dropout=0.0, dtype=dtype)
    jm = JaxBench(jbert.BertConfig(**cfg))
    jm.initialize(mx.init.Normal(0.2))
    ids, vl, mp, _ = _batch()
    jm(mx.np.array(ids), mx.np.array(vl), mx.np.array(mp))
    tm = TorchBench(tbert.BertConfig(**cfg), device="cpu")
    load_jax_params(tm, {k: p.data().asnumpy()
                         for k, p in jm.collect_params().items()},
                    device="cpu")
    return jm, tm


def _run_both(steps, grad_accum=1, lr=1e-3, wd=0.0, opt="Adam"):
    """`steps` steps of `opt` (Adam or LAMB) on each side.  epsilon 1e-6
    (LAMB's default): the key part of the QKV bias has an exactly zero
    gradient (softmax ignores a per-row shift), so both sides see round-off
    of ~1e-9 there, which Adam with epsilon 1e-8 would blow up into
    full-size steps of random sign."""
    jm, tm = _pair()
    mesh = make_mesh({"dp": 1}, jax.devices()[:1])
    kw = dict(learning_rate=lr, wd=wd, epsilon=1e-6)
    jstep = make_sharded_train_step(
        jm, getattr(jopt, opt)(**kw), _jax_loss, mesh, num_model_args=3,
        grad_accum=grad_accum)
    tstep = make_train_step(tm, create(opt, **kw), _torch_loss,
                            num_model_args=3, grad_accum=grad_accum)
    batch = _batch(B=4 * grad_accum)
    jl = [float(jstep(*(mx.np.array(a) for a in batch)))
          for _ in range(steps)]
    tl = [float(tstep(*batch)) for _ in range(steps)]
    jstep.sync_params_to_block()
    assert tstep._fused_opt_kernel == jstep._fused_opt_kernel
    return jm, tm, jl, tl


def _assert_params_match(jm, tm):
    jp = jm.collect_params()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name].data().asnumpy(), err_msg=name,
                                   **TOL)


def test_three_adam_steps_match_jax(interpret):
    jm, tm, jl, tl = _run_both(3, wd=0.01)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    _assert_params_match(jm, tm)


@pytest.mark.parametrize("opt", ["Adam", "LAMB"])
def test_three_kernel_route_steps_match_jax(kernel_route, opt):
    """Every LayerNorm through the fused norm's route and the optimizer
    through the chunk kernel (Adam) or LAMB's phases A and B, on both
    sides."""
    jm, tm, jl, tl = _run_both(3, wd=0.01, opt=opt)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    _assert_params_match(jm, tm)


@pytest.mark.parametrize("mode,want", [("kernel", True), ("reference", False),
                                       ("auto", False), ("off", False)])
def test_the_optimizer_route_is_resolved_once(monkeypatch, mode, want):
    """``auto`` on the CPU takes the reference route; a later change of
    ``MXTPU_PALLAS`` leaves a live step as it was built."""
    monkeypatch.setenv("MXTPU_PALLAS", mode)
    tm = TorchBench(tbert.BertConfig(**dict(SMALL, dropout=0.0)),
                    device="cpu")
    step = TrainStep(tm, Adam(learning_rate=1e-3), _torch_loss,
                     num_model_args=3)
    assert step._fused_opt_kernel is want
    monkeypatch.setenv("MXTPU_PALLAS", "reference" if want else "kernel")
    step(*_batch())
    assert step._fused_opt_kernel is want


def test_update_replaces_the_optimizer_route(monkeypatch):
    """``update=kernel_plain`` (how an oracle step is built, under
    ``reference``) launches nothing and gives the kernel route's weights
    and state bit for bit, here for bf16 LAMB, whose trust ratio the
    kernels keep in f32."""
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.optimizer import LAMB
    rng = np.random.RandomState(3)
    w0, b0, x, y = (rng.randn(*s).astype(np.float32)
                    for s in ((6, 12), (6,), (16, 12), (16, 6)))
    x, y = (torch.from_numpy(a).bfloat16() for a in (x, y))

    def loss_fn(out, xx, yy):
        return ((out.float() - yy.float()) ** 2).mean()

    def run(mode, update):
        monkeypatch.setenv("MXTPU_PALLAS", mode)
        lin = torch.nn.Linear(12, 6, dtype=torch.bfloat16)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w0))
            lin.bias.copy_(torch.from_numpy(b0))
        step = TrainStep(lin, LAMB(learning_rate=0.05), loss_fn,
                         num_model_args=1, update=update)
        for _ in range(3):
            step(x, y)
        return step
    kern = run("kernel", None)
    oracle = run("reference", kernel_plain)
    assert kern._fused_opt_kernel and not oracle._fused_opt_kernel
    for n in kern.diff_names:
        assert torch.equal(kern.params[n], oracle.params[n]), n
        assert all(torch.equal(a, b) for a, b in zip(kern.opt_state[n],
                                                     oracle.opt_state[n])), n


def test_grad_accum_matches_jax(interpret):
    jm, tm, jl, tl = _run_both(2, grad_accum=2)
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_match(jm, tm)


def _rule_inputs(seed, shape=(7, 5)):
    rng = np.random.RandomState(seed)
    w, g = rng.randn(*shape), 3.0 * rng.randn(*shape)
    m, v = 0.1 * rng.randn(*shape), rng.rand(*shape)
    return [a.astype(np.float32) for a in (w, g, m, v)]


@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("clip,wd,t", [(None, 0.0, 1.0), (1.5, 0.01, 7.0)])
def test_rules_match_jax(name, clip, wd, t):
    w, g, m, v = _rule_inputs(0)
    kw = dict(learning_rate=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
              rescale_grad=0.5)
    hp = dict(lr=0.01, wd=wd, rescale_grad=0.5, clip_gradient=clip, t=t)
    jo = jopt.create(name, **kw)
    to = create(name, **kw)

    def as_j(x):
        return None if x is None else jnp.asarray(x, jnp.float32)

    def as_t(x):
        return None if x is None else torch.tensor(x, dtype=torch.float32)
    jw, (jm_, jv) = jo._rule(jnp.asarray(w), jnp.asarray(g),
                             (jnp.asarray(m), jnp.asarray(v)),
                             {k: as_j(x) for k, x in hp.items()})
    tw, (tm_, tv) = to._rule(torch.from_numpy(w), torch.from_numpy(g),
                             (torch.from_numpy(m), torch.from_numpy(v)),
                             {k: as_t(x) for k, x in hp.items()})
    for a, b in ((tw, jw), (tm_, jm_), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_bf16_weights_keep_f32_moments():
    cfg = tbert.BertConfig(**dict(SMALL, dropout=0.0, dtype="bfloat16"))
    tm = TorchBench(cfg, device="cpu")
    step = TrainStep(tm, Adam(learning_rate=1e-3), _torch_loss,
                     num_model_args=3)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step(*_batch())
    for n, p in tm.named_parameters():
        assert p.dtype == before[n].dtype
        m, v = step.opt_state[n]
        assert m.dtype == v.dtype == torch.float32, n
    w = tm.model.bert.layers[0].attention.attn_qkv.weight
    assert w.dtype == torch.bfloat16
    assert not torch.equal(w, before[
        "model.bert.layers.0.attention.attn_qkv.weight"])


def test_apply_updates_skip_is_the_identity():
    w, g, m, v = (torch.from_numpy(a) for a in _rule_inputs(1))
    hp = {k: torch.tensor(x) for k, x in dict(lr=0.1, wd=0.0,
                                               rescale_grad=1.0,
                                               t=1.0).items()}
    hp["clip_gradient"] = None
    for skip, same in ((torch.tensor(True), True),
                       (torch.tensor(False), False)):
        nw, ns = apply_updates(Adam(), {"w": w}, {"w": g}, {"w": (m, v)},
                               hp, skip=skip)
        assert torch.equal(nw["w"], w) == same
        assert torch.equal(ns["w"][0], m) == same


def test_dispatch_loss_equals_call_and_warmup_changes_nothing():
    cfg = tbert.BertConfig(**dict(SMALL, dropout=0.1))
    batch = _batch()
    a, b = TorchBench(cfg, device="cpu"), TorchBench(cfg, device="cpu")
    sa = TrainStep(a, Adam(learning_rate=1e-3), _torch_loss,
                   num_model_args=3)
    sb = TrainStep(b, Adam(learning_rate=1e-3), _torch_loss,
                   num_model_args=3)
    before = {n: p.detach().clone() for n, p in a.named_parameters()}
    gen_state = a.model.generator.get_state()
    assert sa.warmup(*batch) >= 0.0
    assert all(torch.equal(p, before[n]) for n, p in a.named_parameters())
    assert torch.equal(a.model.generator.get_state(), gen_state)
    assert sa._t == 0
    for _ in range(2):
        h = sa.dispatch(*batch)
        loss = sb(*batch)
        assert torch.is_tensor(h.loss) and h.loss.dtype == torch.float32
        assert h.is_ready() and h.result() == float(loss)
    assert h.step == 2 and sa.steps_in_flight() == 0


def test_grad_accum_must_divide_the_batch():
    tm = TorchBench(tbert.BertConfig(**dict(SMALL, dropout=0.0)),
                    device="cpu")
    step = TrainStep(tm, AdamW(), _torch_loss, num_model_args=3,
                     grad_accum=3)
    with pytest.raises(MXNetError, match="must divide"):
        step(*_batch())
    with pytest.raises(MXNetError, match="grad_accum"):
        TrainStep(tm, AdamW(), _torch_loss, grad_accum=0)
