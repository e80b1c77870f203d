"""Port parity: mixed precision (mxnet_tpu_torch.amp), the optimizers'
multi-precision route and the gluon `Trainer` under AMP's loss scaler,
against the JAX package (``mxnet_tpu.amp``).

- The five op lists and the accessors are JAX's.
- `LossScaler` gives JAX's scale sequence on the same overflow patterns
  (tolerance skips, growth windows, the 1.0 floor, `backoff`).
- The cast hook: on a tiny BERT (2 layers, hidden 64) under fp16 and bf16
  AMP, the TARGET / FP32 / WIDEST op calls the port's hook sees, by name
  and by dtypes in and out, equal those JAX's hook sees; the ones JAX
  sees and the port does not (``add``, ``mean``: raw torch in the port)
  get the dtype JAX's cast gives from torch's own type promotion.
- The same BERT's loss and every gradient under fp16 AMP (f32 weights)
  and with f16 weights (`convert_hybrid_block`), against JAX with its
  flash and cross-entropy kernels in interpret mode.  Tolerance: the
  loss within 1e-3 (relative), each gradient within 2e-2 of its scale:
  both sides round every product's output and the attention's P and dS
  to f16 (steps of 2**-11), at points that differ by the libraries'
  summation orders, through two layers and back (the worst gradient
  seen, 5e-3).
- JAX's fp16 `Trainer` overflow drill (`tests/unittest/test_amp.py`),
  step by step: equal weights and scales.
- `update_multi_precision` for SGD with momentum, Adam and LAMB on bf16
  and f16 weights: the f32 master within 1e-6 of JAX's and the weight
  within one 16-bit step, each of five steps; the `Trainer`'s
  multi-precision route against JAX's; a `save_states` / `load_states`
  round trip, and a JAX multi-precision `Trainer` continued in the port
  through `load_jax_optimizer_states`.

Each test calls ``torch.set_num_threads(1)`` (module level) and turns AMP
off in both packages when it ends.
"""
import collections
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import amp as jamp, autograd, gluon as jgluon, npx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.amp import lists as jlists
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.models import bert as jbert

from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import load_jax_optimizer_states, load_jax_params
from mxnet_tpu_torch.amp import lists as tlists
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import nn as tF
from mxnet_tpu_torch.optimizer import create as tcreate

torch.set_num_threads(1)

_jnd = importlib.import_module("mxnet_tpu.ndarray.ndarray")

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position=32, dropout=0.0)
# the names the port's entry points call the hook under (`ops.nn`,
# `ops.attention`)
PORT_HOOKED = {"fully_connected", "layer_norm", "layer_norm_residual",
               "rms_norm", "rms_norm_residual", "gelu", "dropout",
               "embedding", "pick", "softmax_cross_entropy",
               "multi_head_attention"}
LISTED = set(jlists.TARGET_DTYPE_OPS) | set(jlists.FP32_OPS) | \
    set(jlists.WIDEST_TYPE_CASTS)


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    jamp.disable()
    tamp.disable()


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXTPU_PALLAS", "kernel")


def _np(t):
    return t.detach().float().clone().numpy()


# -- lists and accessors ------------------------------------------------------

@pytest.mark.parametrize("name", ["TARGET_DTYPE_OPS", "FP32_OPS",
                                  "WIDEST_TYPE_CASTS", "CONDITIONAL_FP32_OPS",
                                  "FP16_FP32_OPS", "FP16_FUNCS", "FP32_FUNCS",
                                  "FP16_FP32_FUNCS"])
def test_lists_equal_jax(name):
    assert getattr(tlists, name) == getattr(jlists, name)


@pytest.mark.parametrize("name", ["list_lp16_ops", "list_fp32_ops",
                                  "list_lp16_fp32_ops",
                                  "list_conditional_fp32_ops",
                                  "list_widest_type_cast",
                                  "list_lp16_use_fp32_params"])
def test_list_accessors_equal_jax(name):
    assert getattr(tamp, name)("float16") == getattr(jamp, name)("float16")


def test_loss_output_functions_are_the_ports_losses():
    # every loss of gluon.loss, since the port has them all: JAX's list
    assert tamp.list_loss_output_functions() == \
        jamp.list_loss_output_functions()
    assert "CTCLoss" in tamp.list_loss_output_functions()


def test_init_disable_and_the_hook_off():
    assert tamp.mixed_precision_dtype() is None
    x = torch.ones(2, 3)
    # off: the inputs themselves, untouched
    got = tamp.cast_inputs("fully_connected", x, None)
    assert got[0] is x and got[1] is None
    tamp.init("bfloat16")
    assert tamp.mixed_precision_dtype() == torch.bfloat16
    assert tamp._state["scaler"] is None
    assert tamp.cast_inputs("fully_connected", x)[0].dtype == torch.bfloat16
    tamp.init("float16")
    assert tamp.mixed_precision_dtype() == torch.float16
    assert isinstance(tamp._state["scaler"], tamp.LossScaler)
    tamp.disable()
    assert tamp.mixed_precision_dtype() is None
    assert tamp.cast_inputs("fully_connected", x)[0] is x


def test_cast_policy_precedence_matches_jax():
    """User target ops beat the fp32 lists, the fp32 lists beat the
    target list, widest casts only with two floats, conditional entries
    by attribute -- the same casts as JAX's `_cast_args_for_op` on the
    same (name, dtypes, attrs)."""
    kw = dict(target_precision_ops=["exp"], fp32_ops=["dot"],
              conditional_fp32_ops=[("relu", "mode", ["bad"])])
    jamp.init("float16", **kw)
    tamp.init("float16", **kw)
    jf = _jnd._amp_cast_hook[0]
    cases = [("exp", ["float32"], {}), ("log", ["float16"], {}),
             ("dot", ["float16", "float16"], {}),
             ("matmul", ["float32", "bfloat16"], {}),
             ("add", ["float16", "bfloat16"], {}),
             ("add", ["float16", "int32"], {}),
             ("relu", ["float16"], {"mode": "bad"}),
             ("relu", ["float16"], {"mode": "ok"}), ("gelu", ["float32"], {})]
    for name, dts, attrs in cases:
        jv = [jnp.ones(2, d) for d in dts]
        tv = [torch.ones(2, dtype=getattr(torch, d)) for d in dts]
        want = [str(v.dtype) for v in jf(name, jv, attrs)]
        got = [str(v.dtype).replace("torch.", "")
               for v in tamp._cast_args_for_op(name, tv, attrs)]
        assert got == want, name


def test_convert_symbol_and_model_name_a16():
    for fn, args in ((tamp.convert_symbol, (None,)),
                     (tamp.convert_model, (None, {}, {}))):
        with pytest.raises(MXNetError, match="A16"):
            fn(*args)


def test_convert_hybrid_block_casts_every_float_parameter():
    tm = tbert.BertForPretraining(tbert.BertConfig(**SMALL), device="cpu")
    before = dict(tm.named_parameters())
    assert tamp.convert_hybrid_block(tm, "float16") is tm
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float16 and p is before[n], n


# -- the loss scaler ------------------------------------------------------------

SCALER_CASES = {
    "default": (dict(), 0),
    "window3": (dict(init_scale=1024.0, scale_window=3), 1),
    "tolerant": (dict(init_scale=2.0 ** 10, scale_window=5, tolerance=0.3),
                 2),
    "floor": (dict(init_scale=4.0, scale_window=50), 3),
    "factor4": (dict(init_scale=2.0 ** 12, scale_factor=4.0, scale_window=4,
                     tolerance=0.0), 4)}


@pytest.mark.parametrize("case", sorted(SCALER_CASES))
def test_loss_scaler_gives_jax_scale_sequence(case):
    """200 updates on a seeded overflow pattern (bursts and lone
    overflows), a `backoff` every 37th step before that step's update:
    the scale after every update equals JAX's."""
    kw, seed = SCALER_CASES[case]
    rng = np.random.RandomState(seed)
    pattern = (rng.rand(200) < 0.15) | (np.arange(200) < 6)
    js, ts = jamp.LossScaler(**kw), tamp.LossScaler(**kw)
    for i, ov in enumerate(pattern):
        if i % 37 == 36:
            assert ts.backoff() == js.backoff()
        js.update_scale(bool(ov))
        ts.update_scale(bool(ov))
        assert ts.loss_scale == js.loss_scale, i
    assert ts.loss_scale >= 1.0


def test_has_overflow_sees_inf_and_nan_in_any_gradient():
    ps = [torch.nn.Parameter(torch.zeros(3, dtype=dt))
          for dt in (torch.float32, torch.float16, torch.bfloat16)]
    s = tamp.LossScaler()
    assert not s.has_overflow(ps)                 # no gradients at all
    for p in ps:
        p.grad = torch.full_like(p, 6e4)
    assert not s.has_overflow(ps)                 # large, finite
    for bad in (float("inf"), float("-inf"), float("nan")):
        for p in ps:
            p.grad[1] = bad
            assert s.has_overflow(ps), (p.dtype, bad)
            p.grad[1] = 0.0


# -- the hook on BERT -----------------------------------------------------------

def _bert_pair(weights="float32"):
    mx.random.seed(0)
    jm = jbert.BertForPretraining(jbert.BertConfig(**SMALL))
    jm.initialize(mx.init.Normal(0.2))
    rng = np.random.RandomState(1)
    B, L, M = 4, 16, 5
    batch = (rng.randint(0, 128, (B, L)).astype(np.int32),
             rng.randint(8, L + 1, (B,)).astype(np.int32),
             np.sort(rng.rand(B, L).argsort(1)[:, :M], 1).astype(np.int32),
             rng.randint(0, 128, (B, M)).astype(np.int32))
    ids, vl, mp, _ = (mx.np.array(a, dtype="int32") for a in batch)
    jm(ids, None, vl, mp)
    tm = tbert.BertForPretraining(tbert.BertConfig(**SMALL), device="cpu")
    load_jax_params(tm, {k: p.data().asnumpy()
                         for k, p in jm.collect_params().items()},
                    device="cpu")
    if weights == "float16":
        jm.cast("float16")
        tamp.convert_hybrid_block(tm, "float16")
    return jm, tm, batch


def _jax_step(jm, batch):
    ids, vl, mp, lab = (mx.np.array(a, dtype="int32") for a in batch)
    with autograd.record():
        mlm, _ = jm(ids, None, vl, mp)
        loss = npx.softmax_cross_entropy(mlm, lab).mean()
    loss.backward()
    return mlm, loss


def _port_step(tm, batch):
    ids, vl, mp, lab = (torch.from_numpy(a) for a in batch)
    mlm, _ = tm(ids, None, vl, mp)
    loss = tF.softmax_cross_entropy(mlm, lab).mean()
    loss.backward()
    return mlm, loss


def _dt(v):
    return str(v.dtype).replace("torch.", "")


@pytest.mark.parametrize("target", ["float16", "bfloat16"])
def test_hook_sees_jax_op_names_and_dtypes_on_bert(kernel_route, target,
                                                   monkeypatch):
    jm, tm, batch = _bert_pair()
    jamp.init(target)
    tamp.init(target)
    jrec, trec = [], []
    jhook = _jnd._amp_cast_hook[0]

    def jwrap(name, vals, kw):
        out = jhook(name, vals, kw)
        jrec.append((name, tuple(_dt(v) for v in vals if hasattr(v, "dtype")),
                     tuple(_dt(v) for v in out if hasattr(v, "dtype"))))
        return out

    _jnd._amp_cast_hook[0] = jwrap
    tpolicy = tamp._cast_args_for_op

    def twrap(name, vals, kw):
        out = tpolicy(name, vals, kw)
        trec.append((name, tuple(_dt(v) for v in vals if torch.is_tensor(v)),
                     tuple(_dt(v) for v in out if torch.is_tensor(v))))
        return out

    monkeypatch.setattr(tamp, "_cast_args_for_op", twrap)
    _jax_step(jm, batch)
    _port_step(tm, batch)
    want = collections.Counter(r for r in jrec
                               if r[0] in LISTED and r[0] in PORT_HOOKED)
    got = collections.Counter(r for r in trec if r[0] in LISTED)
    assert got == want
    assert {r[0] for r in want} == {"fully_connected", "layer_norm",
                                    "multi_head_attention"}
    assert sum(want.values()) == 12 + 6 + 2
    # listed ops the port leaves to torch: promotion gives JAX's cast
    rest = [r for r in jrec if r[0] in LISTED and r[0] not in PORT_HOOKED]
    assert {r[0] for r in rest} == {"add", "mean"}
    for name, din, dout in rest:
        promoted = din[0]
        for d in din[1:]:
            promoted = str(torch.promote_types(
                getattr(torch, promoted), getattr(torch, d)))[6:]
        assert all(d == promoted for d in dout), (name, din, dout)


@pytest.mark.parametrize("weights", ["float32", "float16"])
def test_bert_loss_and_grads_match_jax_under_fp16_amp(kernel_route,
                                                      weights):
    jm, tm, batch = _bert_pair(weights)
    jamp.init("float16")
    tamp.init("float16")
    jmlm, jl = _jax_step(jm, batch)
    tmlm, tl = _port_step(tm, batch)
    assert jmlm.dtype == jnp.float16 and tmlm.dtype == torch.float16
    assert tl.dtype == torch.float32
    jl = float(jl.asnumpy())
    assert abs(float(tl) - jl) <= 1e-3 * abs(jl)
    jp = jm.collect_params()
    for n, p in tm.named_parameters():
        assert str(p.dtype) == f"torch.{weights}", n
        g = jp[n].grad().asnumpy().astype(np.float32)
        t = np.zeros_like(g) if p.grad is None else _np(p.grad)
        if p.grad is not None:
            assert p.grad.dtype == p.dtype, n
        assert np.abs(t - g).max() <= 2e-2 * max(np.abs(g).max(), 1e-6), n


# -- the Trainer under the loss scaler ------------------------------------------

def test_fp16_trainer_overflow_drill_matches_jax():
    """JAX's drill (`tests/unittest/test_amp.py`): a poisoned loss
    overflows, the step is skipped and the scale halves; then clean steps
    overflow in the f16 backward itself (the scaled cotangent past 65504)
    until the scale is low enough, and the step that lands divides the
    scale back out.  Weights and scales equal JAX's after every step."""
    jamp.init("float16")
    tamp.init("float16")
    mx.random.seed(3)
    jnet = jnn.Dense(2, in_units=3)
    jnet.initialize()
    tnet = tnn.Dense(2, in_units=3)
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet.collect_params().items()}, device="cpu")
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    ttr = Trainer(dict(tnet.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    jamp.init_trainer(jtr)
    tamp.init_trainer(ttr)
    w0 = _np(tnet.weight.data())
    x = np.ones((2, 3), np.float32)
    scales, applied = [], None
    for step in range(5):
        poison = step == 0
        with autograd.record():
            loss = jnet(mx.np.array(x)).sum()
            if poison:
                loss = (loss * 1e38) * 1e38
            with jamp.scale_loss(loss, jtr) as scaled:
                pass
        scaled.backward()
        jtr.step(2)
        # the port: the f16 product's sum in f32 (``sum`` is an FP32 op
        # in JAX; torch would keep f16)
        loss = tnet(torch.from_numpy(x)).float().sum()
        if poison:
            loss = (loss * 1e38) * 1e38
        with tamp.scale_loss(loss, ttr) as scaled:
            scaled.backward()
        before = _np(tnet.weight.data())
        ttr.step(2)
        np.testing.assert_array_equal(_np(tnet.weight.data()),
                                      jnet.weight.data().asnumpy())
        np.testing.assert_array_equal(_np(tnet.bias.data()),
                                      jnet.bias.data().asnumpy())
        assert ttr._amp_loss_scaler.loss_scale == \
            jtr._amp_loss_scaler.loss_scale
        scales.append(ttr._amp_loss_scaler.loss_scale)
        if not np.array_equal(_np(tnet.weight.data()), before):
            applied = step
            break
    assert scales[0] == 2.0 ** 15 and applied == 2, (scales, applied)
    np.testing.assert_allclose(_np(tnet.weight.data()), w0 - 0.1, rtol=1e-3)


def test_scale_loss_and_unscale_match_jax():
    """`scale_loss` multiplies by the trainer's scale (the loss itself
    without a scaler); `unscale` divides it out of every gradient in
    place: the gradients equal JAX's after each."""
    jamp.init("float16")
    tamp.init("float16")
    mx.random.seed(5)
    jnet = jnn.Dense(2, in_units=3)
    jnet.initialize()
    tnet = tnn.Dense(2, in_units=3)
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet.collect_params().items()}, device="cpu")
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    ttr = Trainer(dict(tnet.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    x = np.arange(12, dtype=np.float32).reshape(4, 3) / 10
    with tamp.scale_loss(torch.ones(()), Trainer(
            dict(tnet.named_parameters()), "sgd")) as plain:
        assert float(plain) == 1.0
    jamp.init_trainer(jtr)
    tamp.init_trainer(ttr)
    with autograd.record():
        loss = (jnet(mx.np.array(x)).astype("float32") ** 2).mean()
        with jamp.scale_loss(loss, jtr) as scaled:
            scaled.backward()
    loss = (tnet(torch.from_numpy(x)).float() ** 2).mean()
    with tamp.scale_loss(loss, ttr) as scaled:
        assert float(scaled) == float(loss) * 2.0 ** 16
        scaled.backward()
    for unscaled in (False, True):
        if unscaled:
            jamp.unscale(jtr)
            tamp.unscale(ttr)
        for n, p in tnet.named_parameters():
            want = jnet.collect_params()[n].grad().asnumpy()
            np.testing.assert_allclose(_np(p.grad), want, rtol=2 ** -10,
                                       atol=1e-6, err_msg=n)


def test_trainer_accepts_multi_precision_and_the_scaler():
    tamp.init("float16")
    net = tnn.Dense(2, in_units=3).initialize(device="cpu")
    tr = Trainer(dict(net.named_parameters()), "adam",
                 {"learning_rate": 0.1, "multi_precision": True})
    tamp.init_trainer(tr)
    assert isinstance(tr._amp_loss_scaler, tamp.LossScaler)


# -- multi-precision updates ------------------------------------------------------

MP_OPTS = {"sgd": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
           "adam": ("adam", dict(learning_rate=1e-2, wd=1e-3)),
           "lamb": ("lamb", dict(learning_rate=1e-2, wd=0.01))}


@pytest.mark.parametrize("wdt", ["float16", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MP_OPTS))
def test_update_multi_precision_matches_jax(name, wdt):
    """Five steps of the rule on the f32 master with the gradient cast to
    f32, the weight the master rounded: master within 1e-6 of JAX's and
    the weight within one 16-bit step, state slot by slot."""
    opt, kw = MP_OPTS[name]
    rng = np.random.RandomState(4)
    w = rng.randn(6, 5).astype(np.float32)
    jo = jopt.create(opt, multi_precision=True, **kw)
    to = tcreate(opt, multi_precision=True, **kw)
    jw = mx.np.array(w).astype(wdt)
    tw = torch.from_numpy(w).to(getattr(torch, wdt))
    js = jo.create_state_multi_precision(0, jw)
    ts = to.create_state_multi_precision(0, tw)
    assert to._is_mp_state(tw, ts) and ts[0].dtype == torch.float32
    np.testing.assert_array_equal(_np(ts[0]), js[0].asnumpy())
    step = float(torch.finfo(getattr(torch, wdt)).eps)
    for i in range(5):
        g = rng.randn(6, 5).astype(np.float32)
        jo.update_multi_precision(0, jw, mx.np.array(g).astype(wdt), js)
        ts = to.update_multi_precision(
            0, tw, torch.from_numpy(g).to(getattr(torch, wdt)), ts)
        np.testing.assert_allclose(_np(ts[0]), js[0].asnumpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=f"master {i}")
        want = jw.asnumpy().astype(np.float32)
        assert tw.dtype == getattr(torch, wdt)
        assert np.all(np.abs(_np(tw) - want) <= step * np.abs(want)), i
        for a, b in zip(ts[1], js[1]):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), b.asnumpy(), rtol=1e-6,
                                       atol=1e-7)


def _mp_models(wdt):
    mx.random.seed(9)
    jm = jnn.Dense(4, in_units=6)
    jm.initialize(mx.init.Normal(0.3))
    tm = tnn.Dense(4, in_units=6)
    load_jax_params(tm, {k: p.data().asnumpy() for k, p in
                         jm.collect_params().items()}, device="cpu")
    jm.cast(wdt)
    tamp.convert_hybrid_block(tm, wdt)
    return jm, tm


def _mp_data(i):
    rng = np.random.RandomState(20 + i)
    return (rng.randn(8, 6).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


def _mp_grads(params, i):
    """Step i's gradients, numpy-seeded and rounded to each weight's
    dtype: the two libraries' 16-bit products round at other points, so
    both sides take these in place of their backward's, and the test
    holds the update route alone."""
    rng = np.random.RandomState(40 + i)
    return {n: rng.randn(*p.shape).astype(np.float32)
            for n, p in sorted(params.items())}


def _jax_mp_step(jm, tr, i):
    x, y = _mp_data(i)
    with autograd.record():
        out = jm(mx.np.array(x).astype(jm.weight.dtype))
        loss = ((out.astype("float32") - mx.np.array(y)) ** 2).mean()
    loss.backward()
    params = jm.collect_params()
    for n, g in _mp_grads(params, i).items():
        gr = params[n].grad()
        gr._data = jnp.asarray(g).astype(gr._data.dtype)
    tr.step(8)


def _port_mp_step(tm, tr, i):
    x, y = _mp_data(i)
    out = tm(torch.from_numpy(x).to(tm.weight.data().dtype))
    loss = ((out.float() - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    params = dict(tm.named_parameters())
    for n, g in _mp_grads(params, i).items():
        params[n].grad = torch.from_numpy(g).to(params[n].dtype)
    tr.step(8)


def _close_to_jax(tm, jm, tr, jtr, wdt):
    """The masters within 1e-6 of JAX's (f32 rule arithmetic), the
    weights within one 16-bit step."""
    step = float(torch.finfo(getattr(torch, wdt)).eps)
    for n, p in tm.named_parameters():
        want = jm.collect_params()[n].data().asnumpy().astype(np.float32)
        assert p.dtype == getattr(torch, wdt)
        assert np.all(np.abs(_np(p) - want) <= step * np.abs(want)), n
        np.testing.assert_allclose(_np(tr._states[n][0]),
                                   jtr._states[n][0].asnumpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


@pytest.mark.parametrize("wdt", ["float16", "bfloat16"])
@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_trainer_multi_precision_matches_jax(name, wdt):
    """A 16-bit Dense trained four steps by the `Trainer` with
    ``multi_precision=True`` (the per-parameter route, on both sides):
    the weights and masters as `_close_to_jax` holds them."""
    opt, kw = MP_OPTS[name]
    jm, tm = _mp_models(wdt)
    jtr = jgluon.Trainer(jm.collect_params(), opt,
                         dict(kw, multi_precision=True))
    ttr = Trainer(dict(tm.named_parameters()), opt,
                  dict(kw, multi_precision=True))
    for i in range(4):
        _jax_mp_step(jm, jtr, i)
        _port_mp_step(tm, ttr, i)
        _close_to_jax(tm, jm, ttr, jtr, wdt)
    assert all(ttr._optimizer._is_mp_state(p, ttr._states[n])
               for n, p in tm.named_parameters())


def test_multi_precision_states_round_trip(tmp_path):
    """`save_states` / `load_states` carry the (master, state) pairs: a
    fresh `Trainer` continues bit for bit."""
    opt, kw = MP_OPTS["adam"]
    _, tm = _mp_models("float16")
    tr = Trainer(dict(tm.named_parameters()), opt,
                 dict(kw, multi_precision=True))
    for i in range(2):
        _port_mp_step(tm, tr, i)
    f = str(tmp_path / "mp.states")
    tr.save_states(f)
    snap = {n: p.detach().clone() for n, p in tm.named_parameters()}
    _port_mp_step(tm, tr, 2)
    after = {n: p.detach().clone() for n, p in tm.named_parameters()}
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(snap[n])
    tr2 = Trainer(dict(tm.named_parameters()), opt,
                  dict(kw, multi_precision=True))
    tr2.load_states(f)
    assert tr2._optimizer._is_mp_state(tm.weight.data(), tr2._states["weight"])
    _port_mp_step(tm, tr2, 2)
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), after[n]), n


def test_a_jax_multi_precision_run_continues_in_the_port():
    """Two mp steps in JAX, then the weights, the (master, state) pairs
    and the counts to the port, two more steps on each side."""
    opt, kw = MP_OPTS["adam"]
    jm, tm = _mp_models("float16")
    jtr = jgluon.Trainer(jm.collect_params(), opt,
                         dict(kw, multi_precision=True))
    for i in range(2):
        _jax_mp_step(jm, jtr, i)
    load_jax_params(tm, {k: p.data().asnumpy() for k, p in
                         jm.collect_params().items()}, device="cpu")
    ttr = Trainer(dict(tm.named_parameters()), opt,
                  dict(kw, multi_precision=True))
    states = {n: (st[0].asnumpy(), tuple(s.asnumpy() for s in st[1]))
              for n, st in jtr._states.items()}
    load_jax_optimizer_states(ttr, states, jtr.optimizer.num_update,
                              dict(jtr.optimizer._index_update_count))
    for i in range(2, 4):
        _jax_mp_step(jm, jtr, i)
        _port_mp_step(tm, ttr, i)
        _close_to_jax(tm, jm, ttr, jtr, "float16")
    with pytest.raises(MXNetError, match=r"\(w32, inner\)"):
        load_jax_optimizer_states(ttr, {n: st[1] for n, st in
                                        states.items()}, 2)
