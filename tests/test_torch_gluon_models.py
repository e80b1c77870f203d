"""Port parity: the models as Gluon blocks (mxnet_tpu_torch.models,
parallel.MoEFeedForward) against the JAX package's.

Each model of the port is a `gluon.HybridBlock` built from `gluon.nn`, as
JAX's is, so the Gluon calls of JAX's examples run on it as written:
`collect_params` (names, shapes, dtypes, ``grad_req``),
`save_parameters` / `load_parameters` across the two packages,
``initialize(force_reinit=True)``, the `BertSelfAttention` shim,
`examples/gpt_generation.py`'s training loop and its decodes, and a
`TrainStep` forward in training mode.  Six models at 2 layers and hidden
64: GPT classic, GPT modern (RoPE, GQA, window), GPT in bf16, BERT, the
Transformer NMT and the MoE layer.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.models import gpt as jgpt
from mxnet_tpu.models import transformer as jnmt
from mxnet_tpu.parallel import MoEFeedForward as JMoE

from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.models import gpt as tgpt
from mxnet_tpu_torch.models import transformer as tnmt
from mxnet_tpu_torch.optimizer import Adam
from mxnet_tpu_torch.parallel import MoEFeedForward, TrainStep

torch.set_num_threads(1)

V, B, L = 64, 2, 8
GPT = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position=64)
CASES = {
    "gpt_classic": ("gpt", dict(GPT)),
    "gpt_modern": ("gpt", dict(GPT, rope=True, num_kv_heads=2, window=8)),
    "gpt_bf16": ("gpt", dict(GPT, dtype="bfloat16")),
    "bert": ("bert", dict(vocab_size=V, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position=64)),
    "nmt": ("nmt", dict(src_vocab_size=V, tgt_vocab_size=V + 3,
                        hidden_size=64, num_layers=2, num_heads=4,
                        intermediate_size=128, max_position=64)),
    "moe": ("moe", dict(hidden_size=64, intermediate_size=128,
                        num_experts=4, capacity_factor=1.5)),
}
NAMES = list(CASES)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

_EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "gpt_generation.py")


def _example():
    spec = importlib.util.spec_from_file_location("gpt_generation_example",
                                                  _EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dtype(name):
    return CASES[name][1].get("dtype", "float32")


def _port(name, seed=0, dropout=0.0):
    kind, cfg = CASES[name]
    if kind == "gpt":
        return tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg, dropout=dropout),
                                   device="cpu", seed=seed)
    if kind == "bert":
        return tbert.BertForPretraining(
            tbert.BertConfig(**cfg, dropout=dropout), device="cpu",
            seed=seed)
    if kind == "nmt":
        return tnmt.TransformerNMT(
            tnmt.TransformerConfig(**cfg, dropout=dropout), device="cpu",
            seed=seed)
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    return MoEFeedForward(h, i, num_experts=cfg["num_experts"],
                          capacity_factor=cfg["capacity_factor"],
                          device="cpu", seed=seed)


def _jax(name):
    kind, cfg = CASES[name]
    mx.random.seed(1)
    if kind == "gpt":
        m = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg, dropout=0.0))
    elif kind == "bert":
        m = jbert.BertForPretraining(jbert.BertConfig(**cfg, dropout=0.0))
    elif kind == "nmt":
        m = jnmt.TransformerNMT(jnmt.TransformerConfig(**cfg, dropout=0.0))
    else:
        m = JMoE(cfg["hidden_size"], cfg["intermediate_size"],
                 num_experts=cfg["num_experts"],
                 capacity_factor=cfg["capacity_factor"])
    m.initialize()
    return m


def _inputs(name, seed=3):
    """The model's positional inputs (numpy) and, for a training loss,
    its labels."""
    kind, cfg = CASES[name]
    rng = np.random.RandomState(seed)
    if kind == "moe":
        x = rng.randn(B, L, cfg["hidden_size"]).astype(np.float32)
        return (x,), rng.randn(*x.shape).astype(np.float32)
    ids = rng.randint(0, V, (B, L)).astype(np.int32)
    if kind == "gpt":
        return (ids,), rng.randint(0, V, (B, L)).astype(np.int32)
    vl = np.array([L, L - 3], np.int32)
    if kind == "bert":
        tt = np.zeros((B, L), np.int32)
        tt[:, L // 2:] = 1
        return (ids, tt, vl), rng.randint(0, V, (B, L)).astype(np.int32)
    tgt = rng.randint(0, V + 3, (B, L - 2)).astype(np.int32)
    return (ids, tgt, vl), rng.randint(0, V + 3, tgt.shape).astype(np.int32)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _port_forward(model, args):
    return [o.detach().float().numpy() for o in
            _flat(model(*(torch.from_numpy(a) for a in args)))]


def _jax_forward(model, args):
    return [np.asarray(o.asnumpy(), np.float32) for o in
            _flat(model(*(mx.np.array(a) for a in args)))]


def _assert_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= TOL[dtype] * max(float(np.abs(w).max()), 1e-6), err


def _np_dtype(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("name", NAMES)
def test_collect_params_equal_jax(name):
    """Names, shapes, dtypes and ``grad_req`` after ``initialize()``."""
    tm = _port(name)
    tm.initialize()         # an initialized block: a no-op
    jm = _jax(name)
    tp, jp = tm.collect_params(), jm.collect_params()
    assert list(tp) == list(jp)
    for n, p in tp.items():
        assert tuple(p.shape) == tuple(jp[n].shape), n
        assert _np_dtype(p.dtype) == str(np.dtype(jp[n].dtype)), n
        assert _np_dtype(p.data().dtype) == _np_dtype(p.dtype), n
        assert p.grad_req == jp[n].grad_req == "write", n
    assert isinstance(tm, tgluon.HybridBlock)
    assert dict(tm.named_parameters()).keys() == tp.keys()


@pytest.mark.parametrize("name", NAMES)
def test_parameter_files_cross_between_packages(name, tmp_path):
    """A JAX ``save_parameters`` file loads into the port through
    `load_parameters`, and a port file into JAX, with equal forwards."""
    args, _ = _inputs(name)
    jm = _jax(name)
    jfile = str(tmp_path / "jax.npz")
    jm.save_parameters(jfile)
    tm = _port(name, seed=7)
    tm.load_parameters(jfile)
    _assert_close(_port_forward(tm, args), _jax_forward(jm, args),
                  _dtype(name))
    tm2 = _port(name, seed=11)
    tfile = str(tmp_path / "port.npz")
    tm2.save_parameters(tfile)
    jm.load_parameters(tfile)
    _assert_close(_port_forward(tm2, args), _jax_forward(jm, args),
                  _dtype(name))


@pytest.mark.parametrize("init", [None, "constant"])
@pytest.mark.parametrize("name", NAMES)
def test_force_reinit_draws_as_jax(name, init):
    """Without `force_reinit` ``initialize`` leaves an initialized model
    alone; with it every parameter is drawn again: its own initializer
    first (norms ``ones`` / ``zeros``, Dense biases ``zeros``), else
    `init`, else ``Uniform()``."""
    tm = _port(name)
    before = {n: p.data().clone() for n, p in tm.collect_params().items()}
    tm.initialize(tinit.Normal(5.0), device="cpu")
    assert all(torch.equal(p.data(), before[n])
               for n, p in tm.collect_params().items())
    tm.initialize(tinit.Constant(0.25) if init else None, device="cpu",
                  force_reinit=True)
    for n, p in tm.collect_params().items():
        w = p.data().detach().float()
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "gamma":
            assert torch.equal(w, torch.ones_like(w)), n
        elif leaf in ("beta", "bias"):
            assert torch.equal(w, torch.zeros_like(w)), n
        elif init:
            assert torch.equal(w, torch.full_like(w, 0.25)), n
        else:
            assert float(w.abs().max()) <= 0.07 and float(w.std()) > 0.01, n
        assert p.data().dtype == before[n].dtype, n


@pytest.mark.parametrize("keyword", ["attn_mask", "mask"])
def test_bert_self_attention_equals_jax(keyword):
    cfg = CASES["bert"][1]
    mx.random.seed(2)
    jatt = jbert.BertSelfAttention(jbert.BertConfig(**cfg, dropout=0.0))
    jatt.initialize(mx.init.Normal(0.2))
    tatt = tbert.BertSelfAttention(tbert.BertConfig(**cfg, dropout=0.0))
    assert list(tatt.collect_params()) == list(jatt.collect_params())
    tatt.initialize(device="cpu")
    tatt.load_dict({n: torch.from_numpy(np.asarray(p.data().asnumpy()))
                    for n, p in jatt.collect_params().items()})
    rng = np.random.RandomState(5)
    x = rng.randn(B, L, cfg["hidden_size"]).astype(np.float32)
    m = np.ones((B, 1, 1, L), np.float32)
    m[1, ..., L - 3:] = 0.0
    want = jatt(mx.np.array(x), **{keyword: mx.np.array(m)}).asnumpy()
    got = tatt(torch.from_numpy(x), **{keyword: torch.from_numpy(m)})
    _assert_close([got.detach().numpy()], [np.asarray(want)], "float32")
    # the shared surface builds the same block
    shared = tbert.BertSelfAttention(cfg["hidden_size"], cfg["num_heads"])
    assert list(shared.collect_params()) == list(tatt.collect_params())


def _example_loop(model, gluon, autograd, make, rng, steps, seq=24):
    """`examples/gpt_generation.py`'s ``train`` for `steps` steps, over
    either package (`make` turns a numpy batch into its array type)."""
    ex = _example()
    trainer = gluon.Trainer(model.collect_params(), "adam",
                            {"learning_rate": 3e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    model.hybridize()
    losses = []
    for _ in range(steps):
        ids = make(ex.synthetic_batch(rng, 8, seq, V))
        with autograd.record():
            logits = model(ids)
            loss = loss_fn(logits[:, :-1].reshape(-1, V),
                           ids[:, 1:].reshape(-1)).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(np.asarray(
            loss.asnumpy() if hasattr(loss, "asnumpy") else
            loss.detach().numpy())))
    return losses


@pytest.mark.parametrize("name", ["gpt_classic", "gpt_modern"])
def test_gpt_generation_example_loop_equals_jax(name, tmp_path):
    """Five steps of the example's loop at dropout 0 from the same
    weights give JAX's losses; greedy and beam `generate` over the JAX
    run's weights give JAX's tokens."""
    jm = _jax(name)
    tm = _port(name)
    f = str(tmp_path / "w.npz")
    jm.save_parameters(f)
    tm.load_parameters(f)
    jl = _example_loop(jm, jgluon, jag, mx.np.array,
                       np.random.RandomState(0), 5)
    tl = _example_loop(tm, tgluon, tag, torch.from_numpy,
                       np.random.RandomState(0), 5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jm.save_parameters(f)
    tm.load_parameters(f)
    prompt = _example().synthetic_batch(np.random.RandomState(4), 2, 4, V)
    for kw in (dict(), dict(num_beams=4, eos_token_id=V - 1)):
        want = jm.generate(mx.np.array(prompt), max_new_tokens=8, **kw)
        got = tm.generate(torch.from_numpy(prompt), max_new_tokens=8, **kw)
        assert got.tolist() == np.asarray(want.asnumpy()).tolist(), kw


def _loss_fn(name):
    kind = CASES[name][0]

    def loss(out, *batch):
        lab = torch.as_tensor(batch[-1])
        if kind == "moe":
            o, aux = out
            return ((o - lab) ** 2).mean() + 0.01 * aux
        logits = out[0] if kind == "bert" else out
        return torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            lab.reshape(-1).long())
    return loss


@pytest.mark.parametrize("name", NAMES)
def test_train_step_runs_in_training_mode(name):
    """`TrainStep` forwards in training mode, as JAX's step does: with
    dropout 0.1 its loss equals a manual ``autograd.train_mode()`` forward
    from the same weights and generator state, and differs from the
    forward in predict mode (masks were drawn)."""
    args, lab = _inputs(name)
    tm = _port(name, dropout=0.1)
    ref = _port(name, dropout=0.1)
    batch = tuple(torch.from_numpy(a) for a in args + (lab,))
    step = TrainStep(tm, Adam(learning_rate=1e-3), _loss_fn(name),
                     num_model_args=len(args))
    loss = float(step(*batch))
    loss_fn = _loss_fn(name)
    with torch.no_grad():
        with tag.train_mode():
            manual = float(loss_fn(ref(*batch[:-1]), *batch))
        predict = float(loss_fn(ref(*batch[:-1]), *batch))
    assert loss == manual
    has_dropout = any(isinstance(m, tnn.Dropout) for m in tm.modules())
    assert has_dropout == (CASES[name][0] != "moe")
    if has_dropout:
        assert predict != manual
        assert ref.generator is not None and all(
            m.generator is ref.generator for m in ref.modules()
            if isinstance(m, tnn.Dropout))


@pytest.mark.parametrize("name", NAMES)
def test_models_free_on_their_last_reference(name):
    """A block and its parameters form no reference cycle: a model and
    its weights go with their last reference, before any garbage
    collection (on the card, memory a later run measures)."""
    import gc
    import weakref
    was = gc.isenabled()
    gc.disable()
    try:
        tm = _port(name)
        args, _ = _inputs(name)
        with tag.record():
            out = _flat(tm(*(torch.from_numpy(a) for a in args)))
        sum(o.float().sum() for o in out).backward()
        refs = [weakref.ref(tm)] + [weakref.ref(p.data())
                                    for p in tm.collect_params().values()]
        del tm, out
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()
