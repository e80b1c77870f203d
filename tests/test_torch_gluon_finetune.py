"""Port parity: the repo's Gluon user programs, the port against the JAX
package on the CPU.

- `examples/bert_finetune.py`'s loop at the example's tiny configuration
  (2 layers, hidden 64, dropout 0): `BertClassifier` over the port's
  `BertModel`, JAX's weights carried in through `load_jax_params`,
  ``hybridize``, ``autograd.record``, `SoftmaxCrossEntropyLoss`, the
  layer-wise ``lr_mult``, the warm-up `PolyScheduler` and `Trainer`'s Adam
  (epsilon 1e-6: the key third of the QKV bias has a zero gradient up to
  rounding, which 1e-8 would turn into steps), with `metric.Accuracy` and
  `metric.F1`: losses, metrics and every weight after 3 steps within 1e-4
  relative (f32, after training steps); the key third of each QKV bias,
  whose gradient is zero up to rounding, within the 3 * lr * 1e-2 that
  Adam can move it under that epsilon.  JAX's `Trainer` never hands its
  parameters to the optimizer, so a ``Parameter.lr_mult`` changes nothing
  there (ROADMAP.md §C); the JAX side is given them (``param_dict``), as
  MXNet's `Trainer` does and the port's does;
- a `Trainer` over Gluon parameters with no multiplier (the fused route,
  both ``MXTPU_PALLAS`` routes), with ``wd_mult`` and with a ``grad_req=
  "null"`` parameter, against JAX's: 1e-5;
- `examples/quantization_int8.py`'s flow: an MLP trained in JAX, its
  weights in both packages, `quantize_net` with naive and entropy
  calibration: the thresholds equal and the int8 net's outputs within
  1e-5 of their scale.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import metric as jmetric, nn as jnn
from mxnet_tpu.models.bert import BertConfig as JCfg, BertModel as JBert
from mxnet_tpu.optimizer import lr_scheduler as jsched

import mxnet_tpu_torch as tm
from mxnet_tpu_torch import autograd as tag, gluon as tgluon
from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.gluon import metric as tmetric, nn as tnn
from mxnet_tpu_torch.models.bert import BertConfig as TCfg, BertModel as TBert
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64, dropout=0.0)
STEPS, BATCH, SEQ, DECAY, LR = 3, 8, 32, 0.75, 5e-4


class JClassifier(jgluon.block.HybridBlock):
    def __init__(self, cfg):
        super().__init__()
        self.bert = JBert(cfg)
        self.dropout = jnn.Dropout(cfg.dropout)
        self.classifier = jnn.Dense(2, in_units=cfg.hidden_size)

    def forward(self, ids, tt, vl):
        _, pooled = self.bert(ids, tt, vl)
        return self.classifier(self.dropout(pooled))


class TClassifier(tgluon.HybridBlock):
    def __init__(self, cfg):
        super().__init__()
        self.bert = TBert(cfg)
        self.dropout = tnn.Dropout(cfg.dropout)
        self.classifier = tnn.Dense(2, in_units=cfg.hidden_size)

    def forward(self, ids, tt, vl):
        _, pooled = self.bert(ids, tt, vl)
        return self.classifier(self.dropout(pooled))


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(5, 256, (BATCH, SEQ))
        tt = np.zeros((BATCH, SEQ), np.int32)
        tt[:, SEQ // 2:] = 1
        vl = rng.randint(int(0.8 * SEQ), SEQ + 1, (BATCH,)).astype(np.int32)
        lab = rng.randint(0, 2, (BATCH,))
        ids[:, SEQ // 2] = 3 + lab
        out.append((ids.astype(np.int32), tt, vl, lab.astype(np.int32)))
    return out


def _layer_wise(params):
    for name, p in params.items():
        if ".layers." in name:
            p.lr_mult = DECAY ** (2 - int(name.split(".layers.")[1]
                                          .split(".")[0]))
        elif name.startswith("bert."):
            p.lr_mult = DECAY ** 3


def _sched(mod):
    return mod.PolyScheduler(max_update=STEPS, base_lr=LR, final_lr=0.0,
                             pwr=1, warmup_steps=1, warmup_begin_lr=0.0)


def test_bert_finetune_loop_matches_jax():
    mx.random.seed(0)
    jnet = JClassifier(JCfg(**TINY))
    jnet.initialize(mx.init.Normal(0.2))
    b = _batches()
    jnet(*[mx.np.array(a) for a in b[0][:3]])
    tnet = TClassifier(TCfg(**TINY))
    with tm.cpu():
        tnet.initialize()
    load_jax_params(tnet, {k: v.data().asnumpy() for k, v in
                           jnet.collect_params().items()}, device="cpu")
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp) == list(jp)
    _layer_wise(jp)
    _layer_wise(tp)
    opts = {"learning_rate": LR, "epsilon": 1e-6}
    jtr = jgluon.Trainer(jp, "adam", dict(opts, lr_scheduler=_sched(jsched)))
    jtr.optimizer.param_dict = dict(jp)        # MXNet's Trainer wiring
    ttr = tgluon.Trainer(tp, "adam", dict(opts, lr_scheduler=_sched(tsched)))
    jloss, tloss = jgluon.loss.SoftmaxCrossEntropyLoss(), \
        tgluon.loss.SoftmaxCrossEntropyLoss()
    jnet.hybridize()
    tnet.hybridize()
    jm = [jmetric.Accuracy(), jmetric.F1()]
    tms = [tmetric.Accuracy(), tmetric.F1()]
    for ids, tt, vl, lab in b:
        with jag.record():
            jl = jloss(jnet(mx.np.array(ids), mx.np.array(tt),
                            mx.np.array(vl)), mx.np.array(lab))
        jl.backward()
        jtr.step(BATCH)
        targs = [torch.from_numpy(a) for a in (ids, tt, vl)]
        with tag.record():
            tlogits = tnet(*targs)
            tl = tloss(tlogits, torch.from_numpy(lab))
        tag.backward(tl)
        ttr.step(BATCH)
        np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                   rtol=1e-4, atol=1e-6)
        with jag.predict_mode():
            jlogits = jnet(mx.np.array(ids), mx.np.array(tt),
                           mx.np.array(vl))
        tlogits = tnet(*targs).detach()
        for a, c in zip(jm, tms):
            a.update(mx.np.array(lab), jlogits)
            c.update(torch.from_numpy(lab), tlogits)
    for a, c in zip(jm, tms):
        assert c.get()[1] == pytest.approx(a.get()[1], abs=1e-12)
    assert ttr.optimizer.num_update == STEPS
    h = TINY["hidden_size"]
    for k, p in tp.items():
        got, want = p.data().detach().numpy(), jp[k].data().asnumpy()
        if k.endswith("attn_qkv.bias"):
            # the key third's gradient is zero up to rounding: under
            # epsilon 1e-6 a step moves it at most lr * 1e-2
            np.testing.assert_allclose(got[h:2 * h], want[h:2 * h], rtol=0,
                                       atol=STEPS * LR * 1e-2, err_msg=k)
            got, want = np.delete(got, np.s_[h:2 * h]), \
                np.delete(want, np.s_[h:2 * h])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _mlp(nn, dense_kw=None):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu", **(dense_kw or {})),
            nn.LayerNorm(in_channels=16), nn.Dense(3, in_units=16))
    return net


@pytest.mark.parametrize("route", ["kernel", "reference"])
@pytest.mark.parametrize("variant", ["plain", "wd_mult", "null"])
def test_trainer_over_gluon_parameters_matches_jax(monkeypatch, route,
                                                   variant):
    monkeypatch.setenv("MXTPU_PALLAS", route)
    # JAX's kernel route runs its Pallas kernels in the interpreter
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    jnet, tnet = _mlp(jnn), _mlp(tnn)
    mx.random.seed(0)      # the draw, not the order of the tests before it
    jnet.initialize(mx.init.Normal(0.3))
    with tm.cpu():
        tnet.initialize()
    tnet.load_dict({k: torch.from_numpy(v.data().asnumpy())
                    for k, v in jnet.collect_params().items()})
    jp, tp = jnet.collect_params(), tnet.collect_params()
    if variant == "wd_mult":
        for ps in (jp, tp):
            ps["0.weight"].wd_mult = 0.0
            ps["2.bias"].lr_mult = 2.0
    if variant == "null":
        for ps in (jp, tp):
            ps["1.gamma"].grad_req = "null"
    opts = {"learning_rate": 0.05, "wd": 0.01}
    jtr = jgluon.Trainer(jp, "adamw", opts)
    if variant == "wd_mult":
        jtr.optimizer.param_dict = dict(jp)
    ttr = tgluon.Trainer(tp, "adamw", opts)
    assert ttr._uniform_mults() == (variant != "wd_mult")
    rng = np.random.RandomState(1)
    for _ in range(3):
        x = rng.randn(6, 8).astype(np.float32)
        y = rng.randint(0, 3, (6,)).astype(np.int32)
        with jag.record():
            jl = jgluon.loss.SoftmaxCrossEntropyLoss()(jnet(mx.np.array(x)),
                                                      mx.np.array(y))
        jl.backward()
        jtr.step(6)
        with tag.record():
            tl = tgluon.loss.SoftmaxCrossEntropyLoss()(
                tnet(torch.from_numpy(x)), torch.from_numpy(y))
        tag.backward(tl)
        ttr.step(6)
    for k, p in tp.items():
        np.testing.assert_allclose(p.data().detach().numpy(),
                                   jp[k].data().asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if variant == "null":
        assert "1.gamma" not in ttr._param_names
        assert torch.equal(tp["1.gamma"].data(), torch.ones(16))


def test_quantize_net_flow_matches_jax():
    rng = np.random.RandomState(0)
    centers = rng.randn(3, 16) * 3
    X = np.concatenate([centers[i] + rng.randn(60, 16)
                        for i in range(3)]).astype(np.float32)
    Y = np.repeat(np.arange(3), 60).astype(np.int32)
    perm = rng.permutation(180)
    X, Y = X[perm], Y[perm]
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(64, in_units=16, activation="relu"),
             jnn.Dense(32, in_units=64, activation="relu"),
             jnn.Dense(3, in_units=32))
    jnet.initialize()
    jtr = jgluon.Trainer(jnet.collect_params(), "adam",
                         {"learning_rate": 5e-3})
    for i in range(0, 120, 30):
        with jag.record():
            loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
                jnet(mx.np.array(X[i:i + 30])), mx.np.array(Y[i:i + 30]))
        loss.backward()
        jtr.step(30)
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(64, in_units=16, activation="relu"),
             tnn.Dense(32, in_units=64, activation="relu"),
             tnn.Dense(3, in_units=32))
    with tm.cpu():
        tnet.initialize()
    tnet.load_dict({k: torch.from_numpy(v.data().asnumpy())
                    for k, v in jnet.collect_params().items()})
    calib = X[:120].reshape(4, 30, 16)
    xte = X[120:]
    for mode in ("naive", "entropy"):
        jqn = jq.quantize_net(jnet, calib_data=[mx.np.array(c)
                                                for c in calib],
                              calib_mode=mode)
        tqn = tq.quantize_net(tnet, calib_data=[torch.from_numpy(c)
                                                for c in calib],
                              calib_mode=mode)
        assert sorted(tqn._qmap) == sorted(jqn._qmap) == ["0", "1", "2"]
        for k, q in tqn._qmap.items():
            assert q.x_amax == pytest.approx(jqn._qmap[k].x_amax,
                                             rel=1e-5), (mode, k)
            assert q.w_amax == pytest.approx(jqn._qmap[k].w_amax, rel=1e-6)
        jo = jqn(mx.np.array(xte)).asnumpy()
        to = tqn(torch.from_numpy(xte)).numpy()
        scale = np.abs(jo).max()
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5 * scale)
    # excluded layers keep f32; no Dense leaves the net as it is
    part = tq.quantize_net(tnet, calib_data=[torch.from_numpy(calib[0])],
                           exclude_layers=["2"])
    assert sorted(part._qmap) == ["0", "1"]
    assert part.collect_params() is not None
    lone = tnn.HybridSequential(tnn.Activation("relu"))
    assert tq.quantize_net(lone) is lone
    with pytest.raises(tm.MXNetError, match="int8"):
        tq.quantize_net(tnet, quantized_dtype="uint8")
