"""Port parity: every loss of `gluon.loss` against the JAX package's
``mxnet_tpu/gluon/loss.py``, and `ops.nn.ctc_loss` against ``npx.ctc_loss``.

For each of the 14 losses, on the same seeded inputs: the per-sample loss
and the gradient of every float input (through a seeded head gradient),
with ``weight``, ``sample_weight`` and ``batch_axis`` where the loss takes
them, within 1e-5 relative (f32).  CTC (both blank conventions, with and
without data and label lengths) is held within 1e-4 relative: its loss is
a log-space sum over alignments, which JAX (``optax.ctc_loss``, its own
recursion and ``log_epsilon``) and torch (``F.ctc_loss``) take in other
orders.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu import numpy_extension as npx

from mxnet_tpu_torch import autograd as tag, gluon as tgluon
from mxnet_tpu_torch.ops import nn as tnn_ops

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
CTC_TOL = dict(rtol=1e-4, atol=1e-5)


def _r(seed, shape, kind="normal"):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        return rng.randn(*shape).astype(np.float32)
    if kind == "pos":
        return (rng.rand(*shape) * 0.9 + 0.05).astype(np.float32)
    if kind == "binary":
        return rng.randint(0, 2, shape).astype(np.float32)
    if kind == "signed":
        return (rng.randint(0, 2, shape) * 2 - 1).astype(np.float32)
    if kind == "counts":
        return rng.poisson(2.0, shape).astype(np.float32)
    if kind == "dist":
        p = rng.rand(*shape).astype(np.float32) + 0.1
        return p / p.sum(-1, keepdims=True)
    if kind == "index":
        return rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    raise ValueError(kind)


# name -> (class name, kwargs, [(input shape, kind, differentiable)],
#          sample_weight shape or None)
B = (4, 5)
BT = (5, 4)             # batch on axis 1
SPECS = {
    "l2": ("L2Loss", {}, [(B, "normal", True), (B, "normal", False)],
           (4, 1)),
    "l2_weight_batch1": ("L2Loss", {"weight": 0.5, "batch_axis": 1},
                         [(BT, "normal", True), (BT, "normal", False)],
                         (1, 4)),
    "l1": ("L1Loss", {"weight": 2.0}, [(B, "normal", True),
                                      (B, "normal", False)], (4, 1)),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {},
                    [(B, "normal", True), (B, "binary", False)], (4, 1)),
    "sigmoid_bce_from_sigmoid": (
        "SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True,
                                          "weight": 0.3},
        [(B, "pos", True), (B, "binary", False)], None),
    "softmax_ce_sparse": ("SoftmaxCrossEntropyLoss", {},
                          [(B, "normal", True), (B, "index", False)],
                          (4,)),
    "softmax_ce_dense": ("SoftmaxCrossEntropyLoss", {"sparse_label": False},
                         [(B, "normal", True), (B, "dist", False)], (4,)),
    "softmax_ce_from_logits_axis0": (
        "SoftmaxCrossEntropyLoss", {"from_logits": True, "axis": 0,
                                    "weight": 1.5},
        [(BT, "normal", True), ((4, 5), "index", False)], None),
    "kldiv": ("KLDivLoss", {}, [(B, "normal", True), (B, "dist", False)],
              (4, 1)),
    "kldiv_logits": ("KLDivLoss", {"from_logits": False, "weight": 2.0},
                     [(B, "normal", True), (B, "dist", False)], None),
    "huber": ("HuberLoss", {"rho": 0.7}, [(B, "normal", True),
                                          (B, "normal", False)], (4, 1)),
    "hinge": ("HingeLoss", {"margin": 0.5}, [(B, "normal", True),
                                             (B, "signed", False)], (4, 1)),
    "squared_hinge": ("SquaredHingeLoss", {"weight": 0.5},
                      [(B, "normal", True), (B, "signed", False)], None),
    "logistic_signed": ("LogisticLoss", {}, [(B, "normal", True),
                                             (B, "signed", False)], (4, 1)),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        [(B, "normal", True), (B, "binary", False)], None),
    "triplet": ("TripletLoss", {"margin": 0.3},
                [(B, "normal", True), (B, "normal", True),
                 (B, "normal", True)], (4,)),
    "poisson_nll": ("PoissonNLLLoss", {}, [(B, "normal", True),
                                           (B, "counts", False)], (4, 1)),
    "poisson_nll_full": ("PoissonNLLLoss", {"from_logits": False,
                                            "compute_full": True},
                         [(B, "pos", True), (B, "counts", False)], None),
    "cosine_embedding": ("CosineEmbeddingLoss", {"margin": 0.1},
                         [(B, "normal", True), (B, "normal", True),
                          ((4,), "signed", False)], (4,)),
    "sdml": ("SDMLLoss", {"smoothing_parameter": 0.2},
             [(B, "normal", True), (B, "normal", True)], (4,)),
}


@pytest.mark.parametrize("with_sample_weight", [False, True])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_loss_matches_jax(name, with_sample_weight):
    cls, kw, inputs, sw_shape = SPECS[name]
    if with_sample_weight and sw_shape is None:
        sw_shape = (1,)
    arrays = [_r(10 + i, shape, kind)
              for i, (shape, kind, _) in enumerate(inputs)]
    jargs, targs = [], []
    for a, (_, kind, diff) in zip(arrays, inputs):
        j = mx.np.array(a, dtype="int32") if kind == "index" \
            else mx.np.array(a)
        t = torch.from_numpy(a.copy())
        if diff:
            j.attach_grad()
            t.requires_grad_()
        jargs.append(j)
        targs.append(t)
    jkw, tkw = {}, {}
    if with_sample_weight:
        sw = np.abs(_r(30, sw_shape)) + 0.5
        jkw["sample_weight"] = mx.np.array(sw)
        tkw["sample_weight"] = torch.from_numpy(sw)
    jl = getattr(jgluon.loss, cls)(**kw)
    tl = getattr(tgluon.loss, cls)(**kw)
    with jag.record():
        jy = jl(*jargs, **jkw)
    g = _r(40, jy.shape)
    jy.backward(mx.np.array(g))
    with tag.record():
        ty = tl(*targs, **tkw)
    tag.backward(ty, torch.from_numpy(g))
    assert tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **TOL)
    for j, t, (_, _, diff) in zip(jargs, targs, inputs):
        if diff:
            np.testing.assert_allclose(t.grad.numpy(), j.grad.asnumpy(),
                                       **TOL)


def test_sigmoid_bce_pos_weight_matches_jax():
    x, lab = _r(1, B), _r(2, B, "binary")
    pw = np.abs(_r(3, (1, 5))) + 0.5
    for from_sigmoid in (False, True):
        xin = 1 / (1 + np.exp(-x)) if from_sigmoid else x
        jx = mx.np.array(xin)
        jx.attach_grad()
        tx = torch.from_numpy(xin.astype(np.float32)).requires_grad_()
        kw = {"from_sigmoid": from_sigmoid}
        with jag.record():
            jy = jgluon.loss.SigmoidBCELoss(**kw)(
                jx, mx.np.array(lab), pos_weight=mx.np.array(pw))
        jy.backward()
        with tag.record():
            ty = tgluon.loss.SigmoidBCELoss(**kw)(
                tx, torch.from_numpy(lab), pos_weight=torch.from_numpy(pw))
        tag.backward(ty)
        np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **TOL)
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                   **TOL)


def _ctc_inputs(seed, T=12, Bn=3, C=6, L=4):
    rng = np.random.RandomState(seed)
    data = rng.randn(T, Bn, C).astype(np.float32)
    # labels avoid both blanks (0 and C - 1), padded with -1
    label = rng.randint(1, C - 1, (Bn, L)).astype(np.float32)
    label[0, 3:] = -1
    label[2, 2:] = -1
    data_len = np.array([T, T - 2, T - 5], np.float32)
    label_len = np.array([3, 4, 2], np.float32)
    return data, label, data_len, label_len


@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("lengths", ["none", "data", "label", "both"])
def test_ctc_loss_op_matches_jax(blank, lengths):
    data, label, dl, ll = _ctc_inputs(5)
    use_d, use_l = lengths in ("data", "both"), lengths in ("label", "both")
    jd = mx.np.array(data)
    jd.attach_grad()
    td = torch.from_numpy(data.copy()).requires_grad_()
    with jag.record():
        jy = npx.ctc_loss(jd, mx.np.array(label),
                          mx.np.array(dl) if use_d else None,
                          mx.np.array(ll) if use_l else None,
                          use_data_lengths=use_d, use_label_lengths=use_l,
                          blank_label=blank)
    jy.backward()
    with tag.record():
        ty = tnn_ops.ctc_loss(td, torch.from_numpy(label),
                              torch.from_numpy(dl) if use_d else None,
                              torch.from_numpy(ll) if use_l else None,
                              use_data_lengths=use_d,
                              use_label_lengths=use_l, blank_label=blank)
    tag.backward(ty)
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **CTC_TOL)
    np.testing.assert_allclose(td.grad.numpy(), jd.grad.asnumpy(),
                               **CTC_TOL)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_loss_block_matches_jax(layout, lengths):
    data, label, dl, ll = _ctc_inputs(6)
    if layout == "NTC":
        data = np.ascontiguousarray(data.transpose(1, 0, 2))
    sw = np.array([[1.0], [0.5], [2.0]], np.float32)[:, 0]
    jd = mx.np.array(data)
    jd.attach_grad()
    td = torch.from_numpy(data.copy()).requires_grad_()
    jargs = [mx.np.array(label)]
    targs = [torch.from_numpy(label)]
    if lengths:
        jargs += [mx.np.array(dl), mx.np.array(ll)]
        targs += [torch.from_numpy(dl), torch.from_numpy(ll)]
    with jag.record():
        jy = jgluon.loss.CTCLoss(layout=layout, weight=0.5)(
            jd, *jargs, sample_weight=mx.np.array(sw))
    jy.backward()
    with tag.record():
        ty = tgluon.loss.CTCLoss(layout=layout, weight=0.5)(
            td, *targs, sample_weight=torch.from_numpy(sw))
    tag.backward(ty)
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **CTC_TOL)
    np.testing.assert_allclose(td.grad.numpy(), jd.grad.asnumpy(),
                               **CTC_TOL)
