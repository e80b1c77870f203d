"""Port parity: every metric of `gluon.metric` against the JAX package's
``mxnet_tpu/gluon/metric.py``.

Each metric sees the same three seeded updates in both packages (the port
takes ``torch.Tensor``s, one update a bf16 tensor, JAX its ndarrays) and
`get` must agree within 1e-12 relative (both are numpy on the host, in
f64); then `reset`, `get_name_value`, `create` by name (and by list and
callable), `CompositeEvalMetric` and the numpy wrapper `np`.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import metric as jm

from mxnet_tpu_torch.gluon import metric as tmet

torch.set_num_threads(1)


def _batch(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "class":           # (labels, class scores)
        return (rng.randint(0, 4, (8,)).astype(np.float32),
                rng.rand(8, 4).astype(np.float32))
    if kind == "binary":          # (labels, 2-class scores)
        return (rng.randint(0, 2, (10,)).astype(np.float32),
                rng.rand(10, 2).astype(np.float32))
    if kind == "binary_prob":     # (labels, one probability a sample)
        return (rng.randint(0, 2, (10,)).astype(np.float32),
                rng.rand(10).astype(np.float32))
    if kind == "regress":
        return (rng.randn(6, 3).astype(np.float32),
                rng.randn(6, 3).astype(np.float32))
    if kind == "prob":            # (labels, probability rows)
        p = rng.rand(7, 5).astype(np.float32) + 0.05
        return (rng.randint(0, 5, (7,)).astype(np.float32),
                p / p.sum(-1, keepdims=True))
    if kind == "loss":
        return (None, rng.rand(5).astype(np.float32))
    raise ValueError(kind)


METRICS = {
    "accuracy": (lambda m: m.Accuracy(), "class"),
    "top_k": (lambda m: m.TopKAccuracy(top_k=2), "class"),
    "f1": (lambda m: m.F1(), "binary"),
    "f1_prob": (lambda m: m.F1(threshold=0.4), "binary_prob"),
    "fbeta": (lambda m: m.Fbeta(beta=2.0), "binary"),
    "binary_accuracy": (lambda m: m.BinaryAccuracy(threshold=0.6),
                        "binary_prob"),
    "mcc": (lambda m: m.MCC(), "binary"),
    "pcc": (lambda m: m.PCC(), "class"),
    "pcc_binary": (lambda m: m.PCC(), "binary_prob"),
    "mae": (lambda m: m.MAE(), "regress"),
    "mse": (lambda m: m.MSE(), "regress"),
    "rmse": (lambda m: m.RMSE(), "regress"),
    "mean_pairwise_distance": (lambda m: m.MeanPairwiseDistance(p=3),
                               "regress"),
    "mean_cosine_similarity": (lambda m: m.MeanCosineSimilarity(),
                               "regress"),
    "cross_entropy": (lambda m: m.CrossEntropy(), "prob"),
    "perplexity": (lambda m: m.Perplexity(), "prob"),
    "nll": (lambda m: m.NegativeLogLikelihood(), "prob"),
    "pearson": (lambda m: m.PearsonCorrelation(), "regress"),
    "loss": (lambda m: m.Loss(), "loss"),
    "torch": (lambda m: m.Torch(), "loss"),
    "caffe": (lambda m: m.Caffe(), "loss"),
    "custom": (lambda m: m.CustomMetric(
        lambda lab, pred: float(np.abs(lab - pred).sum()), name="l1"),
        "regress"),
}


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax_over_three_updates(name):
    factory, kind = METRICS[name]
    j, t = factory(jm), factory(tmet)
    for step in range(3):
        lab, pred = _batch(kind, 7 * step + 1)
        jl = None if lab is None else mx.np.array(lab)
        tl = None if lab is None else torch.from_numpy(lab)
        tp = torch.from_numpy(pred)
        if step == 1 and kind in ("class", "binary"):
            # a bf16 score tensor, as a bf16 model's logits arrive
            tp = tp.to(torch.bfloat16)
            pred = tp.float().numpy()
        j.update(jl, mx.np.array(pred))
        t.update(tl, tp)
        jn, jv = j.get()
        tn, tv = t.get()
        assert tn == jn
        assert isinstance(tv, float)
        _same(tv, jv)
    _same(t.get_name_value(), j.get_name_value())
    t.reset()
    j.reset()
    _same(t.get(), j.get())


def test_create_composite_and_np_wrapper_match_jax():
    for name in ("acc", "accuracy", "f1", "mse", "rmse", "ce",
                 "topkaccuracy", "pearsoncorrelation", "mcc", "pcc", "loss",
                 "negativeloglikelihood", "perplexity", "mae",
                 "binaryaccuracy", "fbeta", "crossentropy"):
        try:
            jmetric = jm.create(name)
        except Exception:           # names JAX does not register
            with pytest.raises(Exception, match="not registered"):
                tmet.create(name)
            continue
        assert type(tmet.create(name)).__name__ == type(jmetric).__name__
    jc = jm.create(["accuracy", "f1"])
    tc = tmet.create(["accuracy", "f1"])
    assert isinstance(tc, tmet.CompositeEvalMetric)
    lab, pred = _batch("binary", 3)
    jc.update(mx.np.array(lab), mx.np.array(pred))
    tc.update(torch.from_numpy(lab), torch.from_numpy(pred))
    _same(list(tc.get()), list(jc.get()))
    _same(tc.get_name_value(), jc.get_name_value())
    comp = tmet.CompositeEvalMetric([tmet.MAE(), "mse"])
    comp.add(tmet.RMSE())
    lab, pred = _batch("regress", 4)
    comp.update([torch.from_numpy(lab)], [torch.from_numpy(pred)])
    assert [n for n, _ in comp.get_name_value()] == ["mae", "mse", "rmse"]
    jw = jm.np(lambda lab, pred: float((lab == pred.argmax(-1)).mean()))
    tw = tmet.np(lambda lab, pred: float((lab == pred.argmax(-1)).mean()))
    lab, pred = _batch("class", 5)
    jw.update(mx.np.array(lab), mx.np.array(pred))
    tw.update(torch.from_numpy(lab), torch.from_numpy(pred))
    _same(tw.get(), jw.get())
    fn = tmet.create(lambda lab, pred: 1.0, name="one")
    assert isinstance(fn, tmet.CustomMetric)
    assert math.isnan(tmet.Accuracy().get()[1])
