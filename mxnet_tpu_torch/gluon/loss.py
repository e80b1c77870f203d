"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``).

A loss is a `HybridBlock` whose forward returns the per-sample loss,
weighted by ``weight`` and ``sample_weight`` and averaged over every axis
but `batch_axis` (`CTCLoss`, `TripletLoss`, `CosineEmbeddingLoss` and
`SDMLLoss` return one value a sample as they are).  The sparse-label,
last-axis route of `SoftmaxCrossEntropyLoss` runs the streaming
cross-entropy kernels on the card (`ops.softmax_xent`); every other
route is plain torch, as the JAX package's is plain jnp.  `CTCLoss` goes
through `ops.nn.ctc_loss` with the blank last.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from ..ops import nn as F
from .block import HybridBlock

__all__ = [
    "Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
    "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
    "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
    "LogisticLoss", "TripletLoss", "PoissonNLLLoss", "CosineEmbeddingLoss",
    "SDMLLoss",
]


def _reshape_like(pred, label):
    label = torch.as_tensor(label, device=pred.device)
    if label.shape != pred.shape:
        return label.reshape(pred.shape)
    return label


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _softrelu_neg_abs(x):
    """``log(1 + exp(-|x|))``: MXNet's ``softrelu`` of ``-|x|``."""
    return F.activation(-x.abs(), "softrelu")


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_nonbatch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred) ** 2
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_nonbatch(loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of logits (``from_sigmoid=False``, the stable
    form) or of probabilities; ``pos_weight`` weighs the positives."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _softrelu_neg_abs(pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu_neg_abs(pred) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label +
                         torch.log(1 - pred + eps) * (1 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight +
                         torch.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy of `pred` logits against sparse class indices
    (``sparse_label``) or dense label distributions, over `axis`;
    ``from_logits`` takes `pred` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if self._from_logits:
            if self._sparse_label:
                loss = -F.pick(pred, label, axis=self._axis)
            else:
                label = _reshape_like(pred, label)
                loss = -(pred * label).sum(dim=self._axis)
        elif self._sparse_label and self._axis in (-1, pred.dim() - 1):
            # the streaming kernel never writes f32 (N, V) log-probs
            loss = F.softmax_cross_entropy(pred, label)
        else:
            logp = pred.log_softmax(dim=self._axis)
            if self._sparse_label:
                loss = -F.pick(logp, label, axis=self._axis)
            else:
                label = _reshape_like(logp, label)
                loss = -(logp * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class CTCLoss(Loss):
    """Connectionist temporal classification over pre-softmax scores
    (`layout` "NTC" or "TNC"), labels padded with -1 (`label_layout` "NT"
    or "TN"), the blank the last class; one loss a sequence."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"bad layout {layout}")
        super().__init__(weight, label_layout.find("N"), **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = F.ctc_loss(pred, label, pred_lengths, label_lengths,
                          use_data_lengths=pred_lengths is not None,
                          use_label_lengths=label_lengths is not None,
                          blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss ** 2)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.relu(self._margin - pred * label) ** 2
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = (pred - positive) ** 2 - (pred - negative) ** 2
        if loss.dim() > 1:
            loss = loss.sum(dim=tuple(range(1, loss.dim())))
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target + \
                0.5 * torch.log(2 * math.pi * (target + 1e-12))
            stirling = torch.where(target <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        num = (input1 * input2).sum(dim=-1)
        den = torch.sqrt((input1 ** 2).sum(dim=-1)) * \
            torch.sqrt((input2 ** 2).sum(dim=-1))
        sim = num / (den + 1e-12)
        label = torch.as_tensor(label, device=sim.device).reshape(sim.shape)
        loss = torch.where(label == 1, 1 - sim,
                           torch.relu(sim - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed Deep Metric Learning loss (Bonadiman et al. 2019):
    aligned rows of `x1` and `x2` are positives, every other row of the
    minibatch a smoothed negative; per row, the KL divergence of the
    smoothed one-hot target from the softmax over negative squared
    distances."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.smoothing_parameter = smoothing_parameter

    def _smoothed_targets(self, n, device):
        sp = self.smoothing_parameter
        eye = np.eye(n)
        smooth = sp / (n - 1)
        t = eye * (1.0 - sp) + (1 - eye) * smooth
        ent = (1 - sp) * np.log(max(1 - sp, 1e-12)) + \
            (n - 1) * smooth * np.log(max(smooth, 1e-12))
        return torch.tensor(t.astype(np.float32), device=device), float(ent)

    def forward(self, x1, x2, sample_weight=None):
        n = x1.shape[0]
        if n < 2:
            raise MXNetError(
                "SDMLLoss needs batch size >= 2: the other rows of the "
                "minibatch are the negative examples")
        target, ent = self._smoothed_targets(n, x1.device)
        dist = ((x1.unsqueeze(1) - x2.unsqueeze(0)) ** 2).sum(dim=2)
        logp = F.log_softmax(-dist, axis=-1)
        kl = ent - (target * logp).sum(dim=-1)
        return _apply_weighting(kl, self._weight, sample_weight)
