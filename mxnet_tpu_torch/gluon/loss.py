"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``; the softmax
cross-entropy loss so far).

A loss is an `nn.Module` whose forward returns the per-sample loss,
averaged over every axis but `batch_axis`.  The sparse-label, last-axis
route of `SoftmaxCrossEntropyLoss` runs the streaming cross-entropy
kernels on the card (`ops.softmax_xent`); the other routes are plain torch.
"""
from __future__ import annotations

from torch import nn

from ..ops import nn as F

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _reshape_like(pred, label):
    if label.shape != pred.shape:
        return label.reshape(pred.shape)
    return label


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(nn.Module):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_nonbatch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy of `pred` logits against sparse class indices
    (``sparse_label``) or dense label distributions, over `axis`;
    ``from_logits`` takes `pred` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
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
