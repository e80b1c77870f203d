"""Dynamic loss scaler (counterpart of ``mxnet_tpu/amp/loss_scaler.py``;
parity: `python/mxnet/amp/loss_scaler.py`).

With `health` enabled, every scale the scaler settles on (`update_scale`,
`backoff`) goes to the training-health monitor, whose
``loss_scale_collapse`` rule watches it; `recovery.RecoveryPolicy` calls
`backoff` on a tier-1 skip.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    """Dynamic loss scaling with skip-ratio tolerance.

    `tolerance` implements the reference's skip-ratio semantics: on an
    overflow, the scale is only shrunk when the fraction of overflowed
    steps since the last rescale is at least `tolerance` — an isolated
    overflow in an otherwise healthy window just skips that step and
    keeps the scale.  The scale grows by `scale_factor` after
    `scale_window` consecutive overflow-free steps, and never drops below
    1.0.
    """

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.05):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._tolerance = tolerance
        self._iter = 0
        self._last_overflow_iter = -1
        self._last_rescale_iter = -1
        # the iter of the last shrink `update_scale` itself performed
        # (`backoff` does not touch it)
        self._last_loop_shrink_iter = -1
        self._overflows_since_rescale = 0
        # amp.disable()/re-init flips this so Trainers holding a stale
        # reference stop scaling instead of dividing unscaled grads
        self.active = True

    def has_overflow(self, params) -> bool:
        """True if any gradient of `params` (`torch.nn.Parameter`s; one
        without a gradient is skipped) holds inf or NaN, so the step must
        be skipped.

        One device reduction over every gradient -- the largest magnitude
        of each (`torch._foreach_norm` at order inf, in f32: inf or NaN
        exactly when the gradient holds one) -- and one host readback
        (reference: the multi_all_finite kernel)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return False
        peaks = torch._foreach_norm(grads, float("inf"), dtype=torch.float32)
        return not bool(torch.isfinite(torch.stack(peaks)).all())

    def backoff(self, factor=None) -> float:
        """Immediately shrink the scale (floored at 1.0) outside the
        normal per-step `update_scale` cadence — the recovery policy's
        tier-1 remediation — and start a fresh overflow window; returns
        the new scale."""
        f = self._scale_factor if factor is None else factor
        self.loss_scale = max(self.loss_scale / f, 1.0)
        self._last_rescale_iter = self._iter
        self._overflows_since_rescale = 0
        _note_health(self.loss_scale)
        return self.loss_scale

    def update_scale(self, overflow: bool):
        if overflow:
            self._last_overflow_iter = self._iter
            if self._iter == self._last_rescale_iter:
                # this very step already rescaled (`backoff` reacted to the
                # same overflow first): one penalty per step
                pass
            else:
                self._overflows_since_rescale += 1
                since_rescale = self._iter - self._last_rescale_iter
                ratio = self._overflows_since_rescale / \
                    max(since_rescale, 1)
                if ratio >= self._tolerance:
                    self.loss_scale = max(
                        self.loss_scale / self._scale_factor, 1.0)
                    self._last_rescale_iter = self._iter
                    self._last_loop_shrink_iter = self._iter
                    self._overflows_since_rescale = 0
        elif (self._iter - self._last_overflow_iter) % self._scale_window \
                == 0:
            self.loss_scale *= self._scale_factor
            self._last_rescale_iter = self._iter
        self._iter += 1
        _note_health(self.loss_scale)


def _note_health(scale: float) -> None:
    """Hand the scale to the health monitor (one module lookup when
    health is off)."""
    from .. import health as _health
    if _health.enabled():
        mon = _health.monitor()
        if mon is not None:
            mon.note_loss_scale(scale)
