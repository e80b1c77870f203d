"""MixtureDataset — deterministic weighted interleave of several corpora
(counterpart of ``mxnet_tpu/data/mixture.py``: the same schedule).

LLM pretraining mixes corpora at fixed ratios (PAPERS.md's data-pipeline
lineage; the reference had no analog).  The usual implementation samples a
child per step from an RNG stream, which makes the schedule a function of
*draw history* — unresumable without replay, and divergent across hosts
the moment one of them draws out of turn.

Here the schedule is the deterministic **least-served** rule: at global
sample position ``p``, pick the child with the largest deficit
``weights[k] * (p + 1) - served[k]`` (ties to the lowest child id).  The
choice depends only on ``(p, served)``, so:

* the realized ratio tracks `weights` with bounded error (<1 sample per
  child at every prefix — better than any RNG draw),
* the full schedule is reproducible from a checkpointed ``served``
  counter vector (the ``mixture counters`` in `PipelineState`) in O(1) —
  no replay,
* every host computes the identical schedule from the identical state,
  which the elastic exactly-once argument requires.

Each child's own sample order is its private `EpochOrder` (seed folded
with the child id); a child that exhausts an epoch rolls into its next
epoch independently of its siblings, so the mixture stream is unbounded.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..base import MXNetError
from .order import EpochOrder, mix64

__all__ = ["MixtureDataset"]


class MixtureDataset:
    """Stateless mixture *engine*: all mutable progress lives in the
    counters vector the caller (normally `DataPipeline`) owns and
    checkpoints.  ``select`` is the pure scheduling rule; ``locate``
    turns a child's served-count into its (epoch, dataset index) through
    the child's `EpochOrder`; ``read`` does the I/O."""

    def __init__(self, children: Sequence, weights: Optional[Sequence[float]] = None,
                 seed: int = 0, window: Optional[int] = None,
                 shuffle: bool = True):
        if not children:
            raise MXNetError("MixtureDataset needs >= 1 child dataset")
        self.children = list(children)
        k = len(self.children)
        if weights is None:
            weights = [1.0] * k
        if len(weights) != k:
            raise MXNetError(f"{k} children but {len(weights)} weights")
        if any(w <= 0 for w in weights):
            raise MXNetError("mixture weights must all be > 0")
        total = float(sum(weights))
        self.weights: Tuple[float, ...] = tuple(w / total for w in weights)
        self.seed = int(seed)
        # per-child pure-function orders; a child with shuffle off (eval
        # sets) reads sequentially but still epoch-wraps
        self._orders: List[Optional[EpochOrder]] = [
            EpochOrder(len(c), mix64(self.seed ^ (0xC0FFEE + i)),
                       window=window) if shuffle else None
            for i, c in enumerate(self.children)]

    @property
    def num_children(self) -> int:
        return len(self.children)

    def init_counters(self) -> List[int]:
        """Fresh served-count vector (position 0 of the schedule)."""
        return [0] * len(self.children)

    # -- the schedule ----------------------------------------------------
    def select(self, pos: int, served: Sequence[int]) -> int:
        """Child id scheduled at global position `pos` given the served
        counts BEFORE this position.  Pure; the caller increments
        ``served[child]`` after consuming the sample."""
        best, best_deficit = 0, None
        target = pos + 1
        for k, w in enumerate(self.weights):
            deficit = w * target - served[k]
            if best_deficit is None or deficit > best_deficit + 1e-12:
                best, best_deficit = k, deficit
        return best

    def locate(self, child: int, count: int) -> Tuple[int, int]:
        """(child_epoch, dataset_index) of the `count`-th sample drawn
        from `child` — its served count at draw time."""
        n = len(self.children[child])
        epoch, offset = divmod(count, n)
        order = self._orders[child]
        index = order.index(epoch, offset) if order is not None else offset
        return epoch, index

    def read(self, child: int, index: int):
        return self.children[child][index]

    def close(self) -> None:
        for c in self.children:
            close = getattr(c, "close", None)
            if callable(close):
                close()

    def __repr__(self):
        return (f"MixtureDataset({len(self.children)} children, "
                f"weights={tuple(round(w, 4) for w in self.weights)})")
