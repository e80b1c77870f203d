"""Pure-function sample order: an O(1) random-access epoch permutation
(counterpart of ``mxnet_tpu/data/order.py``: the same integer arithmetic,
so both packages give the same indices, bit for bit).

The reference shuffles by materializing and permuting an index vector per
epoch (`src/io/iter_image_recordio_2.cc` shuffle_, and the Python
`RandomSampler`).  That order lives only in process memory: it cannot be
checkpointed cheaply, cannot be recomputed by another host, and after a
restore the only way back to "where we were" is to replay it.  Here the
epoch order is a **keyed bijection** computed per lookup:

    global_index = EpochOrder(length, seed).index(epoch, offset)

so any host, at any time, can ask "what is the k-th sample of epoch e?"
in O(1) with zero materialized state — the property every other piece of
`mxnet_tpu_torch.data` (seekable checkpoints, elastic host re-sharding,
exactly-once reforms) is built on.

Construction: a 4-round Feistel network over the smallest even-bit binary
domain covering the range, cycle-walking out-of-range values back in
(format-preserving encryption, the standard trick for a keyed permutation
of an arbitrary-size set).  Expected walks per lookup < 4; worst-case
domain is < 8x the range, so lookups stay O(1) amortized.

Shuffle quality vs I/O locality is the **window** composition (the
reference's `shuffle_chunk_size` had the same role): positions are mapped
through a permutation of fixed-size windows and then a permutation within
the window, both Feistel-keyed by ``(seed, epoch)``.  Sequential
consumers therefore touch one `window`-sized region of the (usually
disk-backed) dataset at a time instead of seeking uniformly across all
shards, while across epochs every (window-order x in-window) composition
differs.  ``window >= length`` (or ``MXTPU_DATA_WINDOW=0``) degrades to a
single full-range permutation.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["EpochOrder", "default_window", "mix64"]

ENV_WINDOW = "MXTPU_DATA_WINDOW"
DEFAULT_WINDOW = 4096

_M64 = (1 << 64) - 1


def default_window() -> int:
    """Shuffle window size: ``MXTPU_DATA_WINDOW`` (0 = full-range
    permutation, no windowing), else 4096."""
    try:
        w = int(os.environ.get(ENV_WINDOW, str(DEFAULT_WINDOW)))
    except ValueError:
        w = DEFAULT_WINDOW
    return max(0, w)


def mix64(x: int) -> int:
    """SplitMix64 finalizer — the keyed hash behind every derivation in
    this package (stable across processes and Python versions, unlike
    `hash()`)."""
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _derive(*parts: int) -> int:
    """Fold ints into one 64-bit key (order-sensitive)."""
    k = 0x9E3779B97F4A7C15
    for p in parts:
        k = mix64(k ^ mix64(int(p) & _M64))
    return k


class _FeistelPerm:
    """Keyed bijection of ``[0, n)``: 4-round balanced Feistel over the
    smallest even-bit domain >= n, cycle-walking back into range.  Both
    directions are O(1) amortized; `inv` decrypts with the rounds
    reversed (needed once per epoch to locate the short window)."""

    __slots__ = ("n", "half", "mask", "keys")

    def __init__(self, n: int, key: int):
        if n < 1:
            raise ValueError(f"permutation domain must be >= 1, got {n}")
        self.n = n
        bits = max(2, (n - 1).bit_length())
        bits += bits & 1               # balanced halves need even width
        self.half = bits // 2
        self.mask = (1 << self.half) - 1
        self.keys = tuple(_derive(key, r) for r in range(4))

    def _encrypt(self, i: int) -> int:
        left, right = i >> self.half, i & self.mask
        for k in self.keys:
            left, right = right, left ^ (mix64(right ^ k) & self.mask)
        return (left << self.half) | right

    def _decrypt(self, i: int) -> int:
        left, right = i >> self.half, i & self.mask
        for k in reversed(self.keys):
            left, right = right ^ (mix64(left ^ k) & self.mask), left
        return (left << self.half) | right

    def __call__(self, i: int) -> int:
        if not 0 <= i < self.n:
            raise IndexError(f"index {i} out of range [0, {self.n})")
        i = self._encrypt(i)
        while i >= self.n:             # cycle-walk: E is a bijection on
            i = self._encrypt(i)       # the binary domain, so walking
        return i                       # re-enters [0, n) in < dom/n steps

    def inv(self, i: int) -> int:
        if not 0 <= i < self.n:
            raise IndexError(f"index {i} out of range [0, {self.n})")
        i = self._decrypt(i)
        while i >= self.n:
            i = self._decrypt(i)
        return i


class EpochOrder:
    """``index(epoch, offset) -> dataset index``: the whole training
    run's sample order as a pure function of ``(seed, epoch, offset)``.

    Bijective per epoch (every dataset index appears exactly once as
    `offset` sweeps ``[0, length)``), O(1) per lookup, no materialized
    index — see the module docstring for the window construction.  All
    derived keys fold in `seed` and `epoch`, so two epochs share neither
    window order nor in-window order.
    """

    def __init__(self, length: int, seed: int,
                 window: Optional[int] = None):
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        self.length = int(length)
        self.seed = int(seed)
        w = default_window() if window is None else int(window)
        if w <= 0 or w >= length:
            w = length                 # single full-range window
        self.window = w
        self.num_windows = -(-length // w)          # ceil
        self.short_size = length - (self.num_windows - 1) * w
        # per-epoch caches (tiny): the window permutation + the rank the
        # short (last, possibly partial) window landed at, and the most
        # recent in-window permutation — sequential consumers stay inside
        # one window for `window` lookups at a time
        self._epoch = None
        self._wperm: Optional[_FeistelPerm] = None
        self._short_rank = 0
        self._iperm_key = None
        self._iperm: Optional[_FeistelPerm] = None

    def _for_epoch(self, epoch: int) -> None:
        if epoch == self._epoch:
            return
        self._epoch = epoch
        self._wperm = _FeistelPerm(self.num_windows,
                                   _derive(self.seed, epoch, 0x57))
        # rank at which window id nw-1 (the only short one) is visited:
        # every rank before it spans `window` positions, ranks after it
        # start `window - short_size` earlier
        self._short_rank = self._wperm.inv(self.num_windows - 1)
        self._iperm_key = None
        self._iperm = None

    def _in_window(self, epoch: int, wid: int, size: int) -> _FeistelPerm:
        key = (epoch, wid)
        if key != self._iperm_key:
            self._iperm_key = key
            self._iperm = _FeistelPerm(size,
                                       _derive(self.seed, epoch, 1 + wid))
        return self._iperm

    def index(self, epoch: int, offset: int) -> int:
        """Dataset index of the `offset`-th sample of epoch `epoch`."""
        n, w = self.length, self.window
        if not 0 <= offset < n:
            raise IndexError(f"offset {offset} out of range [0, {n})")
        self._for_epoch(int(epoch))
        short_start = self._short_rank * w
        if offset < short_start:
            rank, within = divmod(offset, w)
        elif offset < short_start + self.short_size:
            rank, within = self._short_rank, offset - short_start
        else:
            past = offset - short_start - self.short_size
            rank, within = divmod(past, w)
            rank += self._short_rank + 1
        wid = self._wperm(rank)
        size = self.short_size if wid == self.num_windows - 1 else w
        return wid * w + self._in_window(int(epoch), wid, size)(within)

    def __repr__(self):
        return (f"EpochOrder(length={self.length}, seed={self.seed}, "
                f"window={self.window})")
