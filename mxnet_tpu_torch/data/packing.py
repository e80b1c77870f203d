"""SequencePacker (counterpart of ``mxnet_tpu/data/packing.py``: the same
rows and carry) — bin-pack variable-length token documents into fixed
``seq_len`` rows with segment ids, per-segment positions, and loss masks.

Transformer training wants rectangle batches; documents are ragged.
Padding each document to ``seq_len`` wastes compute proportional to the
length variance, so the standard fix is to concatenate documents into
rows and mark boundaries with **segment ids** (attention masks segments
apart; this is what `models.gpt` consumes as `segment_ids`) and
**positions** that restart at each boundary.

The packer here is *greedy-sequential and deterministic*: documents are
consumed in stream order, each row is filled left to right, and a
document that does not fit the remaining space either splits across rows
(``split_docs=True``, the LLM-pretraining default — no token is ever
dropped) or closes the row and starts the next (``split_docs=False``;
documents longer than ``seq_len`` are then truncated and counted).
Determinism is the point: the packed stream is a pure function of the
document stream, so the whole transform is checkpointable by carrying a
tiny **carry** (finished-but-unemitted rows + the partial row) in
`PipelineState` — `state()`/`load_state()` round-trip it losslessly and
resume produces bit-identical batches.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as _onp

from ..base import MXNetError

__all__ = ["SequencePacker"]


class _Row:
    __slots__ = ("tokens", "segments", "positions", "mask")

    def __init__(self):
        self.tokens: List[int] = []
        self.segments: List[int] = []
        self.positions: List[int] = []
        self.mask: List[int] = []

    def to_state(self) -> dict:
        # copies, not references: state() snapshots live in the
        # pipeline's ring while this row keeps filling — an aliased list
        # would mutate every past snapshot retroactively and corrupt the
        # checkpointed carry
        return {"tokens": list(self.tokens), "segments": list(self.segments),
                "positions": list(self.positions), "mask": list(self.mask)}

    @classmethod
    def from_state(cls, d: dict) -> "_Row":
        r = cls()
        r.tokens = [int(t) for t in d["tokens"]]
        r.segments = [int(t) for t in d["segments"]]
        r.positions = [int(t) for t in d["positions"]]
        r.mask = [int(t) for t in d["mask"]]
        return r


class SequencePacker:
    def __init__(self, seq_len: int, pad_id: int = 0,
                 split_docs: bool = True):
        if seq_len < 1:
            raise MXNetError(f"seq_len must be >= 1, got {seq_len}")
        self.seq_len = int(seq_len)
        self.pad_id = int(pad_id)
        self.split_docs = bool(split_docs)
        self._ready: List[_Row] = []      # complete rows, FIFO
        self._cur = _Row()                # partial row being filled
        self._cur_seg = 0                 # segments already in _cur
        #: documents truncated (split_docs=False and len > seq_len)
        self.truncated_docs = 0
        #: documents consumed (add() calls with >= 1 token)
        self.docs_consumed = 0

    # -- filling ---------------------------------------------------------
    @property
    def rows_ready(self) -> int:
        return len(self._ready)

    def _close_row(self) -> None:
        row, self._cur, self._cur_seg = self._cur, _Row(), 0
        pad = self.seq_len - len(row.tokens)
        if pad:
            row.tokens.extend([self.pad_id] * pad)
            row.segments.extend([0] * pad)
            row.positions.extend([0] * pad)
            row.mask.extend([0] * pad)
        self._ready.append(row)

    def add(self, tokens) -> int:
        """Feed one document; returns the number of rows COMPLETED by it
        (0 when it only extended the partial row).  Empty documents are
        ignored."""
        toks = [int(t) for t in _onp.asarray(tokens).ravel()]
        if not toks:
            return 0
        self.docs_consumed += 1
        if not self.split_docs and len(toks) > self.seq_len:
            toks = toks[:self.seq_len]
            self.truncated_docs += 1
        completed = 0
        room = self.seq_len - len(self._cur.tokens)
        if not self.split_docs and len(toks) > room:
            self._close_row()            # atomic doc: pad and move on
            completed += 1
        pos = 0
        while toks:
            room = self.seq_len - len(self._cur.tokens)
            take, toks = toks[:room], toks[room:]
            # a new document opens a segment; so does a continuation
            # chunk spilling into a fresh row (segment ids are per-row,
            # 0 is reserved for padding) — positions keep running across
            # the split so the model sees document-level positions
            if pos == 0 or not self._cur.tokens:
                self._cur_seg += 1
            seg = self._cur_seg
            self._cur.tokens.extend(take)
            self._cur.segments.extend([seg] * len(take))
            self._cur.positions.extend(range(pos, pos + len(take)))
            self._cur.mask.extend([1] * len(take))
            pos += len(take)
            if len(self._cur.tokens) == self.seq_len:
                self._close_row()
                completed += 1
        return completed

    def flush(self) -> int:
        """Close the partial row (padded) — end-of-stream only; mid-stream
        flushes would make packing depend on when checkpoints happened."""
        if self._cur.tokens:
            self._close_row()
            return 1
        return 0

    # -- emitting --------------------------------------------------------
    def pop_batch(self, batch_size: int) -> Dict[str, _onp.ndarray]:
        """Emit the oldest `batch_size` complete rows as dense arrays:
        ``tokens``/``segment_ids``/``positions`` int32 ``[B, seq_len]``
        and ``loss_mask`` float32 (1 on real tokens, 0 on padding)."""
        if len(self._ready) < batch_size:
            raise MXNetError(
                f"only {len(self._ready)} packed row(s) ready, "
                f"need {batch_size}; feed more documents (add) first")
        rows, self._ready = self._ready[:batch_size], \
            self._ready[batch_size:]
        return {
            "tokens": _onp.asarray([r.tokens for r in rows],
                                   dtype=_onp.int32),
            "segment_ids": _onp.asarray([r.segments for r in rows],
                                        dtype=_onp.int32),
            "positions": _onp.asarray([r.positions for r in rows],
                                      dtype=_onp.int32),
            "loss_mask": _onp.asarray([r.mask for r in rows],
                                      dtype=_onp.float32),
        }

    # -- checkpoint carry ------------------------------------------------
    def state(self) -> dict:
        """JSON-able carry: complete-but-unemitted rows + the partial row.
        Small by construction (bounded by one batch of rows plus one
        document's spill)."""
        return {
            "ready": [r.to_state() for r in self._ready],
            "cur": self._cur.to_state(),
            "cur_seg": self._cur_seg,
            "truncated_docs": self.truncated_docs,
            "docs_consumed": self.docs_consumed,
        }

    def load_state(self, d: dict) -> None:
        self._ready = [_Row.from_state(r) for r in d.get("ready", [])]
        self._cur = _Row.from_state(
            d.get("cur", {"tokens": [], "segments": [], "positions": [],
                          "mask": []}))
        self._cur_seg = int(d.get("cur_seg", 0))
        self.truncated_docs = int(d.get("truncated_docs", 0))
        self.docs_consumed = int(d.get("docs_consumed", 0))

    def __repr__(self):
        return (f"SequencePacker(seq_len={self.seq_len}, "
                f"split_docs={self.split_docs}, ready={len(self._ready)}, "
                f"partial={len(self._cur.tokens)})")
