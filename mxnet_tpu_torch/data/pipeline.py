"""DataPipeline + PipelineState — the checkpointable, elastic-aware input
stream whose order is a pure function of ``(seed, epoch, offset)``
(counterpart of ``mxnet_tpu/data/pipeline.py``: the same batches, the same
``state()`` JSON, so a state written by either package seeks the other).

Everything in this package converges here.  The pipeline walks a single
**global** sample-position axis ``p = 0, 1, 2, ...``; what sample lives
at position ``p`` is decided by pure functions (`order.EpochOrder` for a
plain dataset, the deterministic least-served rule + per-child orders for
a `MixtureDataset`), so the stream's future depends only on a tiny
explicit state — never on process history:

* **seek is O(1)**: `PipelineState` (epoch, offset, rng key, mixture
  counters, packer carry) is a few hundred bytes; `load_state` assigns it
  and the next batch is bit-identical to what an uninterrupted run would
  have produced.  This replaces the O(n) ``prefetcher.skip()`` replay the
  recovery/preemption/elastic paths used before.
* **hosts are views, not owners**: host `h` of `H` reads rows
  ``[h*B/H, (h+1)*B/H)`` of every global batch (`sharded.host_range`,
  derived from the ``torch.distributed`` group).  The global stream is identical on
  every host, so an elastic shrink/grow merely re-slices it — every
  global position is delivered by exactly one host before AND after a
  reform (docs/data.md has the argument).
* **prefetch-safe checkpoints**: a `DevicePrefetcher` pulls batches ahead
  of the consumer, so "current state" at checkpoint time is ahead of the
  training loop.  The pipeline keeps a small ring of per-batch state
  snapshots; ``state_at(batch_seq)`` returns the state as of the batch
  the *consumer* last used, which is what `CheckpointManager` stores
  (`attach_pipeline`).

Telemetry (`MXTPU_TELEMETRY`): ``data_wait_ms`` (host time building each
batch), ``data_samples_total`` / ``data_batches_total``,
``data_samples_per_sec`` gauge, ``data_shard_skew`` gauge (relative
spread of per-shard read counts), ``data_mixture_samples`` per-child
counter.  Record reads pass the ``data_read`` fault point (in
`ShardedRecordDataset`).
"""
from __future__ import annotations

import collections
import logging
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as _onp

from .. import telemetry as _tele
from .. import tracing as _trace
from ..base import MXNetError
from .mixture import MixtureDataset
from .order import EpochOrder, mix64
from .packing import SequencePacker
from .sharded import host_range, host_shard_from_mesh

__all__ = ["DataPipeline", "PipelineState", "default_data_seed"]

_log = logging.getLogger(__name__)

ENV_SEED = "MXTPU_DATA_SEED"
ENV_STATE_RING = "MXTPU_DATA_STATE_RING"
STATE_VERSION = 1


def default_data_seed() -> int:
    """Pipeline seed: ``MXTPU_DATA_SEED``, else 0 — deterministic and
    identical on every host by default (an unseeded pipeline is exactly
    the bug this package exists to kill)."""
    try:
        return int(os.environ.get(ENV_SEED, "0"))
    except ValueError:
        return 0


def _default_state_ring() -> int:
    try:
        n = int(os.environ.get(ENV_STATE_RING, "128"))
    except ValueError:
        n = 128
    return max(8, n)


class PipelineState:
    """One resumable position of a `DataPipeline` — everything the stream's
    future depends on, as plain JSON-able data (it is embedded verbatim in
    `CheckpointManager` manifests):

    ==============  =====================================================
    ``epoch``       completed passes over the (plain) dataset at this
                    position; always 0 for unbounded mixture streams
    ``offset``      sample position within the epoch (plain) / the global
                    sample position (mixture)
    ``position``    absolute global sample position (``epoch * len +
                    offset`` for plain sources) — the seek axis
    ``batch``       global batches delivered (aligns 1:1 with training
                    steps when one step consumes one batch)
    ``rng``         derived 64-bit key for the position (forward-compat
                    hook for stochastic transforms; pure fn of
                    seed/epoch/offset, never stored entropy)
    ``mixture``     per-child served counts (None without a mixture)
    ``packer``      `SequencePacker` carry (None without packing)
    ==============  =====================================================
    """

    __slots__ = ("version", "seed", "position", "epoch", "offset",
                 "batch", "rng", "mixture", "packer", "batch_size",
                 "seq_len")

    def __init__(self, seed: int, position: int = 0, epoch: int = 0,
                 offset: int = 0, batch: int = 0,
                 mixture: Optional[List[int]] = None,
                 packer: Optional[dict] = None,
                 version: int = STATE_VERSION, rng: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 seq_len: Optional[int] = None):
        self.version = int(version)
        self.seed = int(seed)
        self.position = int(position)
        self.epoch = int(epoch)
        self.offset = int(offset)
        self.batch = int(batch)
        self.rng = (mix64(mix64(seed) ^ position) if rng is None
                    else int(rng))
        self.mixture = list(mixture) if mixture is not None else None
        self.packer = dict(packer) if packer is not None else None
        # stream-shape identity: batch counts and packer carries are
        # only meaningful under the batch/row geometry they were
        # written with — load_state refuses a mismatch
        self.batch_size = None if batch_size is None else int(batch_size)
        self.seq_len = None if seq_len is None else int(seq_len)

    def to_dict(self) -> dict:
        return {"version": self.version, "seed": self.seed,
                "position": self.position, "epoch": self.epoch,
                "offset": self.offset, "batch": self.batch,
                "rng": self.rng, "mixture": self.mixture,
                "packer": self.packer, "batch_size": self.batch_size,
                "seq_len": self.seq_len}

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        if int(d.get("version", 1)) > STATE_VERSION:
            raise MXNetError(
                f"PipelineState version {d.get('version')} is newer than "
                f"this build understands ({STATE_VERSION}); upgrade, or "
                "restart the data stream from scratch")
        return cls(seed=d["seed"], position=d.get("position", 0),
                   epoch=d.get("epoch", 0), offset=d.get("offset", 0),
                   batch=d.get("batch", 0), mixture=d.get("mixture"),
                   packer=d.get("packer"), version=d.get("version", 1),
                   rng=d.get("rng"), batch_size=d.get("batch_size"),
                   seq_len=d.get("seq_len"))

    def __repr__(self):
        return (f"PipelineState(batch={self.batch}, epoch={self.epoch}, "
                f"offset={self.offset}, position={self.position})")


class DataPipeline:
    """Deterministic batched stream over a dataset or `MixtureDataset`.

    `source`: anything with ``__getitem__``/``__len__`` (canonically
    `ShardedRecordDataset`) — shuffled through its own `EpochOrder` — or
    a `MixtureDataset` (each child shuffles independently; the interleave
    is the deterministic least-served schedule).

    `batch_size` is **global** (all hosts); this host materializes only
    its `host_range` rows — pass ``num_hosts``/``host_id`` explicitly
    (virtual hosts, tests) or let them derive from the
    ``torch.distributed`` group (`host_shard_from_mesh`; ``mesh=`` raises
    naming ROADMAP.md A12: device meshes are not ported yet).  With
    ``seq_len`` set, documents are packed into fixed rows by a
    `SequencePacker` first; packing consumes the global
    document stream on every host (selection is global state), so packed
    mode trades duplicated *decode* work for exactness — see
    docs/data.md.

    Iterate for host batches; `state_at`/`load_state` checkpoint and
    O(1)-seek the stream; `set_hosts` re-derives this host's view after
    an elastic reform without touching the global order.
    """

    def __init__(self, source, batch_size: int,
                 seed: Optional[int] = None,
                 seq_len: Optional[int] = None, pad_id: int = 0,
                 split_docs: bool = True,
                 num_hosts: Optional[int] = None,
                 host_id: Optional[int] = None, mesh=None,
                 window: Optional[int] = None, shuffle: bool = True,
                 batchify: Optional[Callable] = None,
                 state_ring: Optional[int] = None):
        if batch_size < 1:
            raise MXNetError(f"batch_size must be >= 1, got {batch_size}")
        if mesh is not None:
            raise MXNetError(
                "DataPipeline(mesh=...): device meshes are not ported yet "
                "(ROADMAP.md A12); pass num_hosts/host_id, or leave both "
                "unset to read the torch.distributed group")
        self.source = source
        self.batch_size = int(batch_size)
        self.seed = default_data_seed() if seed is None else int(seed)
        self._mixture = source if isinstance(source, MixtureDataset) else None
        if self._mixture is None:
            n = len(source)
            if n < 1:
                raise MXNetError("source dataset is empty")
            self._order = (EpochOrder(n, self.seed, window=window)
                           if shuffle else None)
            self._length = n
        else:
            self._order = None
            self._length = None          # unbounded interleave
        self._packer = (SequencePacker(seq_len, pad_id=pad_id,
                                       split_docs=split_docs)
                        if seq_len else None)
        self._batchify = batchify
        if num_hosts is None or host_id is None:
            try:
                num_hosts, host_id = host_shard_from_mesh()
            except Exception as e:
                # a torch.distributed query that fails lands here; on a
                # REAL multi-host job a silent (1, 0) would make this host
                # read every row — duplicate delivery across the fleet —
                # so say it loudly
                _log.warning(
                    "DataPipeline: could not derive the host shard from "
                    "the process group (%s); defaulting to a "
                    "single-host view (1, 0) — pass num_hosts/host_id "
                    "explicitly on multi-host jobs", e)
                num_hosts, host_id = 1, 0
        self.set_hosts(num_hosts, host_id)
        # mutable stream state (exactly what PipelineState captures)
        self._position = 0               # global samples consumed
        self._batch_seq = 0              # global batches delivered
        self._served = (self._mixture.init_counters()
                        if self._mixture is not None else None)
        ring = _default_state_ring() if state_ring is None else \
            max(8, int(state_ring))
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._ring.append((0, self._snapshot()))
        # stats
        self._wait_s = 0.0
        self._host_samples = 0
        self._t_start = time.perf_counter()

    # -- host view -------------------------------------------------------
    def set_hosts(self, num_hosts: int, host_id: int) -> None:
        """(Re-)derive this host's row range of every global batch — the
        elastic reform hook.  Pure view change: global state (position,
        counters, carry) is untouched, so calling this on every surviving
        host after a shrink/grow keeps exactly-once delivery (the ranges
        re-partition every future batch)."""
        lo, hi = host_range(self.batch_size, num_hosts, host_id)
        self.num_hosts = int(num_hosts)
        self.host_id = int(host_id)
        self._row_lo, self._row_hi = lo, hi
        if _tele.enabled():
            _tele.event("data_set_hosts", num_hosts=num_hosts,
                        host_id=host_id, rows=[lo, hi])

    @property
    def host_rows(self) -> Tuple[int, int]:
        return self._row_lo, self._row_hi

    # -- the order function ---------------------------------------------
    def _locate(self, p: int) -> Tuple[Optional[int], int]:
        """(child, dataset index) holding global position `p`.  For plain
        sources child is None and the index comes from the epoch
        permutation; for mixtures the child comes from the least-served
        schedule and ITS served-count drives the child's own order.
        Mixture calls mutate ``self._served`` — call in position order."""
        if self._mixture is None:
            epoch, offset = divmod(p, self._length)
            idx = (self._order.index(epoch, offset)
                   if self._order is not None else offset)
            return None, idx
        child = self._mixture.select(p, self._served)
        _, idx = self._mixture.locate(child, self._served[child])
        self._served[child] += 1
        return child, idx

    def _read(self, child: Optional[int], idx: int):
        if child is None:
            return self.source[idx]
        return self._mixture.read(child, idx)

    # -- iteration -------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        if self._packer is not None:
            batch = self._next_packed()
        else:
            batch = self._next_plain()
        self._batch_seq += 1
        self._ring.append((self._batch_seq, self._snapshot()))
        wait = time.perf_counter() - t0
        if _trace.enabled():
            _trace.get_tracer("data").record_span(
                "data.batch", t0, time.perf_counter(),
                track="data pipeline", batch=self._batch_seq,
                position=self._position)
        self._wait_s += wait
        rows = self._row_hi - self._row_lo
        self._host_samples += rows
        if _tele.enabled():
            _tele.histogram(
                "data_wait_ms",
                "Host time building each data batch (ms); sustained "
                "values near the step time mean the input pipeline is "
                "the bottleneck").observe(wait * 1e3)
            _tele.counter(
                "data_batches_total",
                "Global batches delivered by the data pipeline").inc()
            _tele.counter(
                "data_samples_total",
                "Host-local samples delivered").inc(rows)
            elapsed = time.perf_counter() - self._t_start
            if elapsed > 0:
                _tele.gauge(
                    "data_samples_per_sec",
                    "Host-local sample throughput since pipeline start"
                ).set(round(self._host_samples / elapsed, 3))
            self._note_skew()
        return batch

    def _next_plain(self):
        rows = []
        base = self._position
        if self._mixture is None:
            # pure order function, no counters to advance: touch only
            # this host's rows (H hosts do B/H lookups each, not B)
            for j in range(self._row_lo, self._row_hi):
                child, idx = self._locate(base + j)
                rows.append(self._read(child, idx))
        else:
            # the least-served schedule mutates the counters for EVERY
            # global position, so the walk must cover the full batch;
            # only this host's rows do I/O
            for j in range(self.batch_size):
                child, idx = self._locate(base + j)
                if self._row_lo <= j < self._row_hi:
                    rows.append(self._read(child, idx))
                    if _tele.enabled():
                        _tele.counter(
                            "data_mixture_samples",
                            "Samples delivered per mixture child",
                            labelnames=("child",)).inc(child=str(child))
        self._position = base + self.batch_size
        if self._batchify is not None:
            return self._batchify(rows)
        try:
            return _onp.stack([_onp.asarray(r) for r in rows])
        except ValueError:
            return rows                  # ragged: hand rows through as-is

    def _next_packed(self):
        # fill to a full GLOBAL batch of rows: packing consumes the global
        # document stream (the least-served schedule + carry are global
        # state), then this host keeps only its row range
        while self._packer.rows_ready < self.batch_size:
            child, idx = self._locate(self._position)
            self._position += 1
            self._packer.add(self._read(child, idx))
            if child is not None and _tele.enabled():
                _tele.counter(
                    "data_mixture_samples",
                    "Samples delivered per mixture child",
                    labelnames=("child",)).inc(child=str(child))
        full = self._packer.pop_batch(self.batch_size)
        return {k: v[self._row_lo:self._row_hi] for k, v in full.items()}

    def skip_batches(self, n: int = 1) -> None:
        """Advance past `n` global batches without delivering them — the
        poison-window fast-forward after a rollback.  Plain sources
        advance in O(1) (mixtures walk the selection schedule, no I/O);
        packed streams must still read documents to learn where batch
        boundaries fall."""
        for _ in range(int(n)):
            if self._packer is not None:
                self._next_packed()
            elif self._mixture is not None:
                base = self._position
                for j in range(self.batch_size):
                    self._locate(base + j)      # counters advance, no I/O
                self._position = base + self.batch_size
            else:
                self._position += self.batch_size
            self._batch_seq += 1
            self._ring.append((self._batch_seq, self._snapshot()))
        if _tele.enabled():
            _tele.counter(
                "data_skipped_batches",
                "Global batches fast-forwarded past (poison window, "
                "manual seek)").inc(int(n))

    # -- state -----------------------------------------------------------
    def _snapshot(self) -> dict:
        if self._mixture is None:
            epoch, offset = divmod(self._position, self._length)
        else:
            epoch, offset = 0, self._position
        return PipelineState(
            seed=self.seed, position=self._position, epoch=epoch,
            offset=offset, batch=self._batch_seq,
            mixture=self._served,
            packer=self._packer.state() if self._packer is not None
            else None,
            batch_size=self.batch_size,
            seq_len=(self._packer.seq_len if self._packer is not None
                     else None)).to_dict()

    def state(self) -> dict:
        """State as of the NEWEST delivered batch (JSON-able)."""
        return self._ring[-1][1]

    def state_at(self, batch_seq: int) -> Optional[dict]:
        """State as of delivered batch `batch_seq` (0 = pristine/seek
        point), or None when it has aged out of the ring.  This is what
        a checkpoint at training step ``batch_seq`` must store when a
        prefetcher runs ahead of the consumer (`CheckpointManager`
        resolves it through `attach_pipeline`)."""
        for seq, snap in reversed(self._ring):
            if seq == int(batch_seq):
                return snap
        return None

    def load_state(self, d: dict) -> None:
        """O(1) seek: adopt `d` (a `state()`/`state_at` dict, normally
        out of a checkpoint manifest) as the current position.  The next
        delivered batch is bit-identical to the one an uninterrupted run
        would have produced after that state's batch."""
        st = PipelineState.from_dict(d if isinstance(d, dict)
                                     else d.to_dict())
        if st.seed != self.seed:
            raise MXNetError(
                f"checkpointed data state was written with seed "
                f"{st.seed}, pipeline runs seed {self.seed}: refusing to "
                "resume a DIFFERENT stream as if it were this one (pass "
                "the original seed, or start fresh deliberately)")
        if (st.mixture is None) != (self._served is None) or (
                st.mixture is not None and self._served is not None
                and len(st.mixture) != len(self._served)):
            raise MXNetError(
                "checkpointed data state does not match the pipeline "
                "shape (mixture children changed?)")
        if (st.packer is None) != (self._packer is None):
            raise MXNetError(
                "checkpointed data state does not match the pipeline "
                "shape (packing on one side only)")
        if st.batch_size is not None and st.batch_size != self.batch_size:
            raise MXNetError(
                f"checkpointed data state was written with global "
                f"batch_size {st.batch_size}, pipeline runs "
                f"{self.batch_size}: the batch counter and host ranges "
                "would desync — resume with the original geometry")
        if st.seq_len is not None and self._packer is not None and \
                st.seq_len != self._packer.seq_len:
            raise MXNetError(
                f"checkpointed packer carry was written with seq_len "
                f"{st.seq_len}, pipeline packs to {self._packer.seq_len}: "
                "carried rows would be mis-shaped — resume with the "
                "original seq_len")
        self._position = st.position
        self._batch_seq = st.batch
        if self._served is not None:
            self._served = list(st.mixture)
        if self._packer is not None:
            self._packer.load_state(st.packer)
        self._ring.clear()
        self._ring.append((self._batch_seq, self._snapshot()))
        if _tele.enabled():
            _tele.event("data_seek", batch=st.batch, position=st.position,
                        epoch=st.epoch, offset=st.offset)

    # -- misc ------------------------------------------------------------
    def _note_skew(self) -> None:
        counts = getattr(self.source, "read_counts", None)
        if counts is None and self._mixture is not None:
            merged: List[int] = []
            for c in self._mixture.children:
                merged.extend(getattr(c, "read_counts", []) or [])
            counts = merged or None
        if counts and len(counts) > 1 and sum(counts):
            mean = sum(counts) / len(counts)
            skew = (max(counts) - min(counts)) / max(mean, 1e-9)
            _tele.gauge(
                "data_shard_skew",
                "(max - min) / mean of per-shard record reads; sustained "
                "growth means one shard is hot (bad shard sizing or a "
                "stuck sibling host)").set(round(skew, 4))

    def stats(self) -> dict:
        n = max(1, self._batch_seq)
        elapsed = max(1e-9, time.perf_counter() - self._t_start)
        return {
            "batches": self._batch_seq,
            "position": self._position,
            "host_samples": self._host_samples,
            "mean_wait_ms": round(self._wait_s * 1e3 / n, 3),
            "samples_per_sec": round(self._host_samples / elapsed, 3),
            "hosts": [self.num_hosts, self.host_id],
        }

    def close(self) -> None:
        close = getattr(self.source, "close", None)
        if callable(close):
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        kind = ("mixture" if self._mixture is not None else "dataset")
        return (f"DataPipeline({kind}, batch={self.batch_size}, "
                f"host {self.host_id}/{self.num_hosts}, "
                f"at batch {self._batch_seq})")
