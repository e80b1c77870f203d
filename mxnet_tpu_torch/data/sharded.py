"""ShardedRecordDataset — random access over a set of indexed RecordIO
shards, plus the host range used to split each global batch (counterpart
of ``mxnet_tpu/data/sharded.py``; the host count and index come from
``torch.distributed`` where JAX reads its process topology).

Storage parity: the reference's packed datasets are `.rec` files with
`.idx` sidecars (`tools/im2rec`, `python/mxnet/recordio.py`); a large
corpus is a *set* of such shards.  This dataset presents them as one
flat, randomly addressable sequence: ``ds[k]`` bisects the cumulative
record counts, seeks the owning shard through its index, and returns the
decoded record — the storage substrate the pure-function order
(`data.order.EpochOrder`) addresses into.

Readers are opened lazily and per-process (safe under spawned DataLoader
workers), every record read passes the ``data_read`` fault point
(``MXTPU_FAULT_SPEC=data_read@N`` injects a corrupt-read error
deterministically), and per-shard read counters feed the
``data_shard_skew`` gauge the pipeline exports.
"""
from __future__ import annotations

import bisect
import glob as _glob
import os
from typing import Callable, List, Optional, Tuple

import numpy as _onp

from ..base import MXNetError
from ..recordio import MXIndexedRecordIO
from ..resilience import fault_point

__all__ = ["ShardedRecordDataset", "host_range", "host_shard_from_mesh"]


def _default_decode(raw: bytes):
    """Raw record bytes -> int32 token array (the pre-tokenized document
    layout `tools/data_smoke.py` and `bench.py --data` write).  Override
    `decode=` for image records (`recordio.unpack` / `unpack_img`)."""
    return _onp.frombuffer(raw, dtype=_onp.int32)


class ShardedRecordDataset:
    """Flat random-access view over indexed RecordIO shards.

    `shards`: explicit ``[(idx_path, rec_path), ...]``, or a glob over
    ``.rec`` files (each must have a ``.idx`` sidecar next to it).  Shard
    order is sorted-by-path and is part of the dataset's identity: the
    global order function addresses *positions*, so hosts must agree on
    the shard list (they do — same glob, same sort).
    """

    def __init__(self, shards, decode: Optional[Callable] = None,
                 key_type=int):
        if isinstance(shards, str):
            recs = sorted(_glob.glob(shards))
            if not recs:
                raise MXNetError(f"no record shards match {shards!r}")
            pairs = []
            for rec in recs:
                idx = os.path.splitext(rec)[0] + ".idx"
                if not os.path.isfile(idx):
                    raise MXNetError(f"shard {rec} has no index sidecar "
                                     f"{idx} (write with MXIndexedRecordIO "
                                     "or tools/im2rec.py)")
                pairs.append((idx, rec))
        else:
            pairs = [tuple(p) for p in shards]
            if not pairs:
                raise MXNetError("ShardedRecordDataset needs >= 1 shard")
        self._shards: List[Tuple[str, str]] = pairs
        self._decode = decode or _default_decode
        self._key_type = key_type
        # record keys per shard come from the .idx sidecar (cheap text
        # read, no record I/O); cumulative counts give O(log S) lookup
        self._keys: List[list] = []
        self._cum: List[int] = []
        total = 0
        for idx_path, rec_path in self._shards:
            keys = self._read_index_keys(idx_path)
            if not keys:
                raise MXNetError(f"shard index {idx_path} is empty")
            self._keys.append(keys)
            total += len(keys)
            self._cum.append(total)
        self._readers: List[Optional[MXIndexedRecordIO]] = \
            [None] * len(self._shards)
        self._pid = os.getpid()
        #: per-shard record reads since construction (feeds the pipeline's
        #: ``data_shard_skew`` gauge; resettable via `reset_read_counts`)
        self.read_counts = [0] * len(self._shards)

    def _read_index_keys(self, idx_path: str) -> list:
        keys = []
        with open(idx_path) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) >= 2:
                    keys.append(self._key_type(parts[0]))
        return keys

    # -- layout ----------------------------------------------------------
    def __len__(self) -> int:
        return self._cum[-1]

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def shard_of(self, index: int) -> int:
        """Shard id owning flat position `index`."""
        if not 0 <= index < len(self):
            raise IndexError(f"index {index} out of range [0, {len(self)})")
        return bisect.bisect_right(self._cum, index)

    def reset_read_counts(self) -> None:
        self.read_counts = [0] * len(self._shards)

    # -- access ----------------------------------------------------------
    def _reader(self, shard: int) -> MXIndexedRecordIO:
        # lazy + per-process: a spawned worker inherits the shard list but
        # must never inherit a parent's file handle (shared seek cursor)
        if os.getpid() != self._pid:
            self._readers = [None] * len(self._shards)
            self._pid = os.getpid()
        r = self._readers[shard]
        if r is None:
            idx_path, rec_path = self._shards[shard]
            r = MXIndexedRecordIO(idx_path, rec_path, "r",
                                  key_type=self._key_type)
            self._readers[shard] = r
        return r

    def read_raw(self, index: int) -> bytes:
        """Undecoded record bytes at flat position `index`."""
        shard = self.shard_of(index)
        local = index - (self._cum[shard - 1] if shard else 0)
        fault_point("data_read")
        raw = self._reader(shard).read_idx(self._keys[shard][local])
        if raw is None:
            raise MXNetError(
                f"shard {self._shards[shard][1]} returned no record for "
                f"key {self._keys[shard][local]!r} (truncated shard? "
                "stale .idx sidecar?)")
        self.read_counts[shard] += 1
        return raw

    def __getitem__(self, index: int):
        return self._decode(self.read_raw(index))

    def close(self) -> None:
        for i, r in enumerate(self._readers):
            if r is not None:
                r.close()
                self._readers[i] = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __repr__(self):
        return (f"ShardedRecordDataset({len(self._shards)} shards, "
                f"{len(self)} records)")


# ---------------------------------------------------------------------------
# host range sharding
# ---------------------------------------------------------------------------

def host_range(batch_size: int, num_hosts: int,
               host_id: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of every global batch that host `host_id` of
    `num_hosts` reads.  Contiguous ranges (not strides) so each host's
    slice lands on its local `dp` shard without a permute, and so a
    shrink/grow reform only moves range *boundaries*: positions are
    global, every global batch is partitioned whatever `num_hosts` is,
    which is the exactly-once argument in docs/data.md."""
    if num_hosts < 1:
        raise MXNetError(f"num_hosts must be >= 1, got {num_hosts}")
    if not 0 <= host_id < num_hosts:
        raise MXNetError(f"host_id {host_id} out of range [0, {num_hosts})")
    if batch_size % num_hosts:
        raise MXNetError(
            f"global batch size {batch_size} must divide evenly over "
            f"{num_hosts} host(s) — pad the batch or change the mesh")
    per = batch_size // num_hosts
    return host_id * per, (host_id + 1) * per


def host_shard_from_mesh(mesh=None) -> Tuple[int, int]:
    """``(num_hosts, host_id)`` for the data pipeline: the world size and
    rank of the initialised ``torch.distributed`` group (the processes
    that must read distinct batch ranges), else ``(1, 0)`` — the
    counterpart of JAX's ``(jax.process_count(), jax.process_index())``.
    A `mesh` (JAX derives the hosts from its ``dp`` axis) raises: device
    meshes are not ported yet (ROADMAP.md A12)."""
    if mesh is not None:
        raise MXNetError(
            "host_shard_from_mesh(mesh=...): device meshes are not ported "
            "yet (ROADMAP.md A12); pass num_hosts/host_id, or leave both "
            "unset to read the torch.distributed group")
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0
