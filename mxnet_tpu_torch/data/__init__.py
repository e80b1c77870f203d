"""The port's input pipeline (counterpart of ``mxnet_tpu/data/``: the same
names, batches and checkpoint state; capability parity with the
reference's `src/io/` RecordIO DataIters + prefetcher, rebuilt around one
idea the reference never had: **the sample order is a pure function of
(seed, epoch, offset)**, so the data stream is checkpointable in O(1),
reproducible on any host, and re-shardable by an elastic reform without
losing or duplicating a sample.  See docs/data.md.

Layers (each usable alone):

* `order.EpochOrder` — keyed O(1) random-access epoch permutation
  (windowed Feistel; no materialized index).
* `sharded.ShardedRecordDataset` — flat random access over indexed
  RecordIO shards; `host_range` / `host_shard_from_mesh` derive the
  per-host view of each global batch from the ``torch.distributed``
  group.
* `mixture.MixtureDataset` — deterministic weighted corpus interleave
  (least-served schedule; resumable from a counter vector).
* `packing.SequencePacker` — ragged documents → fixed `seq_len` rows
  with segment ids / positions / loss masks, checkpointable carry.
* `pipeline.DataPipeline` / `PipelineState` — the composed stream:
  iterate for host batches, feed a `parallel.DevicePrefetcher`, attach
  to `utils.CheckpointManager` (`attach_pipeline`) so manifests carry
  the data position and every restore O(1)-seeks instead of replaying.
"""
from .order import EpochOrder, default_window, mix64  # noqa: F401
from .sharded import (ShardedRecordDataset, host_range,  # noqa: F401
                      host_shard_from_mesh)
from .mixture import MixtureDataset  # noqa: F401
from .packing import SequencePacker  # noqa: F401
from .pipeline import (DataPipeline, PipelineState,  # noqa: F401
                       default_data_seed)

__all__ = [
    "EpochOrder", "default_window", "mix64",
    "ShardedRecordDataset", "host_range", "host_shard_from_mesh",
    "MixtureDataset", "SequencePacker",
    "DataPipeline", "PipelineState", "default_data_seed",
]
