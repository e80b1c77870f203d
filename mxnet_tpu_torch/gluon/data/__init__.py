"""`mx.gluon.data` of the port (counterpart of ``mxnet_tpu/gluon/data/``;
parity: `python/mxnet/gluon/data/`): datasets, samplers, batchify
functions and the `DataLoader` (thread or process workers)."""
from . import vision  # noqa: F401
from . import batchify  # noqa: F401
from .dataset import (Dataset, SimpleDataset, ArrayDataset,  # noqa: F401
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler,  # noqa: F401
                      RandomSampler, BatchSampler, FilterSampler,
                      IntervalSampler)
from .dataloader import DataLoader, default_batchify_fn  # noqa: F401
