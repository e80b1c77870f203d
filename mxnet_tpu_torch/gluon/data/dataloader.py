"""DataLoader of the port (counterpart of
``mxnet_tpu/gluon/data/dataloader.py``: the same options and batches;
parity: `python/mxnet/gluon/data/dataloader.py:514`).

The reference forks worker *processes* and ships NDArrays through shared
memory (`cpu_shared_storage_manager.h`, ForkingPickler at dataloader.py:67-93)
because Python-side decode is GIL-bound. Two worker modes here:

- `thread_pool=True` (default): a thread pool — right for light transforms;
  NumPy decode releases the GIL and nothing crosses a process boundary.
  The current device is per thread in the port, so every worker thread
  runs under the device that was current where the loader was built
  (``with mx.cpu():`` around the constructor keeps the workers' arrays on
  the CPU; with no scope they land on the card).
- `thread_pool=False`: **worker processes** with shared-memory batch
  transport (`_mp_loader.py`) — right for GIL-bound Python transforms.
  Workers are spawned and pinned to the CPU before anything is unpickled
  (`device.pin_process_cpu`: arrays pickled from the card are rebuilt on
  the CPU, so no worker ever opens a CUDA context), and each finished
  batch crosses as `multiprocessing.shared_memory` segments the parent
  maps and wraps as `mx.np` arrays on its own current device.  Spawn
  semantics: the dataset/transform must be picklable (module-level, not
  lambdas/closures), and user scripts must build the loader under
  ``if __name__ == "__main__":`` — the standard spawn-mode contract.
  Workers are supervised: a worker process that dies (OOM killer, native
  crash) is detected by exit code — not by timeout — respawned up to
  `worker_respawns` times, and its in-flight batches are resubmitted with
  order preserved (see `_mp_loader.ProcessPool`).

`pin_memory` keeps JAX's meaning: it is accepted, and the batch lands on
the current device either way.
"""
from __future__ import annotations

import time as _time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Callable, Optional

import numpy as _onp

from ... import health as _health
from ... import telemetry as _tele
from ...base import MXNetError
from ...device import current_device
from ...ndarray.ndarray import ndarray
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler, Sampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (parity: dataloader.py default_batchify_fn)."""
    from ... import numpy as mnp
    elem = data[0]
    if isinstance(elem, ndarray):
        return mnp.stack(data)
    if isinstance(elem, (tuple, list)):
        return type(elem)(default_batchify_fn([d[i] for d in data])
                          for i in range(len(elem)))
    arr = _onp.asarray(data)
    return mnp.array(arr)


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size=None, shuffle=False,
                 sampler: Optional[Sampler] = None, last_batch=None,
                 batch_sampler: Optional[BatchSampler] = None,
                 batchify_fn: Optional[Callable] = None, num_workers=0,
                 pin_memory=False, pin_device_id=0, prefetch=None,
                 thread_pool=True, timeout=120, try_nopython=None,
                 auto_reload=False, worker_respawns=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._thread_pool = thread_pool
        self._pin_memory = pin_memory
        # the device batches land on: the one current here, for every
        # worker thread too (the port's current device is per thread)
        self._device = current_device()
        self._prefetch = max(0, prefetch or 2 * max(num_workers, 1))
        # timeout (seconds) bounds the wait for each worker batch — a hung
        # transform raises instead of deadlocking the training loop
        # (parity: dataloader.py:514 timeout semantics)
        self._timeout = timeout
        self._pool = None
        self._proc_pool = None
        if num_workers > 0:
            if thread_pool:
                self._pool = ThreadPoolExecutor(max_workers=num_workers)
            else:
                from ._mp_loader import ProcessPool
                # worker_respawns bounds how many dead worker processes
                # (OOM kill, native crash) are transparently respawned
                # with their in-flight batches resubmitted before the
                # loader raises; default 2 * num_workers
                self._proc_pool = ProcessPool(dataset, self._batchify_fn,
                                              num_workers,
                                              max_respawns=worker_respawns)

    def _make_batch(self, indices):
        samples = [self._dataset[i] for i in indices]
        return self._batchify_fn(samples)

    def _make_batch_on_device(self, indices):
        """A thread-pool worker's batch, under the loader's device."""
        with self._device:
            return self._make_batch(indices)

    def _np_to_array(self, np_arr):
        # one host->device copy onto the loader's device (the
        # reference's pinned-memory -> copy-stream upload role)
        from ... import numpy as mnp
        return mnp.array(np_arr, device=self._device)

    def __iter__(self):
        if self._proc_pool is not None:
            # an abandoned previous iterator may have batches in flight;
            # drain them so this epoch starts clean (no stale data, no
            # leaked shm segments). Concurrent iterators are unsupported.
            self._proc_pool.reset(self._timeout)
            it = iter(self._batch_sampler)
            for _ in range(self._prefetch):
                try:
                    self._proc_pool.submit(next(it))
                except StopIteration:
                    break
            while self._proc_pool.outstanding:
                try:
                    self._proc_pool.submit(next(it))
                except StopIteration:
                    pass
                batch = self._proc_pool.get(self._np_to_array, self._timeout)
                # named heartbeat for the hang watchdog (mx.health): a
                # loader that stops handing out batches shows up by name
                _health.beat("dataloader")
                yield batch
            return
        if self._pool is None:
            for indices in self._batch_sampler:
                batch = self._make_batch(indices)
                _health.beat("dataloader")
                yield batch
            return
        # windowed prefetch over the thread pool
        import collections
        queue = collections.deque()
        it = iter(self._batch_sampler)

        def submit():
            try:
                indices = next(it)
            except StopIteration:
                return False
            queue.append(self._pool.submit(self._make_batch_on_device,
                                           indices))
            return True

        for _ in range(self._prefetch):
            if not submit():
                break
        while queue:
            fut = queue.popleft()
            # restore the window to FULL depth immediately after taking a
            # batch out — before blocking on this batch's result — stated
            # as an invariant (refill-to-depth) rather than one paired
            # submit, so `prefetch` submissions always run behind a slow
            # transform even if a future edit pops more than one future
            # per iteration
            while len(queue) < self._prefetch and submit():
                pass
            try:
                t0 = _time.perf_counter()
                batch = fut.result(timeout=self._timeout)
                if _tele.enabled():
                    _tele.histogram(
                        "dataloader_batch_wait_ms",
                        "Host wait for the next in-order DataLoader "
                        "batch (ms)"
                    ).observe((_time.perf_counter() - t0) * 1e3)
                _health.beat("dataloader")
                yield batch
            except FuturesTimeoutError:
                raise MXNetError(
                    f"DataLoader worker batch timed out after "
                    f"{self._timeout}s (num_workers={self._num_workers}); "
                    "a dataset transform is stuck or too slow — raise "
                    "`timeout=` or debug the transform")

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._proc_pool is not None:
            self._proc_pool.shutdown()
