"""Samplers of the port (counterpart of ``mxnet_tpu/gluon/data/sampler.py``:
the same keyed permutations, drawn with NumPy on the host, never with
``torch.randperm``; parity: `python/mxnet/gluon/data/sampler.py`)."""
from __future__ import annotations

import numpy as _onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """Shuffled indices, reproducibly.

    The reference implementation called the GLOBAL `np.random.permutation`:
    it silently mutated process-wide RNG state (perturbing every other
    consumer of `np.random`), and on a multi-host job each host shuffled
    DIFFERENTLY — the same "batch" trained on different data per host.
    This one draws from a local `numpy.random.Generator` keyed by
    ``(seed, epoch)``: identical on every host, zero global state
    touched, and each epoch reshuffles (the epoch advances automatically
    per full iteration; `set_epoch` pins it — call it with the restored
    epoch to resume a run deterministically).

    `seed` default: ``MXTPU_DATA_SEED``, else 0.
    """

    def __init__(self, length, seed=None):
        self._length = length
        if seed is None:
            from ...data.pipeline import default_data_seed
            seed = default_data_seed()
        self._seed = int(seed)
        self._epoch = 0

    def set_epoch(self, epoch):
        """Pin the epoch the next iteration shuffles for (resume,
        explicit epoch-keyed loops). Auto-advance continues from it."""
        self._epoch = int(epoch)

    def __iter__(self):
        from ...data.order import mix64
        epoch, self._epoch = self._epoch, self._epoch + 1
        gen = _onp.random.Generator(
            _onp.random.PCG64(mix64(self._seed) ^ mix64(0xE9 + epoch)))
        return iter(gen.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(f"bad last_batch {self._last_batch}")

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._sampler) + len(self._prev)) // self._batch_size
