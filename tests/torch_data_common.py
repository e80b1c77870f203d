"""Datasets for the port's data-plane tests that a spawned `DataLoader`
worker must unpickle: they live in a module of their own, which imports
neither JAX nor the JAX package, so a worker imports only the port."""
import os
import time

import numpy as np


class SquaresDataset:
    """Sample i: (float32 vector of i, i*i) — cheap, deterministic."""

    def __init__(self, n=23, width=4):
        self.n, self.width = n, width

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full(self.width, i, np.float32), i * i


class FailingDataset(SquaresDataset):
    """Raises at sample `bad`."""

    def __init__(self, n=23, bad=7):
        super().__init__(n)
        self.bad = bad

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"bad sample {i}")
        return super().__getitem__(i)


class SlowDataset(SquaresDataset):
    """Sleeps `delay` seconds a sample."""

    def __init__(self, n=8, delay=1.0):
        super().__init__(n)
        self.delay = delay

    def __getitem__(self, i):
        time.sleep(self.delay)
        return super().__getitem__(i)


class DeviceProbe:
    """A sample's device, as the worker that made it saw it: the type of
    an `mx.np` array built with no device (the worker's default), and
    whether CUDA was initialised in the worker's process."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        import torch
        import mxnet_tpu_torch as mx
        a = mx.np.array([float(i)])
        return (np.array([a._data.device.type == "cpu",
                          torch.cuda.is_initialized(), os.getpid()],
                         np.int64),)
