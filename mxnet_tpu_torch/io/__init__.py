"""`mx.io` of the port — MXNet's 1.x data iterators (counterpart of
``mxnet_tpu/io/__init__.py``).  The Gluon `DataLoader` is the main input
path; these serve code written against the 1.x API.

Batches are `mx.np` arrays on the current device (the card unless a
``with mx.cpu():`` scope says otherwise): `NDArrayIter` keeps its arrays
where they were made and gathers each batch there.  Its shuffle draws from
NumPy's global generator, as JAX's and MXNet's do, so one
``np.random.seed`` gives one order in both packages; ``"roll_over"``
wraps the last batch as ``"pad"`` does (JAX's behaviour; ROADMAP.md §C).
`CSVIter` reads through the native parser (`_native.csv_read`),
`LibSVMIter` gives dense batches, `PrefetchingIter` reads ahead on a
thread that enters the device current where it was built.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _onp
import torch

from ..base import MXNetError
from ..device import current_device
from ..ndarray.ndarray import ndarray, wrap

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ResizeIter", "PrefetchingIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    def __new__(cls, name, shape, dtype=_onp.float32, layout="NCHW"):
        return super().__new__(cls, name, shape, dtype, layout)


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        raise NotImplementedError

    def __next__(self):
        return self.next()

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            return False


def _as_array(v):
    from ..numpy import array
    if isinstance(v, ndarray):
        return v
    if isinstance(v, torch.Tensor):
        return wrap(v)
    return array(v)


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (a NumPy array, an `ndarray`, a tensor,
    or a list or dict of them), in order or shuffled; a short last batch is
    padded from the start (``"pad"``, ``"roll_over"``) or dropped
    (``"discard"``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)

        def _norm(d, default_name):
            if d is None:
                return []
            if isinstance(d, (ndarray, _onp.ndarray, torch.Tensor)):
                return [(default_name, _as_array(d))]
            if isinstance(d, dict):
                return [(k, _as_array(v)) for k, v in d.items()]
            return [(f"{default_name}_{i}", _as_array(v))
                    for i, v in enumerate(d)]

        self.data = _norm(data, data_name)
        self.label = _norm(label, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._order = _onp.arange(self.num_data)
        if shuffle:
            _onp.random.shuffle(self._order)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            _onp.random.shuffle(self._order)

    def _take(self, v, idx):
        from ..numpy import array
        t = v._data
        return array(t[torch.as_tensor(idx, device=t.device)], copy=False)

    def next(self):
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            raise StopIteration
        end = self.cursor + self.batch_size
        pad = max(0, end - self.num_data)
        if pad and self.last_batch_handle == "discard":
            raise StopIteration
        idx = self._order[self.cursor:min(end, self.num_data)]
        if pad:
            idx = _onp.concatenate([idx, self._order[:pad]])
        return DataBatch(data=[self._take(v, idx) for _, v in self.data],
                         label=[self._take(v, idx) for _, v in self.label],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)


class _Wrapped(DataIter):
    """An iterator that hands out the batches of an inner `NDArrayIter`."""

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class CSVIter(_Wrapped):
    """Batches of a CSV file's rows, reshaped to `data_shape` (labels from
    `label_csv`, reshaped to `label_shape`)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, **kwargs):
        super().__init__(batch_size)
        data = self._load_csv(data_csv).reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = self._load_csv(label_csv).reshape(
                (-1,) + tuple(label_shape))
        self._inner = NDArrayIter(data, label, batch_size, **kwargs)

    @staticmethod
    def _load_csv(path):
        from .. import _native
        if _native.available():
            return _native.csv_read(path)
        return _onp.loadtxt(path, delimiter=",", dtype=_onp.float32,
                            ndmin=2)


class LibSVMIter(_Wrapped):
    """Batches of ``label idx:val ...`` lines as DENSE rows of
    `data_shape` (0-based feature indices), as JAX gives them; labels from
    the lines, or from `label_libsvm` (plain values)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, **kwargs):
        super().__init__(batch_size)
        n_feat = int(_onp.prod(data_shape))
        data, labels = self._load(data_libsvm, n_feat)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_libsvm is not None:
            label = self._load_labels(label_libsvm).reshape(
                (-1,) + tuple(label_shape))
            if label.shape[0] != data.shape[0]:
                raise MXNetError(
                    f"label file has {label.shape[0]} rows but data file "
                    f"has {data.shape[0]}")
        else:
            label = labels.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(data, label, batch_size, **kwargs)

    @staticmethod
    def _load(path, n_feat):
        rows, labels = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = _onp.zeros(n_feat, dtype=_onp.float32)
                for tok in parts[1:]:
                    idx, val = tok.split(":")
                    i = int(idx)
                    if not 0 <= i < n_feat:
                        raise MXNetError(
                            f"libsvm feature index {i} out of range "
                            f"[0, {n_feat}) in line: {line.strip()!r}")
                    row[i] = float(val)
                rows.append(row)
        return (_onp.stack(rows) if rows
                else _onp.zeros((0, n_feat), _onp.float32)), \
            _onp.asarray(labels, dtype=_onp.float32)

    @staticmethod
    def _load_labels(path):
        vals = []
        with open(path) as f:
            for line in f:
                vals.extend(float(t) for t in line.split())
        return _onp.asarray(vals, dtype=_onp.float32)


class ResizeIter(DataIter):
    """`size` batches an epoch of `data_iter`, restarting it when it ends
    early."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


class PrefetchingIter(DataIter):
    """Reads the batches of `iters` ahead on a thread (a list of batches
    for several iterators)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        import queue
        import threading
        if not isinstance(iters, list):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self._q = queue.Queue(maxsize=4)
        self._stop = threading.Event()
        device = current_device()

        def _worker():
            with device:
                while not self._stop.is_set():
                    try:
                        self._q.put([it.next() for it in self.iters])
                    except StopIteration:
                        self._q.put(None)
                        return
                    except Exception as e:      # raised at next()
                        self._q.put(e)
                        return
        self._thread = threading.Thread(target=_worker, daemon=True)
        self._thread.start()

    def next(self):
        b = self._q.get()
        if b is None:
            raise StopIteration
        if isinstance(b, Exception):
            raise b
        return b[0] if len(b) == 1 else b


from .image_record import ImageRecordIter, MNISTIter  # noqa: E402

__all__ += ["ImageRecordIter", "MNISTIter"]
