"""Vision datasets of the port (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; parity:
`python/mxnet/gluon/data/vision/datasets.py`).

Nothing is downloaded: each dataset reads its files (IDX for MNIST,
the Python pickle batches for CIFAR) under `root` when they are there;
otherwise, with ``MXTPU_SYNTHETIC_DATA`` on (the default), it makes a
seeded synthetic stand-in with the right shapes and cardinality —
``RandomState(42 / 43)`` for MNIST's train / test, ``(7 / 8)`` for CIFAR —
bit-equal to the JAX package's, so the examples run end to end anywhere.
A sample is ``(mx.np array on the current device, int label)``.  The
image-file and image-record datasets decode with the image codec, which
is not ported yet: they raise `MXNetError` naming ROADMAP.md A11 part 2.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _onp

from ....base import MXNetError, getenv_bool
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageListDataset",
           "ImageRecordDataset", "ImageFolderDataset"]


def _synthetic_ok():
    return getenv_bool("MXTPU_SYNTHETIC_DATA", True)


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        from .... import numpy as mnp
        x = mnp.array(self._data[idx])
        y = int(self._label[idx])
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """MNIST (parity: datasets.py MNIST; mirrors `example/gluon/mnist`)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._shape = (28, 28, 1)
        self._nclass = 10
        super().__init__(root, train, transform)

    def _files(self):
        if self._train:
            return ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
        return ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def _get_data(self):
        img_f, lbl_f = (os.path.join(self._root, f) for f in self._files())
        if os.path.exists(img_f) and os.path.exists(lbl_f):
            with gzip.open(lbl_f, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = _onp.frombuffer(f.read(), dtype=_onp.uint8)
            with gzip.open(img_f, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                data = _onp.frombuffer(f.read(), dtype=_onp.uint8)
                data = data.reshape(n, rows, cols, 1)
            self._data, self._label = data, label.astype(_onp.int32)
            return
        if not _synthetic_ok():
            raise MXNetError(f"MNIST files not found under {self._root} and "
                             "synthetic fallback disabled")
        n = 60000 if self._train else 10000
        rng = _onp.random.RandomState(42 if self._train else 43)
        self._label = rng.randint(0, self._nclass, size=n).astype(_onp.int32)
        base = rng.randint(0, 64, size=(self._nclass,) + self._shape)
        noise = rng.randint(0, 192, size=(n,) + self._shape)
        self._data = ((base[self._label] + noise) // 2).astype(_onp.uint8)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class _CIFAR(_DownloadedDataset):
    _nclass = 10

    def __init__(self, root, train, transform, fine_label=False):
        self._shape = (32, 32, 3)
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        # pickle-format batches (python version layout)
        files = self._file_list()
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            import pickle
            datas, labels = [], []
            for p in paths:
                with open(p, "rb") as f:
                    batch = pickle.load(f, encoding="latin1")
                datas.append(_onp.asarray(batch["data"], dtype=_onp.uint8)
                             .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
                key = "fine_labels" if self._fine_label else \
                    ("labels" if "labels" in batch else "coarse_labels")
                labels.append(_onp.asarray(batch[key], dtype=_onp.int32))
            self._data = _onp.concatenate(datas)
            self._label = _onp.concatenate(labels)
            return
        if not _synthetic_ok():
            raise MXNetError(f"CIFAR files not found under {self._root}")
        n = 50000 if self._train else 10000
        rng = _onp.random.RandomState(7 if self._train else 8)
        self._label = rng.randint(0, self._nclass, size=n).astype(_onp.int32)
        base = rng.randint(0, 96, size=(self._nclass,) + self._shape)
        noise = rng.randint(0, 160, size=(n,) + self._shape)
        self._data = ((base[self._label] + noise) // 2).astype(_onp.uint8)


class CIFAR10(_CIFAR):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _file_list(self):
        if self._train:
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]


class CIFAR100(_CIFAR):
    _nclass = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 train=True, fine_label=False, transform=None):
        super().__init__(root, train, transform, fine_label)

    def _file_list(self):
        return ["train"] if self._train else ["test"]


def _needs_codec(name):
    class _ImageDataset(Dataset):
        def __init__(self, *args, **kwargs):
            raise MXNetError(
                f"gluon.data.vision.{name} decodes images with the image "
                "codec (mx.image), which is not ported yet (ROADMAP.md A11 "
                "part 2)")
    _ImageDataset.__name__ = _ImageDataset.__qualname__ = name
    _ImageDataset.__doc__ = ("Not ported yet: decodes images with mx.image; "
                             "raises `MXNetError` (ROADMAP.md A11 part 2).")
    return _ImageDataset


ImageRecordDataset = _needs_codec("ImageRecordDataset")
ImageFolderDataset = _needs_codec("ImageFolderDataset")
ImageListDataset = _needs_codec("ImageListDataset")
