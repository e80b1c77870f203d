"""`ImageRecordIter` and `MNISTIter` (counterpart of
``mxnet_tpu/io/image_record.py``): the C++ iterators of MXNet's 1.x data
plane, on the host.

`ImageRecordIter` reads an indexed RecordIO file (`tools/im2rec.py`'s
``.rec`` + ``.idx``), decodes and augments each record on a thread pool
(OpenCV first, then PIL, each imported at first use; neither installed
raises `MXNetError`), assembles numpy batches on a producer thread with
a bounded queue, and hands each out as one `mx.np` array on the consumer's
current device.  Its shuffle, crops and flips draw from its own
``RandomState(seed)``, as JAX's do, so one seed gives one stream in both
packages.  `MNISTIter` reads IDX files (gzip or not).  `part_index` /
`num_parts` shard the records.
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as _onp

from ..base import MXNetError
from . import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter", "MNISTIter"]

def _codecs():
    """(cv2, PIL.Image), each None where not installed, imported at the
    first use."""
    global _CODECS
    if _CODECS is None:
        try:
            import cv2
        except Exception:
            cv2 = None
        try:
            from PIL import Image
        except Exception:
            Image = None
        _CODECS = (cv2, Image)
    return _CODECS


_CODECS = None


def _decode_jpeg(buf: bytes) -> _onp.ndarray:
    """Encoded bytes -> HWC uint8 RGB: OpenCV first (BGR -> RGB), then
    PIL."""
    cv2, pil = _codecs()
    if cv2 is not None:
        img = cv2.imdecode(_onp.frombuffer(buf, _onp.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise MXNetError("image decode failed")
        return img[:, :, ::-1]
    if pil is not None:
        import io
        return _onp.asarray(pil.open(io.BytesIO(buf)).convert("RGB"))
    raise MXNetError("no image codec available (cv2/PIL)")


def _resize(img, w, h):
    cv2, pil = _codecs()
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    return _onp.asarray(pil.fromarray(img).resize((w, h), pil.BILINEAR))


def _resize_short(img, size):
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, int(w * size / h))
    else:
        nh, nw = max(1, int(h * size / w)), size
    return _resize(img, nw, nh)


class ImageRecordIter(DataIter):
    """Threaded image-record iterator over `tools/im2rec.py` output:
    `DataBatch`es of NCHW float `data` and float `label`, with MXNet's
    resize, crop, mirror and ``(x - mean) / std * scale`` normalisation."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1,
                 shuffle=False, seed=0,
                 resize=-1, rand_crop=False, rand_mirror=False,
                 mean_img=None, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 preprocess_threads=4, prefetch_buffer=4,
                 round_batch=True, part_index=0, num_parts=1,
                 dtype="float32", device=None, ctx=None, **kwargs):
        super().__init__(batch_size)
        from .. import recordio as _recordio
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (channels, height, width)")
        self.data_shape = tuple(int(d) for d in data_shape)
        self.label_width = int(label_width)
        self.shuffle = shuffle
        self.resize = int(resize)
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.scale = float(scale)
        self.dtype = dtype
        self._rng = _onp.random.RandomState(seed)

        c = self.data_shape[0]
        mean = _onp.array([mean_r, mean_g, mean_b][:c], _onp.float32)
        std = _onp.array([std_r, std_g, std_b][:c], _onp.float32)
        self._mean = mean.reshape(-1, 1, 1)
        self._std = std.reshape(-1, 1, 1)
        if mean_img is not None:
            if not os.path.exists(str(mean_img)):
                raise MXNetError(f"mean_img file {mean_img} not found")
            with _onp.load(mean_img) as z:  # npz written by users/tools
                m = _onp.asarray(z[z.files[0]], _onp.float32)
            if m.shape != self.data_shape:   # per-pixel mean image (C,H,W)
                raise MXNetError(
                    f"mean_img shape {m.shape} != data_shape "
                    f"{self.data_shape}")
            self._mean = m

        idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        if not os.path.exists(idx_path):
            raise MXNetError(
                f"index file {idx_path} not found; pack the dataset with "
                "tools/im2rec.py (it writes .rec + .idx)")
        self._rec = _recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
        self._recordio = _recordio
        keys = list(self._rec.keys)
        if num_parts > 1:  # shard for multi-host dp
            keys = keys[part_index::num_parts]
        self._keys = keys
        self.round_batch = round_batch
        self._threads = max(1, int(preprocess_threads))
        self._prefetch = max(1, int(prefetch_buffer))
        self._pool = ThreadPoolExecutor(max_workers=self._threads)
        self._rec_lock = threading.Lock()   # MXIndexedRecordIO seeks
        self._queue: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        self._producer = None
        self._stop = threading.Event()
        self._epoch = 0
        self.provide_data = [DataDesc("data",
                                      (batch_size,) + self.data_shape)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc("softmax_label", lshape)]
        self.reset()

    # -- per-sample work (runs on pool threads) --------------------------
    def _load_sample(self, key, flip: bool, crop_xy):
        with self._rec_lock:
            raw = self._rec.read_idx(key)
        header, img_bytes = self._recordio.unpack(raw)
        img = _decode_jpeg(img_bytes)
        c, th, tw = self.data_shape
        if self.resize > 0:
            img = _resize_short(img, self.resize)
        h, w = img.shape[:2]
        if h < th or w < tw:   # upscale so the crop window fits
            img = _resize(img, max(w, tw), max(h, th))
            h, w = img.shape[:2]
        if (h, w) != (th, tw):
            if self.rand_crop:
                y0 = int(crop_xy[0] * (h - th + 1))
                x0 = int(crop_xy[1] * (w - tw + 1))
            else:  # center crop (reference default)
                y0, x0 = (h - th) // 2, (w - tw) // 2
            img = img[y0:y0 + th, x0:x0 + tw]
        if flip:
            img = img[:, ::-1]
        chw = img.astype(_onp.float32).transpose(2, 0, 1)[:c]
        chw = (chw - self._mean) / self._std * self.scale
        label = header.label
        if self.label_width == 1:
            label = float(label if _onp.isscalar(label) else
                          _onp.asarray(label).ravel()[0])
        else:
            label = _onp.asarray(label, _onp.float32)[:self.label_width]
        return chw, label

    # -- producer thread -------------------------------------------------
    def _produce_epoch(self, order, epoch_stop, q):
        bs = self.batch_size
        n = len(order)
        i = 0
        while i < n and not epoch_stop.is_set():
            chunk = order[i:i + bs]
            pad = bs - len(chunk)
            if pad and not self.round_batch:
                chunk = list(chunk)
            elif pad:
                chunk = list(chunk) + list(order[:pad])  # wrap (round_batch)
            flips = self._rng.rand(len(chunk)) < 0.5 if self.rand_mirror \
                else _onp.zeros(len(chunk), bool)
            crops = self._rng.rand(len(chunk), 2)
            try:
                futs = [self._pool.submit(self._load_sample, k, bool(f), xy)
                        for k, f, xy in zip(chunk, flips, crops)]
            except RuntimeError:  # pool shut down (close()/interpreter exit)
                return
            imgs, labels = [], []
            try:
                for f in futs:
                    img, lab = f.result()
                    imgs.append(img)
                    labels.append(lab)
            except Exception as e:  # surface decode errors at next()
                q.put(e)
                return
            data = _onp.stack(imgs).astype(self.dtype, copy=False)
            label = _onp.asarray(labels, _onp.float32)
            while not epoch_stop.is_set():
                try:
                    q.put((data, label, pad), timeout=0.1)
                    break
                except queue.Full:
                    continue
            i += bs
        if not epoch_stop.is_set():
            q.put(None)  # epoch end

    def reset(self):
        # stop any in-flight epoch, drain, restart
        if self._producer is not None and self._producer.is_alive():
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._producer.join(timeout=5)
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._prefetch)
        order = list(self._keys)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        stop = self._stop
        self._producer = threading.Thread(
            target=self._produce_epoch, args=(order, stop, self._queue),
            daemon=True)
        self._producer.start()

    def next(self):
        from ..numpy import array as _array
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        data, label, pad = item
        return DataBatch([_array(data)], [_array(label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._pool.shutdown(wait=False)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def _read_idx_ubyte(path):
    """An IDX file (gzip or not) as a numpy array."""
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = _onp.frombuffer(f.read(), _onp.uint8)
    return data.reshape(dims)


class MNISTIter(DataIter):
    """Batches of MNIST's IDX image and label files: images scaled to
    [0, 1], (N, 1, 28, 28) or flat; full batches only."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, silent=True, part_index=0, num_parts=1, **kwargs):
        super().__init__(batch_size)
        imgs = _read_idx_ubyte(image).astype(_onp.float32) / 255.0
        labels = _read_idx_ubyte(label).astype(_onp.float32)
        if imgs.ndim != 3:
            raise MXNetError(
                f"expected 3-d MNIST image file, got {imgs.shape}")
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            labels = labels[part_index::num_parts]
        self._imgs = imgs.reshape(len(imgs), -1) if flat \
            else imgs[:, None, :, :]
        self._labels = labels
        self.shuffle = shuffle
        self._rng = _onp.random.RandomState(seed)
        self.flat = flat
        self.provide_data = [DataDesc(
            "data", (batch_size,) + self._imgs.shape[1:])]
        self.provide_label = [DataDesc("softmax_label", (batch_size,))]
        self.reset()

    def reset(self):
        self._order = _onp.arange(len(self._imgs))
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def next(self):
        from ..numpy import array as _array
        if self._cursor + self.batch_size > len(self._order):
            raise StopIteration
        sel = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        return DataBatch([_array(self._imgs[sel])],
                         [_array(self._labels[sel])], pad=0,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
