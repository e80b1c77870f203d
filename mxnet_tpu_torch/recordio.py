"""RecordIO file format of the port (counterpart of
``mxnet_tpu/recordio.py``: the same names and the same bytes on disk;
parity: `python/mxnet/recordio.py` over dmlc-core's recordio +
`tools/im2rec`).  Records are framed by a magic number + length, 4-byte
aligned, with an optional `IRHeader` (label/id) prefix for packed datasets.

The native data plane (`_native/io.cc`, built with the system's C++
compiler into the port's build root) provides the fast path — C++ record
codec + background-thread read-ahead (parity: dmlc recordio and
`src/io/iter_prefetcher.h`); this module uses it when the library builds
and falls back to pure Python otherwise (``self._native`` says which).  A
file written by either package, on either path, is read by the other.
`pack_img` / `unpack_img` encode and decode through OpenCV, else PIL
(the codecs of `io.ImageRecordIter`).
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple
from typing import Optional

import numpy as _onp

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "MXPrefetchedRecordIO",
           "IRHeader", "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LFLAG_BITS = 29


class MXRecordIO:
    """Sequential record reader/writer (dmlc recordio framing)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        from . import _native
        native = _native.available()
        if self.flag == "w":
            self.writable = True
            if native:
                self.handle = _native.NativeRecordWriter(self.uri)
                self._native = True
            else:
                self.handle = open(self.uri, "wb")
                self._native = False
        elif self.flag == "r":
            self.writable = False
            if native:
                self.handle = _native.NativeRecordReader(self.uri)
                self._native = True
            else:
                self.handle = open(self.uri, "rb")
                self._native = False
        else:
            raise MXNetError("flag must be 'r' or 'w'")

    def close(self):
        if self.handle is not None:
            self.handle.close()
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        return self.handle.tell()

    def seek(self, pos: int):
        assert not self.writable
        self.handle.seek(pos)

    def write(self, buf: bytes):
        self._write(buf)

    def _write(self, buf: bytes) -> int:
        """Append one record; returns its byte offset (for .idx files)."""
        assert self.writable
        if self._native:
            return self.handle.write(buf)
        pos = self.handle.tell()
        # dmlc framing: [magic][lrec][data][pad to 4B]
        lrec = len(buf)  # upper 3 bits: continuation flag (0 = complete)
        self.handle.write(struct.pack("<II", _MAGIC, lrec))
        self.handle.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)
        return pos

    def read(self) -> Optional[bytes]:
        assert not self.writable
        if self._native:
            return self.handle.read()
        hdr = self.handle.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic; corrupt file?")
        length = lrec & ((1 << _LFLAG_BITS) - 1)
        data = self.handle.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.handle.read(pad)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records via a .idx sidecar (parity: recordio.py:IndexedRecordIO)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        k = key_type(parts[0])
                        self.idx[k] = int(parts[1])
                        self.keys.append(k)

    def close(self):
        if self.handle is not None and self.writable:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self._write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    label = header.label
    if isinstance(label, (list, tuple, _onp.ndarray)) or \
            (hasattr(label, "size") and getattr(label, "size", 1) > 1):
        label = _onp.asarray(label, dtype=_onp.float32)
        header = header._replace(flag=label.size, label=0.0)
        return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, float(label), header.id,
                       header.id2) + s


def unpack(s: bytes):
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _onp.frombuffer(s[:header.flag * 4], dtype=_onp.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


class MXPrefetchedRecordIO:
    """Sequential reader with background read-ahead.

    Uses the C++ threaded prefetcher (`_native/io.cc` Prefetcher) when
    available; otherwise a Python thread + bounded queue (parity:
    `src/io/iter_prefetcher.h`). Iterate to get raw record bytes.
    """

    def __init__(self, uri: str, capacity: int = 16):
        from . import _native
        self.uri = uri
        self.capacity = capacity
        if _native.available():
            self._impl = _native.NativePrefetchReader(uri, capacity)
            self._queue = None
        else:
            import queue as _q
            import threading as _t
            self._impl = None
            self._queue = _q.Queue(maxsize=capacity)
            self._reader = MXRecordIO(uri, "r")
            self._exhausted = False
            self._stop = _t.Event()

            # worker errors (corrupt record, I/O failure) travel through
            # the queue as tagged entries and re-raise in the consumer —
            # a bare `self._reader.read()` raise used to kill the thread
            # silently and leave the consumer blocked on get() forever.
            # Every put is stop-aware so close() can always reclaim a
            # worker blocked on a full queue (the old thread leaked).
            def _put(entry) -> bool:
                while not self._stop.is_set():
                    try:
                        self._queue.put(entry, timeout=0.05)
                        return True
                    except _q.Full:
                        continue
                return False

            def worker():
                try:
                    while not self._stop.is_set():
                        rec = self._reader.read()
                        if rec is None:
                            _put(("end", None))
                            return
                        if not _put(("item", rec)):
                            return
                except BaseException as e:  # noqa: BLE001 — consumer's
                    _put(("error", e))      # to re-raise, not ours
            self._thread = _t.Thread(target=worker, daemon=True,
                                     name="mxtpu-recordio-prefetch")
            self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._impl is not None:
            return next(self._impl)
        if self._exhausted or self._stop.is_set():
            raise StopIteration
        import queue as _q
        while True:
            try:
                kind, payload = self._queue.get(timeout=0.05)
                break
            except _q.Empty:
                # close() from another thread wakes this consumer
                # instead of deadlocking it on a dead producer
                if self._stop.is_set():
                    raise StopIteration from None
        if kind == "item":
            return payload
        self._exhausted = True
        self.close()
        if kind == "error":
            raise payload
        raise StopIteration

    def close(self, timeout: float = 5.0):
        if self._impl is not None:
            self._impl.close()
        elif self._queue is not None:
            # stop -> drain (wakes a put blocked on a full queue) ->
            # join -> re-drain (the woken producer may deposit one last
            # record between the first drain and its exit)
            import queue as _q
            import threading as _t
            self._stop.set()
            for _ in range(2):
                try:
                    while True:
                        self._queue.get_nowait()
                except _q.Empty:
                    pass
                t = self._thread
                if t is not _t.current_thread() and t.is_alive():
                    t.join(timeout)
            self._reader.close()


def pack_img(header: IRHeader, img, quality=95, img_fmt=".jpg"):
    """Encode `img` (HWC uint8 RGB, as `unpack_img` gives it back, or HW /
    HW1 grey) as `img_fmt` and pack it under `header`: OpenCV first
    (`quality` is JPEG's quality, or PNG's compression level clamped to
0-9), then PIL."""
    from .io.image_record import _codecs
    arr = _onp.asarray(img.asnumpy() if hasattr(img, "asnumpy") else img)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    arr = _onp.ascontiguousarray(arr.astype(_onp.uint8))
    fmt = img_fmt.lower()
    cv2, pil = _codecs()
    if cv2 is not None:
        params = {".jpg": [cv2.IMWRITE_JPEG_QUALITY, quality],
                  ".jpeg": [cv2.IMWRITE_JPEG_QUALITY, quality],
                  ".png": [cv2.IMWRITE_PNG_COMPRESSION,
                           min(max(quality, 0), 9)]}
        bgr = arr[:, :, ::-1] if arr.ndim == 3 else arr
        ok, buf = cv2.imencode(img_fmt, _onp.ascontiguousarray(bgr),
                               params.get(fmt, []))
        if not ok:
            raise MXNetError(f"failed to encode an image as {img_fmt}")
        return pack(header, buf.tobytes())
    if pil is None:
        raise MXNetError("no image codec available (cv2/PIL)")
    import io
    out = io.BytesIO()
    kind = "JPEG" if fmt in (".jpg", ".jpeg") else fmt.lstrip(".").upper()
    pil.fromarray(arr).save(out, format=kind, **(
        {"quality": quality} if kind == "JPEG" else {}))
    return pack(header, out.getvalue())


def unpack_img(s: bytes, iscolor=1):
    """The record's header and its image decoded as an HWC uint8 RGB
    `mx.np` array on the current device, as the JAX package's
    ``unpack_img`` gives it (which takes `iscolor` and ignores it);
    OpenCV first, then PIL."""
    from .io.image_record import _decode_jpeg
    from .numpy import array
    header, buf = unpack(s)
    return header, array(_decode_jpeg(buf).copy(), dtype="uint8")
