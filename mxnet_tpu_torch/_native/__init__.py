"""Native (C++) record I/O of the port (counterpart of
``mxnet_tpu/_native/__init__.py``: the same C interface and wrappers).

`io.cc` is compiled with the system's C++ compiler (``$CXX``, else
``g++``) at first use into the port's build root, beside the CUDA kernels:
``build/mxnet_tpu_torch/native/<hash>/libmxtpu_io.so`` (``kernels``'
root, moved by ``MXTPU_TORCH_BUILD_DIR``), keyed by a hash of the source
and flags, written to a temporary name and renamed so concurrent processes
never load half a library.  Nothing is written into the package.

This is host I/O, not a device kernel: every consumer tolerates
``available() == False`` (no compiler, a failed build, ``MXTPU_NO_NATIVE``)
and falls back to pure Python, as the JAX package does; `recordio` says
which path it took (`MXRecordIO._native`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading

__all__ = ["available", "get_lib", "library_path", "NativeRecordWriter",
           "NativeRecordReader", "NativePrefetchReader", "csv_read"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "io.cc")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_tried = False
_lock = threading.Lock()


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    from ..kernels import _build_root
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_build_root(), "native", h.hexdigest()[:16],
                        "libmxtpu_io.so")


def _build(lib: str) -> bool:
    cxx = os.environ.get("CXX", "g++")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    cmd = [cxx, *_FLAGS, _SRC, "-o", tmp, "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            sys.stderr.write("mxnet_tpu_torch native build failed:\n"
                             + res.stderr.decode(errors="replace")[-2000:]
                             + "\n")
            return False
        os.replace(tmp, lib)
        return True
    except Exception as e:  # compiler missing, timeout, ...
        sys.stderr.write(f"mxnet_tpu_torch native build skipped: {e}\n")
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib):
    c = ctypes
    lib.mxtpu_recio_writer_open.restype = c.c_void_p
    lib.mxtpu_recio_writer_open.argtypes = [c.c_char_p]
    lib.mxtpu_recio_write.restype = c.c_longlong
    lib.mxtpu_recio_write.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.mxtpu_recio_writer_close.argtypes = [c.c_void_p]
    lib.mxtpu_recio_reader_open.restype = c.c_void_p
    lib.mxtpu_recio_reader_open.argtypes = [c.c_char_p]
    lib.mxtpu_recio_read.restype = c.c_longlong
    lib.mxtpu_recio_read.argtypes = [c.c_void_p, c.POINTER(c.c_char_p)]
    lib.mxtpu_recio_seek.argtypes = [c.c_void_p, c.c_uint64]
    lib.mxtpu_recio_tell.restype = c.c_uint64
    lib.mxtpu_recio_tell.argtypes = [c.c_void_p]
    lib.mxtpu_recio_reader_close.argtypes = [c.c_void_p]
    lib.mxtpu_csv_shape.restype = c.c_int
    lib.mxtpu_csv_shape.argtypes = [c.c_char_p, c.POINTER(c.c_longlong),
                                    c.POINTER(c.c_longlong)]
    lib.mxtpu_csv_read.restype = c.c_longlong
    lib.mxtpu_csv_read.argtypes = [c.c_char_p, c.POINTER(c.c_float),
                                   c.c_longlong]
    lib.mxtpu_prefetch_open.restype = c.c_void_p
    lib.mxtpu_prefetch_open.argtypes = [c.c_char_p, c.c_int]
    lib.mxtpu_prefetch_next.restype = c.c_longlong
    lib.mxtpu_prefetch_next.argtypes = [c.c_void_p, c.POINTER(c.c_char_p)]
    lib.mxtpu_prefetch_close.argtypes = [c.c_void_p]
    return lib


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MXTPU_NO_NATIVE"):
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError as e:
            sys.stderr.write(f"mxnet_tpu_torch native load failed: {e}\n")
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


# -- convenience wrappers ----------------------------------------------------

class NativeRecordWriter:
    def __init__(self, path: str):
        lib = get_lib()
        assert lib is not None
        self._lib = lib
        self._offset = 0
        self._h = lib.mxtpu_recio_writer_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path} for writing")

    def write(self, buf: bytes) -> int:
        if not self._h:
            raise ValueError("writer is closed")
        off = self._lib.mxtpu_recio_write(self._h, buf, len(buf))
        if off < 0:
            raise IOError("record write failed (too large?)")
        self._offset = off + 8 + len(buf) + ((4 - (len(buf) & 3)) & 3)
        return off

    def tell(self) -> int:
        return self._offset

    def close(self):
        if self._h:
            self._lib.mxtpu_recio_writer_close(self._h)
            self._h = None


class NativeRecordReader:
    def __init__(self, path: str):
        lib = get_lib()
        assert lib is not None
        self._lib = lib
        self._h = lib.mxtpu_recio_reader_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def read(self):
        if not self._h:
            raise ValueError("reader is closed")
        out = ctypes.c_char_p()
        n = self._lib.mxtpu_recio_read(self._h, ctypes.byref(out))
        if n == -1:
            return None
        if n < 0:
            raise IOError("corrupt recordio stream")
        return ctypes.string_at(out, n)

    def seek(self, pos: int):
        if not self._h:
            raise ValueError("reader is closed")
        self._lib.mxtpu_recio_seek(self._h, pos)

    def tell(self) -> int:
        if not self._h:
            raise ValueError("reader is closed")
        return self._lib.mxtpu_recio_tell(self._h)

    def close(self):
        if self._h:
            self._lib.mxtpu_recio_reader_close(self._h)
            self._h = None


class NativePrefetchReader:
    """Background-thread RecordIO read-ahead (C++ thread, bounded queue)."""

    def __init__(self, path: str, capacity: int = 16):
        lib = get_lib()
        assert lib is not None
        self._lib = lib
        self._h = lib.mxtpu_prefetch_open(path.encode(), capacity)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def __iter__(self):
        return self

    def __next__(self):
        if not self._h:
            raise ValueError("prefetcher is closed")
        out = ctypes.c_char_p()
        n = self._lib.mxtpu_prefetch_next(self._h, ctypes.byref(out))
        if n == -1:
            raise StopIteration
        if n < 0:
            raise IOError("corrupt recordio stream")
        return ctypes.string_at(out, n)

    def close(self):
        if self._h:
            self._lib.mxtpu_prefetch_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def csv_read(path: str):
    """Parse a numeric CSV into a float32 (rows, cols) numpy array."""
    import numpy as onp
    lib = get_lib()
    assert lib is not None
    rows = ctypes.c_longlong()
    cols = ctypes.c_longlong()
    rc = lib.mxtpu_csv_shape(path.encode(), ctypes.byref(rows),
                             ctypes.byref(cols))
    if rc == -2:
        raise ValueError(f"ragged CSV {path}")
    if rc != 0:
        raise OSError(f"cannot read {path}")
    out = onp.empty((rows.value, cols.value), dtype=onp.float32)
    n = lib.mxtpu_csv_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size)
    if n != out.size:
        raise ValueError(f"CSV parse error in {path} (parsed {n} of "
                         f"{out.size})")
    return out
