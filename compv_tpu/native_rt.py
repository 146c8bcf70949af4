"""ctypes bindings for the native runtime (native/compv_native.cpp).

The shared library is not kept in git: it is built from the source on first
use (g++ -O3 -shared) into native/libcompv_native.so, and rebuilt when the
source is newer. Falls back to pure-Python implementations if the toolchain
is unavailable, so the package never hard-fails. Public surface:
AlignedPool, PrefetchLoader, copy_strided.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["native_available", "AlignedPool", "PrefetchLoader", "copy_strided",
           "Executor", "md5_mat"]

_RANGE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_long,
                             ctypes.c_long, ctypes.c_int)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "compv_native.cpp")
_SO = os.path.join(_ROOT, "native", "libcompv_native.so")
_lib = None
_lock = threading.Lock()


def _build() -> bool:
    # build beside the target and rename into place, so concurrent first
    # uses (test workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.compv_pool_create.restype = ctypes.c_void_p
        lib.compv_pool_create.argtypes = [ctypes.c_size_t]
        lib.compv_pool_alloc.restype = ctypes.c_void_p
        lib.compv_pool_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.compv_pool_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.compv_pool_stats.restype = ctypes.c_uint64
        lib.compv_pool_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.compv_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.compv_loader_open.restype = ctypes.c_void_p
        lib.compv_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                          ctypes.c_int, ctypes.c_int]
        lib.compv_loader_num_frames.restype = ctypes.c_long
        lib.compv_loader_num_frames.argtypes = [ctypes.c_void_p]
        lib.compv_loader_next.restype = ctypes.c_long
        lib.compv_loader_next.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_uint8)]
        lib.compv_loader_close.argtypes = [ctypes.c_void_p]
        lib.compv_copy_strided.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t]
        lib.compv_executor_create.restype = ctypes.c_void_p
        lib.compv_executor_create.argtypes = [ctypes.c_int]
        lib.compv_executor_num_threads.restype = ctypes.c_int
        lib.compv_executor_num_threads.argtypes = [ctypes.c_void_p]
        lib.compv_executor_parallel_for.argtypes = [
            ctypes.c_void_p, _RANGE_FN, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_long, ctypes.c_int]
        lib.compv_executor_destroy.argtypes = [ctypes.c_void_p]
        lib.compv_md5_create.restype = ctypes.c_void_p
        lib.compv_md5_update.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_uint8),
                                         ctypes.c_size_t]
        lib.compv_md5_update_strided.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t]
        lib.compv_md5_final.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


class AlignedPool:
    """Aligned host-buffer pool (reference CompVMem pool, compv_mem.h:36-91).
    Buffers are reused by size bucket; stats expose hit/miss counts."""

    def __init__(self, alignment: int = 64):
        self._lib = _load()
        self._pool = (self._lib.compv_pool_create(alignment)
                      if self._lib else None)
        self._fallback = {}

    def alloc(self, size: int) -> np.ndarray:
        if self._pool:
            ptr = self._lib.compv_pool_alloc(self._pool, size)
            buf = (ctypes.c_uint8 * size).from_address(ptr)
            return np.frombuffer(buf, np.uint8)
        return np.empty(size, np.uint8)

    def release(self, arr: np.ndarray) -> None:
        # the frombuffer view's data pointer IS the pool pointer
        if self._pool:
            self._lib.compv_pool_release(
                self._pool, ctypes.c_void_p(arr.ctypes.data))

    def stats(self) -> dict:
        if not self._pool:
            return {"hits": 0, "misses": 0, "blocks": 0, "bytes": 0}
        s = self._lib.compv_pool_stats
        return {"hits": s(self._pool, 0), "misses": s(self._pool, 1),
                "blocks": s(self._pool, 2), "bytes": s(self._pool, 3)}

    def close(self) -> None:
        if self._pool:
            self._lib.compv_pool_destroy(self._pool)
            self._pool = None


class PrefetchLoader:
    """Background-thread raw-frame loader (native double-buffered IO). Use
    for .yuv frame sequences feeding the device: the read happens on the C++
    thread while the previous frame computes."""

    def __init__(self, path: str, height: int, width: int, channels: int = 1,
                 depth: int = 4, loop: bool = False,
                 pool: "AlignedPool | None" = None):
        self.shape = (height, width) if channels == 1 else (height, width, channels)
        self.frame_bytes = int(np.prod(self.shape))
        self._lib = _load()
        self._h = None
        self._py = None
        self._pool = pool
        if self._lib:
            self._h = self._lib.compv_loader_open(
                path.encode(), self.frame_bytes, depth, int(loop))
        if not self._h:
            # pure-python fallback
            self._py = open(path, "rb")
            self._py_frames = os.path.getsize(path) // self.frame_bytes
            self._py_next = 0
            self._loop = loop

    def __len__(self):
        if self._h:
            return int(self._lib.compv_loader_num_frames(self._h))
        return self._py_frames

    def release(self, frame: np.ndarray) -> None:
        """Return a frame's staging buffer to the pool (no-op without one).
        Only call once the frame's data is consumed (e.g. on device)."""
        if self._pool is not None:
            self._pool.release(frame.ravel())

    def next(self) -> np.ndarray | None:
        buf = (self._pool.alloc(self.frame_bytes) if self._pool is not None
               else np.empty(self.frame_bytes, np.uint8))
        if self._h:
            idx = self._lib.compv_loader_next(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if idx < 0:
                return None
            return buf.reshape(self.shape)
        if self._py_next >= self._py_frames:
            if not self._loop:
                return None
            self._py.seek(0)
            self._py_next = 0
        data = self._py.read(self.frame_bytes)
        self._py_next += 1
        return np.frombuffer(data, np.uint8).reshape(self.shape)

    def __iter__(self):
        while True:
            f = self.next()
            if f is None:
                return
            yield f

    def close(self):
        if self._h:
            self._lib.compv_loader_close(self._h)
            self._h = None
        if self._py:
            self._py.close()


class Executor:
    """Native fork-join thread pool (reference CompVThreadDispatcher11 —
    one pinned worker per core, static range splitting, nested-fork runs
    inline; base/parallel/compv_threaddisp11.cxx:18-46,65). Drives host-side
    pre/post processing around the XLA compute path.

    ``parallel_for(fn, begin, end, chunks)`` calls ``fn(b, e)`` on workers
    for disjoint sub-ranges and blocks until all complete. Falls back to a
    Python ThreadPoolExecutor when the native library is unavailable.
    """

    def __init__(self, n_threads: int = 0):
        self._lib = _load()
        self._h = (self._lib.compv_executor_create(n_threads)
                   if self._lib else None)
        self._py = None
        self._tl = threading.local()
        if not self._h:
            import concurrent.futures as cf
            self._py = cf.ThreadPoolExecutor(max_workers=n_threads or None)

    @property
    def num_threads(self) -> int:
        if self._h:
            return int(self._lib.compv_executor_num_threads(self._h))
        return self._py._max_workers

    def parallel_for(self, fn, begin: int, end: int, chunks: int = 0) -> None:
        if end <= begin:
            return
        if self._h:
            exc = []

            @_RANGE_FN
            def trampoline(_arg, b, e, _worker):
                try:
                    fn(int(b), int(e))
                except BaseException as err:  # noqa: BLE001 - re-raised below
                    exc.append(err)

            self._lib.compv_executor_parallel_for(
                self._h, trampoline, None, begin, end, chunks)
            if exc:
                raise exc[0]
            return
        if getattr(self._tl, "in_worker", False):
            fn(begin, end)  # nested fork runs inline (reference forbids it)
            return
        n = end - begin
        chunks = min(chunks or self.num_threads, n)
        per, extra = divmod(n, chunks)

        def run(b, e):
            self._tl.in_worker = True
            try:
                fn(b, e)
            finally:
                self._tl.in_worker = False

        futs, b = [], begin
        for c in range(chunks):
            e = b + per + (1 if c < extra else 0)
            futs.append(self._py.submit(run, b, e))
            b = e
        for f in futs:
            f.result()

    def close(self) -> None:
        if self._h:
            self._lib.compv_executor_destroy(self._h)
            self._h = None
        if self._py:
            self._py.shutdown()


def md5_mat(arr: np.ndarray, stride: int | None = None,
            row_bytes: int | None = None) -> str:
    """MD5 hex digest of a matrix, row-wise ignoring stride padding — the
    reference's golden-test hash (compv_tests_md5, tests_common.cxx:98-116).
    Native implementation; hashlib fallback."""
    a = np.ascontiguousarray(arr)
    flat = a.reshape(a.shape[0], -1).view(np.uint8) if a.ndim > 1 else \
        a.view(np.uint8).reshape(1, -1)
    rows, rb = flat.shape
    stride = stride if stride is not None else rb
    row_bytes = row_bytes if row_bytes is not None else rb
    lib = _load()
    if lib:
        h = lib.compv_md5_create()
        lib.compv_md5_update_strided(
            h, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            stride, row_bytes, rows)
        out = ctypes.create_string_buffer(33)
        lib.compv_md5_final(h, out)
        return out.value.decode()
    import hashlib
    h = hashlib.md5()
    raw = flat.tobytes()
    for r in range(rows):
        h.update(raw[r * stride: r * stride + row_bytes])
    return h.hexdigest()


def copy_strided(src: np.ndarray, src_stride: int, dst: np.ndarray,
                 dst_stride: int, row_bytes: int, rows: int) -> None:
    """Stride-removal copy (reference CompVImage::wrap)."""
    lib = _load()
    if lib:
        lib.compv_copy_strided(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src_stride,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dst_stride,
            row_bytes, rows)
        return
    for r in range(rows):
        dst[r * dst_stride: r * dst_stride + row_bytes] = \
            src[r * src_stride: r * src_stride + row_bytes]
