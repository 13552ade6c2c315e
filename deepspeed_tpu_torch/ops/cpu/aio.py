"""Async file I/O (DeepNVMe's Python surface): the counterpart of
``deepspeed_tpu/ops/cpu/aio.py`` over ``csrc/aio/aio_engine.cpp``.

An :class:`AsyncIOHandle` submits preads and pwrites of host buffers
against files (the NVMe spill of ZeRO-Infinity's optimizer moments) and
waits for them per op or all together.  ``backend="auto"`` takes the
io_uring engine and falls back to the worker-thread pool where io_uring
is unavailable, inside the C++ engine, as the JAX module does.
"""

from __future__ import annotations

import os

import numpy as np

from ..op_builder import AsyncIOBuilder

_BACKENDS = {"auto": 0, "threads": 1, "uring": 2}


class AsyncIOHandle:
    """One async-I/O queue; ``close()`` (or the garbage collector) stops its
    native threads."""

    def __init__(self, thread_count: int = 4, block_size: int = 1 << 20,
                 use_odirect: bool = False, backend: str = "auto"):
        if backend not in _BACKENDS:
            raise ValueError(f"aio backend {backend!r}: one of {sorted(_BACKENDS)}")
        self._lib = AsyncIOBuilder().load()
        self._h = self._lib.dstpu_aio_create_ex(thread_count, block_size, int(use_odirect),
                                                _BACKENDS[backend])
        if not self._h:
            raise OSError(f"aio: backend {backend!r} unavailable")
        self._bufs = {}  # op id -> the buffer, alive while the op may touch it

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dstpu_aio_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def async_pwrite(self, array: np.ndarray, path: str, offset: int = 0) -> int:
        buf = np.ascontiguousarray(array)
        op = self._lib.dstpu_aio_pwrite(self._h, os.fspath(path).encode(), buf.ctypes.data,
                                        buf.nbytes, offset)
        self._bufs[op] = buf
        return op

    def async_pread(self, array: np.ndarray, path: str, offset: int = 0) -> int:
        if not array.flags["C_CONTIGUOUS"]:
            raise ValueError("async_pread writes through the buffer's pointer: it must be "
                             "C-contiguous")
        op = self._lib.dstpu_aio_pread(self._h, os.fspath(path).encode(), array.ctypes.data,
                                       array.nbytes, offset)
        self._bufs[op] = array
        return op

    def drain(self) -> None:
        """Block until every submitted op completes; raises on I/O errors."""
        errs = self._lib.dstpu_aio_drain(self._h)
        self._bufs.clear()
        if errs:
            raise IOError(f"aio: {errs} operations failed")

    wait = drain  # the reference's name

    def wait_op(self, op_id: int) -> None:
        """Block until one submitted op completes."""
        err = self._lib.dstpu_aio_wait(self._h, op_id)
        self._bufs.pop(op_id, None)
        if err:
            raise IOError(f"aio: op {op_id} failed")

    @property
    def backend(self) -> str:
        return "uring" if self._lib.dstpu_aio_backend_kind(self._h) else "threads"

    def pending(self) -> int:
        return self._lib.dstpu_aio_pending(self._h)

