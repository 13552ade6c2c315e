"""SuperOffload: the host optimizer's per-leaf updates fanned out over a
pool of CPU workers — the counterpart of ``deepspeed_tpu/runtime/
superoffload/superoffload.py``.

The host update is the C++ SIMD op (``ops/cpu``), whose ctypes call
releases the GIL, so a thread pool runs leaves on several cores at once
with the arrays in this process's RAM.  The global norm (and clipping) is
taken before any task starts.  Each worker thread that spills to NVMe has
its own async-I/O handle: handles share no in-flight state, and the
moment dicts are written per key only.

The C++ ops are themselves OpenMP-parallel over a leaf, so
``cpu_worker_count`` workers each start OpenMP's team: the worker count
trades per-leaf parallelism for parallelism across leaves.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...utils.logging import logger
from ..zero.offload import HostOffloadedOptimizer


class SuperOffloadOptimizer(HostOffloadedOptimizer):
    """:class:`HostOffloadedOptimizer` with the update fanned out over CPU
    workers."""

    def __init__(self, abstract_params: Any, optimizer_config: Dict[str, Any],
                 grad_clip: float = 0.0, nvme_path: Optional[str] = None,
                 aio_threads: int = 4, cpu_worker_count: int = 4):
        super().__init__(abstract_params, optimizer_config, grad_clip, nvme_path, aio_threads,
                         shared_handles=False)
        self.cpu_worker_count = max(1, int(cpu_worker_count))
        self._pool = ThreadPoolExecutor(max_workers=self.cpu_worker_count,
                                        thread_name_prefix="superoffload-worker")
        self._tls = threading.local()
        self._handles_lock = threading.Lock()
        self._worker_handles: List[Any] = []
        logger.info(f"superoffload: {self.cpu_worker_count} CPU optimizer workers")

    def _worker_aio(self):
        aio = getattr(self._tls, "aio", None)
        if aio is None:
            from ...ops.cpu.aio import AsyncIOHandle

            aio = self._tls.aio = AsyncIOHandle(thread_count=1)
            with self._handles_lock:
                self._worker_handles.append(aio)
        return aio

    def step_leaves(self, start: int, grads: Sequence[np.ndarray], lr: float) -> None:
        def task(i: int, g: np.ndarray) -> None:
            if self.master[i].size != np.size(g):
                raise ValueError(f"grad/master size mismatch at leaf {i}")
            if self._nvme:
                aio = self._worker_aio()
                self._fetch_with(aio, i)
                self.cpu_adam.step(self.master[i], g, key=i, lr=lr)
                self._spill_with(aio, i)
            else:
                self.cpu_adam.step(self.master[i], g, key=i, lr=lr)

        futures = [self._pool.submit(task, start + k, g) for k, g in enumerate(grads)]
        for f in futures:
            f.result()  # raises a worker's exception here

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
        with self._handles_lock:
            for h in self._worker_handles:
                h.close()
            self._worker_handles.clear()

    close = shutdown
