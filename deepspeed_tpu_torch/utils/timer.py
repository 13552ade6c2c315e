"""Wall-clock timers and throughput accounting (the port's copy of
``deepspeed_tpu/utils/timer.py``).

Analogue of the reference ``SynchronizedWallClockTimer`` / ``ThroughputTimer``
(``deepspeed/utils/timer.py``).  "Synchronized" means ``torch.cuda.synchronize``
on a card and nothing on the CPU, where the JAX package enqueues a tiny
program and blocks on it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .logging import logger

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


def _device_sync() -> None:
    """Block until previously launched device work completes: on a card,
    ``torch.cuda.synchronize`` of the current device; on the CPU every op
    has finished when it returns, so nothing to wait for."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    def __init__(self, name: str, sink=None):
        self.name = name
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self.count = 0
        #: optional ``(name, seconds)`` callback fired on every stop —
        #: how phase times reach the telemetry registry
        self.sink = sink

    def start(self):
        if self.started:
            return
        self.started = True
        self._start = time.perf_counter()

    def stop(self, sync: bool = False):
        if not self.started:
            return
        if sync:
            _device_sync()
        dt = time.perf_counter() - self._start
        self._elapsed += dt
        self.count += 1
        self.started = False
        if self.sink is not None:
            self.sink(self.name, dt)

    def elapsed(self, reset: bool = True) -> float:
        e = self._elapsed
        if reset:
            self._elapsed = 0.0
            self.count = 0
        return e

    def mean(self) -> float:
        return self._elapsed / max(1, self.count)


class SynchronizedWallClockTimer:
    def __init__(self, sink=None):
        self.timers: Dict[str, _Timer] = {}
        #: per-stop ``(name, seconds)`` callback installed on every timer
        self.sink = sink

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, sink=self.sink)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False) -> None:
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}ms")
        if parts:
            logger.info(" | ".join(parts))

    def get_mean(self, names: List[str]) -> Dict[str, float]:
        return {n: self.timers[n].mean() for n in names if n in self.timers}


class ThroughputTimer:
    """samples/sec + tokens/sec reporting (reference utils/timer.py:~200)."""

    def __init__(self, batch_size: int, steps_per_output: int = 10, monitor_memory=False,
                 logging_fn=None):
        self.batch_size = max(1, batch_size)
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or logger.info
        self.global_step_count = 0
        self.total_elapsed = 0.0
        self._start = None
        # per-window stats: the engine only DRAINS the device queue at the
        # reporting boundary, so a single step's dt is async-dispatch noise;
        # the window [boundary, boundary] is real wall time
        self._win_elapsed = 0.0
        self._win_steps = 0

    def start(self):
        self._start = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True):
        if self._start is None:
            return
        dt = time.perf_counter() - self._start
        self._start = None
        if global_step:
            self.global_step_count += 1
            self.total_elapsed += dt
            self._win_elapsed += dt
            self._win_steps += 1
            if report_speed and self.global_step_count % self.steps_per_output == 0:
                per_step = self._win_elapsed / max(self._win_steps, 1)
                win_sps = self._win_steps * self.batch_size / \
                    max(self._win_elapsed, 1e-9)
                self.logging(
                    f"step={self.global_step_count} "
                    f"samples/sec={win_sps:.2f} "
                    f"iter_time={per_step * 1000:.1f}ms")
                self._win_elapsed = 0.0
                self._win_steps = 0

    def avg_samples_per_sec(self) -> float:
        if self.total_elapsed == 0:
            return 0.0
        return self.global_step_count * self.batch_size / self.total_elapsed
