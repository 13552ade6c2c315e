"""Stall watchdog (the port's copy of ``deepspeed_tpu/telemetry/watchdog.py``,
pure Python, unchanged).

Flags training/serving steps whose wall time exceeds a multiple of the
rolling median — the cheap host-side tripwire for wedged collectives,
background-thread convoys, host-offload hiccups, or a preemption storm.
A stall increments ``deepspeed_tpu_stalled_steps_total``, records the
overrun ratio, and logs once per incident (not once per slow step in a
sustained stall — a wedged chip would otherwise flood the log).
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional

from ..utils.logging import logger
from .registry import MetricsRegistry, get_registry


class StallWatchdog:
    def __init__(self, multiple: float = 3.0, window: int = 32,
                 min_samples: int = 5, name: str = "train",
                 registry: Optional[MetricsRegistry] = None,
                 on_stall=None):
        if multiple <= 1.0:
            raise ValueError(f"stall multiple must be > 1, got {multiple}")
        self.multiple = float(multiple)
        self.min_samples = int(min_samples)
        self.name = name
        #: ``(name, step, ratio)`` callback fired once per incident edge
        #: (with the log line, not per slow step) — how a stall reaches
        #: the flight recorder.  Exceptions are swallowed: a broken sink
        #: must not turn a slow step into a dead run.
        self.on_stall = on_stall
        self._times = collections.deque(maxlen=int(window))
        self._in_stall = False
        reg = registry or get_registry()
        self._stalls = reg.counter(
            "deepspeed_tpu_stalled_steps_total",
            "steps exceeding the stall-watchdog rolling-median multiple",
            labelnames=("loop",))
        self._ratio = reg.gauge(
            "deepspeed_tpu_stall_ratio",
            "last step time over rolling median (1.0 = nominal)",
            labelnames=("loop",))

    def observe(self, step_time_s: float, step: Optional[int] = None) -> bool:
        """Record one step's wall time; True if it rates as a stall.

        The median is computed over PREVIOUS steps only, so one huge
        outlier cannot mask itself by dragging the median up before it
        is judged."""
        stalled = False
        if len(self._times) >= self.min_samples:
            med = statistics.median(self._times)
            ratio = step_time_s / med if med > 0 else 1.0
            self._ratio.set(ratio, loop=self.name)
            if ratio > self.multiple:
                stalled = True
                self._stalls.inc(loop=self.name)
                if not self._in_stall:  # log the incident edge only
                    logger.warning(
                        f"stall watchdog [{self.name}]: step"
                        f"{'' if step is None else ' ' + str(step)} took "
                        f"{step_time_s * 1e3:.1f}ms, {ratio:.1f}x the "
                        f"rolling median ({med * 1e3:.1f}ms)")
                    if self.on_stall is not None:
                        try:
                            self.on_stall(self.name, step, ratio)
                        except Exception as e:
                            logger.error(f"stall watchdog [{self.name}]: "
                                         f"on_stall callback failed: {e}")
                self._in_stall = True
            else:
                self._in_stall = False
        self._times.append(step_time_s)
        return stalled

    @property
    def stall_count(self) -> float:
        return self._stalls.value(loop=self.name)
