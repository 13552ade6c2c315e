"""Resilience counters — the port's copy of ``deepspeed_tpu/resilience/
metrics.py`` as plain process counters (the metrics registry comes with
ROADMAP Queue 1 #16).  The commit protocol and the retry helper count
here; each accessor returns the same counter on every call."""

from __future__ import annotations

import threading


class Counter:
    """A monotonically increasing, thread-safe count."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def total(self) -> float:
        with self._lock:
            return self._value


_COUNTERS = {
    "emergency_saves": Counter("deepspeed_tpu_resilience_emergency_saves_total",
                               "emergency checkpoints written on preemption notice"),
    "restores": Counter("deepspeed_tpu_resilience_restores_total",
                        "successful auto-resume restores from a verified checkpoint"),
    "corrupt": Counter("deepspeed_tpu_resilience_corrupt_checkpoints_total",
                       "checkpoint tags that failed verification (torn manifest, "
                       "checksum mismatch, missing files) and were skipped"),
    "io_retries": Counter("deepspeed_tpu_resilience_io_retries_total",
                          "transient checkpoint-I/O failures retried with backoff"),
}


def emergency_saves_total() -> Counter:
    return _COUNTERS["emergency_saves"]


def restores_total() -> Counter:
    return _COUNTERS["restores"]


def corrupt_checkpoints_total() -> Counter:
    return _COUNTERS["corrupt"]


def io_retries_total() -> Counter:
    return _COUNTERS["io_retries"]
