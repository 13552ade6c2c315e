"""Step/phase annotations for ``torch.profiler`` (the port's counterpart of
``deepspeed_tpu/telemetry/tracing.py``).

``annotate`` and ``step_trace`` are ``torch.profiler.record_function``
ranges: outside a capture they cost a few microseconds and record
nothing; inside one they appear on the host timeline of the trace, on
the same clock as the device's kernels.  ``start_trace`` / ``stop_trace``
drive one ``torch.profiler.profile`` per process (CPU activity, and CUDA
activity when the capture is for the card) and write its Chrome trace
into the capture's directory, where ``timeline.py`` reads it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Optional, Tuple

import torch

from ..accelerator import default_device

#: the file ``stop_trace`` writes into the capture's directory
TRACE_FILE = "torch_trace.json"

#: the running capture: (profiler, directory), or None
_active: Optional[Tuple[Any, str]] = None


@contextlib.contextmanager
def _noop():
    yield


def profiler_available() -> bool:
    try:
        import torch.profiler  # noqa: F401

        return True
    except ImportError:
        return False


def step_trace(step_num: int, **kwargs):
    """``with step_trace(step): ...`` around one training/serving step: a
    ``step_<n>`` range in a profiler capture."""
    return torch.profiler.record_function(f"step_{int(step_num)}")


def annotate(name: str, **kwargs):
    """``with annotate("fwd"): ...`` around a phase inside a step."""
    return torch.profiler.record_function(name)


def start_trace(log_dir: str, device: Any = None) -> bool:
    """Start a profiler capture writing into ``log_dir`` at ``stop_trace``.
    ``device``: the device whose work to record (None: CUDA when a card is
    present); CUDA activity is recorded only for a CUDA device.  False
    when a capture, this module's or another ``torch.profiler`` session,
    is already running."""
    global _active
    if _active is not None or torch._C._autograd._profiler_enabled():
        return False
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device) if device is not None else default_device()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _active = (prof, log_dir)
    return True


def stop_trace() -> Optional[str]:
    """Stop the running capture and write its Chrome trace; the file's
    path, or None when no capture was running."""
    global _active
    if _active is None:
        return None
    prof, log_dir = _active
    _active = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


class PhaseTimer:
    """Context manager that annotates a phase for the profiler, reports
    its host wall time to a callback (usually a histogram ``observe``),
    and records the range as a span (cat ``phase``) in the trace ring —
    one context, three sinks.  ``attrs`` ride on the span only."""

    def __init__(self, name: str, sink=None, **attrs):
        self.name = name
        self.sink = sink
        self.attrs = attrs
        self._ann = None
        self._t0: Optional[float] = None
        self._t0_us: float = 0.0

    def __enter__(self):
        self._ann = annotate(self.name)
        self._ann.__enter__()
        from .spans import _notify_phase, _now_us

        _notify_phase(self.name, "enter")
        self._t0_us = _now_us()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._ann.__exit__(*exc)
        if self.sink is not None:
            self.sink(self.name, dt)
        from .spans import _notify_phase, get_span_recorder

        _notify_phase(self.name, "exit")
        rec = get_span_recorder()
        if rec.enabled:
            rec.record(self.name, self._t0_us, dt * 1e6, cat="phase",
                       **self.attrs)
        return False
