"""Recompilation sentinel (the port's counterpart of
``deepspeed_tpu/telemetry/compile_sentinel.py``).

The JAX package counts XLA backend compiles through a ``jax.monitoring``
listener.  The port compiles in two places, and each reports to this
module's own process-wide compile stream through :func:`note_compile`:

* a CUDA-graph capture of a decode, multi-step or verify program
  (``inference/v2/captured.py``; every engine captures its programs at
  construction), kind ``cuda_graph``;
* an ``nvcc`` build of a kernel library at first use
  (``ops/op_builder.py``), kind ``nvcc``.

Each event counts into ``deepspeed_tpu_compiles_total`` and the
``deepspeed_tpu_compile_seconds`` histogram (the reference's names and
help strings, no label) and records a span (cat ``compile``) carrying
the kind.  :class:`RecompileSentinel` attributes compiles to steps
exactly as in JAX: each engine feeds its step's signature parts to
``observe_step``, which classifies a compile as **expected** (a part
never seen before, or an announced rebuild: ``expect_recompile``) or
**steady-state** (same parts, still compiled) and warns on the latter.
An eager prefill compiles nothing; its ``(prefill, bucket)`` parts go
into the signature all the same, so a new bucket reads as expected.

A sentinel with ``monitoring`` False falls back to the signature alone (a
never-seen part counts as one recompile; steady-state recompiles are then
invisible), as the JAX sentinel does without ``jax.monitoring``.

Everything is host-side bookkeeping.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Hashable, Iterable, Optional, Tuple, Union

from ..utils.logging import logger
from .registry import MetricsRegistry, get_registry
from .spans import get_span_recorder

#: compile times run sub-second (a graph capture) to minutes (a kernel
#: library build) — the default latency buckets top out too low
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0, 300.0, 600.0)

_lock = threading.Lock()
_compile_count = 0
_compile_time_total = 0.0
#: compiles already attributed to some step by SOME sentinel: observe_step
#: claims its delta here so co-located loops (train + serve in one
#: process) never each count the same compile.  Attribution to the
#: *right* loop is still best-effort — the process-wide stream carries no
#: per-compile context — so a compile can land on whichever loop observes
#: first; it just cannot land twice.
_claimed = 0

#: live sentinels, notified of announced rebuilds (weak: engines own them)
_SENTINELS: "weakref.WeakSet[RecompileSentinel]" = weakref.WeakSet()


def _compile_metrics(reg: MetricsRegistry):
    return (reg.counter("deepspeed_tpu_compiles_total",
                        "XLA backend compiles observed via jax.monitoring"),
            reg.histogram("deepspeed_tpu_compile_seconds",
                          "wall time of each XLA backend compile",
                          buckets=COMPILE_BUCKETS))


def note_compile(kind: str, seconds: float) -> None:
    """One compile of the process: a CUDA-graph capture (``kind``
    ``"cuda_graph"``) or a kernel library build (``"nvcc"``) that took
    ``seconds``.  Never raises: a telemetry hiccup must not break the
    capture or the build that reports it."""
    global _compile_count, _compile_time_total
    with _lock:
        _compile_count += 1
        _compile_time_total += float(seconds)
    try:
        total, hist = _compile_metrics(get_registry())
        total.inc()
        hist.observe(float(seconds))
        rec = get_span_recorder()
        if rec.enabled:
            from .spans import _now_us

            dur_us = float(seconds) * 1e6
            rec.record("compile", _now_us() - dur_us, dur_us, cat="compile",
                       kind=kind, seconds=float(seconds))
    # dstpu-lint: allow[swallow] the compile stream runs inside every
    # capture and build; a telemetry hiccup must never break them
    except Exception:
        pass


def compile_counts() -> Tuple[int, float]:
    """(process compile count, total compile seconds) so far."""
    with _lock:
        return _compile_count, _compile_time_total


def expect_recompile(reason: str = "") -> None:
    """Announce a deliberate rebuild (or out-of-program work the JAX
    package compiles op by op: a KV export, import, spill or restore) to
    every live sentinel so the next step's compile is not flagged as a
    steady-state recompilation."""
    for s in list(_SENTINELS):
        s.expect_recompile(reason)


Signature = Union[Hashable, Iterable[Hashable]]


class RecompileSentinel:
    """Per-loop compile attribution over the process compile stream
    (unchanged from the JAX package).

    ``observe_step(signature)`` once per step, AFTER the step's dispatch
    (host-side; the signature is built from arg shapes, never device
    values).  ``signature`` is one hashable token or an iterable of
    component tokens — a step whose work mixes programs (serving:
    prefill buckets + decode) passes the component set, so a new bucket
    alone explains a compile without resetting the whole signature."""

    def __init__(self, loop: str = "train",
                 registry: Optional[MetricsRegistry] = None,
                 steady_after: int = 3):
        self.loop = loop
        self.steady_after = max(0, int(steady_after))
        #: the port's compile stream always exists (note_compile); set
        #: False to attribute by signature alone
        self.monitoring = True
        reg = registry or get_registry()
        _compile_metrics(reg)  # the families exist before the first compile
        self._m_recompiles = reg.counter(
            "deepspeed_tpu_recompiles_total",
            "steps that triggered XLA compilation", labelnames=("loop",))
        self._m_steady = reg.counter(
            "deepspeed_tpu_steady_recompiles_total",
            "steady-state steps that recompiled with unchanged shapes",
            labelnames=("loop",))
        self._seen: set = set()
        #: steps since the last signature change or announced re-jit —
        #: NOT since the last recompile: the worst pathology (a recompile
        #: on EVERY step with unchanged shapes) must keep counting as
        #: steady, or it could never reach the warn threshold
        self._steady_steps = 0
        #: incident-edge latch: a sustained steady-recompile run counts
        #: every step but logs once (a wedged loop must not flood the log)
        self._in_steady = False
        self._expected: Optional[str] = None
        _SENTINELS.add(self)

    def expect_recompile(self, reason: str = "") -> None:
        global _claimed
        self._expected = reason or "announced"
        # pre-claim compiles up to the announcement: eager re-jit work
        # between now and the next step belongs to the announcement, for
        # every sentinel (compiles are a process-wide stream)
        with _lock:
            _claimed = _compile_count

    @staticmethod
    def _parts(signature: Signature) -> Tuple[Hashable, ...]:
        if isinstance(signature, (tuple, list, set, frozenset)):
            return tuple(signature)
        return (signature,)

    def observe_step(self, signature: Signature,
                     step: Optional[Any] = None) -> bool:
        """Record one step; True when the step triggered compilation."""
        global _claimed
        parts = self._parts(signature)
        new = [p for p in parts if p not in self._seen]
        self._seen.update(new)
        if self.monitoring:
            # claim this window's compiles so a co-located sentinel
            # cannot attribute the same ones to its own next step
            with _lock:
                delta = _compile_count - _claimed
                _claimed = _compile_count
            recompiled = delta > 0
        else:  # shape-signature fallback: a fresh shape implies a compile
            delta = len(new)
            recompiled = bool(new)
        expected = bool(new) or self._expected is not None
        if expected:
            # signature change / announced re-jit: restart the steady
            # window — compiles are explainable until it refills
            self._steady_steps = 0
        if not recompiled:
            self._steady_steps += 1
            self._in_steady = False
            self._expected = None
            return False
        self._m_recompiles.inc(loop=self.loop)
        rec = get_span_recorder()
        if rec.enabled:
            rec.event("recompile", cat="compile", loop=self.loop,
                      step=step, compiles=delta, expected=expected,
                      reason=(self._expected or
                              ("new_shapes" if new else "steady_state")),
                      signature=str(new or list(parts))[:256])
        if not expected and self._steady_steps >= self.steady_after:
            self._m_steady.inc(loop=self.loop)
            if not self._in_steady:  # log the incident edge only
                logger.warning(
                    f"recompile sentinel [{self.loop}]: step"
                    f"{'' if step is None else ' ' + str(step)} triggered "
                    f"{delta} compile(s) after {self._steady_steps} "
                    f"steady steps with UNCHANGED program parts "
                    f"{str(list(parts))[:256]} — suspect a lazy CUDA-graph "
                    f"capture or a kernel built on the hot path")
            self._in_steady = True
        # unchanged shapes: the steady window keeps growing THROUGH a
        # steady recompile, so an every-step recompile loop stays
        # counted instead of resetting itself below the threshold
        self._steady_steps += 1
        self._expected = None
        return True

    @property
    def recompiles(self) -> float:
        return self._m_recompiles.value(loop=self.loop)

    @property
    def steady_recompiles(self) -> float:
        return self._m_steady.value(loop=self.loop)
