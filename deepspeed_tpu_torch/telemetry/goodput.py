"""Run-level goodput/badput ledger (the port's copy of
``deepspeed_tpu/telemetry/goodput.py``; pure Python).

Classifies every second of engine lifetime into **productive step time**
versus badput buckets, as single-owner counters plus a
``goodput_fraction`` gauge:

* ``step``            — productive optimizer steps (an fp16 overflow-skip
  step still bought loss-scale adaptation: it counts as productive, not
  badput);
* ``compile``         — the port's compiles: ``nvcc`` kernel builds and
  CUDA-graph captures (``compile_sentinel.note_compile``); compile
  seconds are *subtracted* from whatever phase they interrupted so a
  second is never counted twice;
* ``checkpoint_save`` / ``checkpoint_load`` — checkpoint I/O (the
  existing ``checkpoint_save``/``checkpoint_load`` span sites);
* ``restart``         — preemption/kill recovery: auto-resume restore
  time plus **recompute** — steps re-run that a previous attempt of the
  same run already completed (union-of-attempts accounting, below);
* ``eval``            — ``eval_batch`` wall time;
* ``stall``           — steps the stall watchdog flagged (the whole
  flagged step is classified badput: a 3× step is dominated by the wait,
  and a split would be a model, not a measurement);
* ``idle``            — the unaccounted residual (init, data wait between
  steps, host work outside any tracked phase).

Union-of-attempts accounting
----------------------------
A preempted run is several *processes* (attempts) but one *run*. When a
``run_file`` is attached (``telemetry.goodput.run_file``; the engine
defaults it into the resilience ``save_dir``), the ledger persists a tiny
JSON union record every step: the highest completed global step across
all attempts (``high_water``), productive/recomputed step counts, and
per-bucket second totals. A later attempt that re-runs a step at or
below ``high_water`` classifies that step as ``restart`` badput (it is
recompute the kill bought, not training progress) — so summing
productive time across attempts matches an uninterrupted control run.

The per-step persist is one ~200-byte atomic rename; it only happens
when a ``run_file`` is attached (resilient runs), never on the plain
hot path.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, Optional

BUCKETS = ("step", "compile", "checkpoint_save", "checkpoint_load",
           "restart", "eval", "stall", "idle")

#: buckets persisted into the union run file (idle is a per-attempt
#: residual, recomputed at read time, so it is not unioned)
_RUN_BUCKETS = tuple(b for b in BUCKETS if b != "idle")


def _compile_seconds_total() -> float:
    """Process-wide compile seconds from the compile sentinel's stream
    (``nvcc`` builds and CUDA-graph captures)."""
    try:
        from .compile_sentinel import compile_counts

        return float(compile_counts()[1])
    except Exception:
        return 0.0


class GoodputLedger:
    """Single-owner badput accounting for one engine lifetime."""

    def __init__(self, registry=None, run_file: str = "",
                 now_fn: Callable[[], float] = time.monotonic):
        if registry is None:
            from .registry import get_registry

            registry = get_registry()
        self._now = now_fn
        self._start = now_fn()
        self._end: Optional[float] = None
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._published: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._productive_steps = 0
        self._recomputed_steps = 0
        self._override: Optional[str] = None
        # compile attribution: ``_compile_absorbed`` is what has been
        # attributed to the compile bucket so far; ``_compile_mark`` is
        # the process-wide compile-seconds reading at the last observe.
        # A phase only carves compile accrued SINCE the mark (the
        # compile that actually interrupted it) — compile from init or
        # idle gaps must not eat a later 5 ms step; it is swept into the
        # compile bucket at summary time instead.
        self._compile_absorbed = _compile_seconds_total()
        self._compile_mark = self._compile_absorbed
        self._m_seconds = registry.counter(
            "deepspeed_tpu_goodput_seconds_total",
            "engine lifetime classified into productive step time vs "
            "badput buckets (compile / checkpoint / restart+recompute / "
            "eval / stall / idle); buckets sum to lifetime",
            labelnames=("bucket",))
        self._m_fraction = registry.gauge(
            "deepspeed_tpu_goodput_fraction",
            "productive step seconds / engine lifetime seconds "
            "(goodput; 1 - sum of badput bucket shares)")
        self._run_file = ""
        self._run_base: Dict[str, object] = {}
        if run_file:
            self.attach_run_file(run_file)

    # ------------------------------------------------------- union run file
    def attach_run_file(self, path: str) -> None:
        """Join (or start) the cross-attempt union ledger at ``path``."""
        self._run_file = path
        self._run_base = {}
        try:
            with open(path) as f:
                self._run_base = json.load(f)
        # dstpu-lint: allow[swallow] first attempt (no file yet) or a
        # torn write from a killed attempt: start the union from zero
        except Exception:
            pass

    @property
    def high_water(self) -> int:
        """Highest global step completed by ANY attempt of this run."""
        base = int(self._run_base.get("high_water", 0) or 0)
        return base

    def _run_union(self) -> Dict[str, object]:
        base_b = self._run_base.get("buckets") or {}
        return {
            "high_water": max(self.high_water,
                              int(self._run_base.get("high_water", 0) or 0)),
            "productive_steps": (int(self._run_base.get(
                "productive_steps", 0) or 0) + self._productive_steps),
            "recomputed_steps": (int(self._run_base.get(
                "recomputed_steps", 0) or 0) + self._recomputed_steps),
            "attempts": int(self._run_base.get("attempts", 0) or 0) + 1,
            "buckets": {b: float(base_b.get(b, 0.0) or 0.0)
                        + self._totals[b] for b in _RUN_BUCKETS},
        }

    def _persist(self, high_water: int) -> None:
        if not self._run_file:
            return
        rec = self._run_union()
        rec["high_water"] = max(rec["high_water"], high_water)
        try:
            d = os.path.dirname(self._run_file)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = self._run_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self._run_file)
        # dstpu-lint: allow[swallow] accounting I/O must never kill a
        # training step; a missed persist is one stale union record
        except Exception:
            pass

    # --------------------------------------------------------- attribution
    def _take_compile(self, dt_s: float) -> float:
        """Carve the compile seconds that landed inside a ``dt_s``-long
        timed phase out of it (into the ``compile`` bucket), bounded by
        the phase itself AND by compile accrued since the last observe
        (a pile of init-time compile must not zero out later phases).
        ``dt_s=inf`` (the summary sweep) instead absorbs EVERYTHING not
        yet attributed — compile from init/idle gaps lands in the
        compile bucket rather than masquerading as idle."""
        total = _compile_seconds_total()
        if dt_s == float("inf"):
            comp = max(0.0, total - self._compile_absorbed)
        else:
            comp = min(max(0.0, dt_s), max(0.0, total - self._compile_mark))
        self._compile_absorbed += comp
        self._compile_mark = max(self._compile_mark, total)
        self._totals["compile"] += comp
        return comp

    def observe_step(self, dt_s: float, step: Optional[int] = None,
                     stalled: bool = False, skipped: bool = False) -> None:
        """Account one optimizer step's wall time.

        ``skipped`` (fp16 overflow) steps are deliberately productive.
        ``stalled`` steps are ``stall`` badput. A step at or below the
        run file's cross-attempt ``high_water`` is recompute →
        ``restart`` badput.
        """
        del skipped  # an overflow-skip step is productive by design
        dt_s = max(0.0, float(dt_s))
        with self._lock:
            dt_s -= self._take_compile(dt_s)
            recompute = (self._run_file != "" and step is not None
                         and step <= self.high_water)
            if stalled:
                self._totals["stall"] += dt_s
            elif recompute:
                self._totals["restart"] += dt_s
                self._recomputed_steps += 1
            else:
                self._totals["step"] += dt_s
                self._productive_steps += 1
            hw = self.high_water
            if step is not None and not recompute:
                hw = max(hw, int(step))
                self._run_base["high_water"] = hw
            self._persist(hw)

    def observe_phase(self, bucket: str, dt_s: float) -> None:
        """Account a non-step phase (``checkpoint_save`` /
        ``checkpoint_load`` / ``eval`` / ``restart``). An active
        :meth:`override` re-routes the seconds (auto-resume's
        checkpoint load is restart badput, not checkpoint I/O)."""
        if bucket not in BUCKETS or bucket in ("step", "idle"):
            raise ValueError(f"not an accountable badput bucket: {bucket!r}")
        dt_s = max(0.0, float(dt_s))
        with self._lock:
            dt_s -= self._take_compile(dt_s)
            self._totals[self._override or bucket] += dt_s

    @contextlib.contextmanager
    def override(self, bucket: str):
        """Re-route nested :meth:`observe_phase` calls into ``bucket``
        (resilience wraps auto-resume in ``override("restart")``)."""
        prev, self._override = self._override, bucket
        try:
            yield
        finally:
            self._override = prev

    # ------------------------------------------------------------ read-out
    def lifetime_seconds(self) -> float:
        end = self._end if self._end is not None else self._now()
        return max(0.0, end - self._start)

    def summary(self) -> Dict[str, object]:
        """Point-in-time classification. ``buckets`` (with the computed
        ``idle`` residual) sum to ``lifetime_seconds`` exactly."""
        with self._lock:
            lifetime = self.lifetime_seconds()
            # compiles that ran OUTSIDE any timed phase (an engine's
            # construction, a build between steps) happened during
            # otherwise-idle wall time
            self._take_compile(float("inf"))
            buckets = {b: self._totals[b] for b in BUCKETS if b != "idle"}
            accounted = sum(buckets.values())
            buckets["idle"] = max(0.0, lifetime - accounted)
            out = {
                "lifetime_seconds": lifetime,
                "buckets": buckets,
                "goodput_fraction": (buckets["step"] / lifetime
                                     if lifetime > 0 else 0.0),
                "productive_steps": self._productive_steps,
                "recomputed_steps": self._recomputed_steps,
            }
            if self._run_file:
                out["run"] = self._run_union()
            return out

    def publish(self) -> Dict[str, object]:
        """Fold the classification into the registry (delta-safe: the
        counters only ever move forward) and return the summary."""
        s = self.summary()
        with self._lock:
            for b, v in s["buckets"].items():
                delta = v - self._published[b]
                if delta > 0:
                    self._m_seconds.inc(delta, bucket=b)
                    self._published[b] = v
            self._m_fraction.set(s["goodput_fraction"])
        return s

    def close(self) -> Dict[str, object]:
        """Freeze the lifetime clock, final publish + run-file persist."""
        if self._end is None:
            self._end = self._now()
        s = self.publish()
        with self._lock:
            self._persist(self.high_water)
        return s


# ------------------------------------------------------- process default
_default: Optional[GoodputLedger] = None
_default_lock = threading.Lock()


def get_goodput_ledger() -> Optional[GoodputLedger]:
    """The process-default ledger (None until a Telemetry session with
    goodput enabled installs one) — resilience and the flight recorder
    reach it here without holding an engine reference."""
    return _default


def set_goodput_ledger(ledger: Optional[GoodputLedger]) -> None:
    global _default
    with _default_lock:
        _default = ledger


def last_goodput_summary() -> Optional[Dict[str, object]]:
    """Flight-dump hook: the process-default ledger's summary, or None."""
    led = _default
    if led is None:
        return None
    try:
        return led.summary()
    except Exception:
        return None
