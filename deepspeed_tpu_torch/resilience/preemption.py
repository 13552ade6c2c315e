"""Preemption watcher + the exit-code contract (the port's copy of
``deepspeed_tpu/resilience/preemption.py``; signals and threading only).

Preemptible machines die by SIGTERM, not by exception.  The watcher
turns that signal (or a pluggable maintenance notice — a cloud posts one
before host maintenance; ``notify()`` is the injection point) into a
*request* that the training engine honors at the next step boundary:
emergency-save a checkpoint, dump a flight-recorder incident, and exit
with a distinguished **resumable** exit code.

Exit-code contract (sysexits.h conventions, the ones the JAX package's
elastic agent honors):

* ``EXIT_RESUMABLE`` (75, EX_TEMPFAIL) — preempted after an emergency
  save; relaunching will auto-resume.  The elastic agent relaunches
  WITHOUT consuming the failure-restart budget.
* ``EXIT_CONFIG`` (78, EX_CONFIG) — config validation failed; a
  relaunch would fail identically, so the agent stops immediately.
  ``exit_code_for_exception`` maps exceptions onto the contract for
  launcher scripts.
* anything else non-zero — a crash; the agent retries with exponential
  backoff up to ``max_restarts``.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional

from ..utils.logging import logger

#: preempted-but-resumable (EX_TEMPFAIL): relaunch and auto-resume
EXIT_RESUMABLE = 75
#: config validation error (EX_CONFIG): relaunching cannot help
EXIT_CONFIG = 78
#: exit codes the elastic agent must NOT relaunch on: config errors,
#: usage errors (argparse exits 2, sysexits EX_USAGE is 64)
NON_RESUMABLE_EXIT_CODES = (2, 64, EXIT_CONFIG)


class PreemptionInterrupt(SystemExit):
    """Raised at a step boundary after the emergency save.  SystemExit
    subclass: it sails past ``except Exception`` handlers and, left
    unhandled, terminates the process with the resumable exit code."""

    def __init__(self, reason: str = "preemption"):
        super().__init__(EXIT_RESUMABLE)
        self.reason = reason


def exit_code_for_exception(exc: BaseException) -> int:
    """Map an exception to the exit-code contract (for launcher-run
    training scripts: ``sys.exit(exit_code_for_exception(e))``)."""
    if isinstance(exc, SystemExit):
        if exc.code is None:
            return 0  # bare sys.exit() is a CLEAN exit, not a crash
        if isinstance(exc.code, bool) or not isinstance(exc.code, int):
            return 1  # sys.exit("message") convention
        return exc.code
    if isinstance(exc, (ValueError, TypeError)):
        return EXIT_CONFIG  # config/arg validation: retrying cannot help
    return 1


class PreemptionWatcher:
    """Listens for SIGTERM/SIGINT (and programmatic maintenance
    notices) and records the request; the engine polls ``requested`` at
    step boundaries.  Signal handlers only set a flag — all real work
    (emergency save, incident dump) happens on the training thread at a
    consistent point."""

    def __init__(self, install_signals: bool = True,
                 signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self._requested: Optional[str] = None
        self._lock = threading.Lock()
        self._prev: dict = {}
        if install_signals:
            self.install(signals)

    def install(self, signals: Iterable[int] = (signal.SIGTERM,
                                                signal.SIGINT)) -> None:
        if threading.current_thread() is not threading.main_thread():
            logger.warning("preemption watcher: not on the main thread; "
                           "signal handlers not installed (notify() still "
                           "works)")
            return
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError) as e:
                logger.warning(f"preemption watcher: cannot watch signal "
                               f"{sig}: {e}")

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        self.notify(f"signal:{name}")

    def notify(self, reason: str = "maintenance-notice") -> None:
        """Request an emergency checkpoint at the next step boundary.
        This is the pluggable entry point for maintenance-event pollers
        (and the chaos harness's simulated notice)."""
        with self._lock:
            first = self._requested is None
            if first:
                self._requested = reason
        if first:
            logger.warning(f"preemption watcher: {reason} — emergency "
                           "checkpoint at the next step boundary")
            try:
                from ..telemetry.flight import get_flight_recorder

                fr = get_flight_recorder()
                if fr is not None:
                    fr.note("preemption_notice", reason=reason)
            # dstpu-lint: allow[swallow] runs inside a signal handler; any
            # raise here would kill the process mid-step instead of at the
            # boundary
            except Exception:
                pass

    @property
    def requested(self) -> Optional[str]:
        """The pending preemption reason, or None."""
        return self._requested

    def clear(self) -> None:
        with self._lock:
            self._requested = None


__all__ = ["EXIT_RESUMABLE", "EXIT_CONFIG", "NON_RESUMABLE_EXIT_CODES",
           "PreemptionInterrupt", "PreemptionWatcher",
           "exit_code_for_exception"]
