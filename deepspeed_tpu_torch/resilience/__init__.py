"""Resilience subsystem (the port's counterpart of
``deepspeed_tpu/resilience/``): there is always a valid, durable,
discoverable checkpoint to restart from — and the tooling to prove it
under injected faults.

* **Verified atomic commits** (``commit.py``) — every checkpoint save
  stages into ``tmp.<tag>``, writes a checksum manifest, fsyncs, renames
  atomically, updates the ``latest`` pointer and GCs partial/stale tags;
  loads verify checksums and fall back to the previous good tag on
  corruption.
* **Preemption watcher + emergency save** (``preemption.py``) — SIGTERM
  /SIGINT (or a pluggable maintenance notice) requests an emergency
  checkpoint at the next step boundary; the process exits with the
  resumable code (75).
* **Auto-resume + retry/backoff** (:class:`ResilienceManager` below +
  the ``resilience`` config block) — the training engine resolves the
  latest *verified* checkpoint on startup and wraps checkpoint I/O in
  bounded exponential backoff.
* **Chaos harness** (``chaos.py``) — deterministic fault injectors.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from ..utils.logging import logger
from . import chaos, metrics
from .commit import (CommitError, CorruptCheckpointError, array_checksums, checkpoint_commit,
                     finalize_commit, gc_tags, io_retry, list_tags, resolve_tag, verify_tag)
from .preemption import (EXIT_CONFIG, EXIT_RESUMABLE, NON_RESUMABLE_EXIT_CODES,
                         PreemptionInterrupt, PreemptionWatcher, exit_code_for_exception)

__all__ = ["CommitError", "CorruptCheckpointError", "array_checksums", "checkpoint_commit",
           "finalize_commit", "gc_tags", "io_retry", "list_tags", "resolve_tag", "verify_tag",
           "EXIT_CONFIG", "EXIT_RESUMABLE", "NON_RESUMABLE_EXIT_CODES",
           "PreemptionInterrupt", "PreemptionWatcher", "exit_code_for_exception",
           "ResilienceManager", "chaos", "metrics"]


class ResilienceManager:
    """Engine-side glue for the ``resilience`` config block: owns the
    preemption watcher, performs startup auto-resume, and turns a
    pending preemption request into emergency-save + resumable exit at
    the step boundary the engine polls from ``train_batch``/``step``."""

    def __init__(self, config):
        self.config = config
        self.watcher = PreemptionWatcher(
            install_signals=bool(getattr(config, "watch_signals", True)))
        self._handling = False

    # -------------------------------------------------------------- resume
    def maybe_auto_resume(self, engine) -> Optional[str]:
        """Resolve + load the latest verified checkpoint through the
        engine's ``load_checkpoint``.  Returns the loaded path or None
        (fresh start)."""
        cfg = self.config
        if not (cfg.auto_resume and cfg.save_dir):
            return None
        # a recovery load is restart badput, not routine checkpoint I/O:
        # re-route the engine's checkpoint_load phase into the restart
        # bucket while the resume runs (no-op when no ledger is active)
        try:
            from ..telemetry.goodput import get_goodput_ledger

            gp = get_goodput_ledger()
            restart = (gp.override("restart") if gp is not None
                       else contextlib.nullcontext())
        # dstpu-lint: allow[swallow] accounting must never block a resume
        except Exception:
            restart = contextlib.nullcontext()
        with restart:
            path, _client = io_retry(
                lambda: engine.load_checkpoint(cfg.save_dir),
                retries=cfg.io_retries, base_delay_s=cfg.io_retry_base_s,
                what=f"auto-resume load from {cfg.save_dir}")
        if path is None:
            logger.info(f"resilience: no checkpoint in {cfg.save_dir}; "
                     "fresh start")
            return None
        metrics.restores_total().inc()
        logger.info(f"resilience: auto-resumed from {path} "
                 f"(step {engine.global_steps})")
        return path

    # ------------------------------------------------------ step boundary
    def at_step_boundary(self, engine) -> None:
        """Called by the engine after each completed optimizer step; on
        a pending preemption request: emergency-save, dump a flight
        incident, and raise :class:`PreemptionInterrupt` (exit code
        ``EXIT_RESUMABLE``)."""
        reason = self.watcher.requested
        if reason is None or self._handling:
            return
        self._handling = True  # a save failure must not re-enter forever
        try:
            saved = None
            if self.config.emergency_save and self.config.save_dir:
                saved = self.emergency_save(engine, reason)
            try:
                from ..telemetry.flight import get_flight_recorder

                fr = get_flight_recorder()
                if fr is not None:
                    fr.note("preemption_exit", reason=reason,
                            step=engine.global_steps,
                            checkpoint=saved or "")
                    fr.dump(reason="preemption")
            # dstpu-lint: allow[swallow] the flight dump is forensics; a
            # broken recorder must not mask the PreemptionInterrupt below
            except Exception:
                pass
            raise PreemptionInterrupt(reason)
        finally:
            self._handling = False

    def emergency_save(self, engine, reason: str) -> Optional[str]:
        """Best-effort checkpoint through the verified commit protocol;
        a failed emergency save still exits resumable (an older
        checkpoint remains the newest valid one)."""
        tag = f"emergency_step{engine.global_steps}"
        try:
            # engine.save_checkpoint already wraps the write in io_retry
            # when resilience is enabled — no second retry layer here
            path = engine.save_checkpoint(self.config.save_dir, tag=tag)
        except Exception as e:
            logger.error(f"resilience: emergency save {tag} failed ({e}); "
                         "exiting resumable on the previous checkpoint")
            return None
        metrics.emergency_saves_total().inc()
        logger.warning(f"resilience: emergency checkpoint {path} "
                       f"({reason})")
        return path

    def close(self) -> None:
        self.watcher.uninstall()
