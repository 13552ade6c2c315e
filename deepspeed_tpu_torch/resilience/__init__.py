"""Resilience — the port's part of ``deepspeed_tpu/resilience/``: the
verified atomic checkpoint commit (``commit.py``), its counters
(``metrics.py``) and the fault injectors that prove it (``chaos.py``).
The preemption watcher, the emergency save and auto-resume
(``ResilienceManager``, the ``resilience`` config block) come with
ROADMAP Queue 1 #16."""

from . import chaos, metrics
from .commit import (CommitError, CorruptCheckpointError, array_checksums, checkpoint_commit,
                     finalize_commit, gc_tags, io_retry, list_tags, resolve_tag, verify_tag)

__all__ = ["CommitError", "CorruptCheckpointError", "array_checksums", "checkpoint_commit",
           "finalize_commit", "gc_tags", "io_retry", "list_tags", "resolve_tag", "verify_tag",
           "chaos", "metrics"]
