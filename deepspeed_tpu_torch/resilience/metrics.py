"""Resilience metric families (the port's copy of
``deepspeed_tpu/resilience/metrics.py``).

Single registration site for every ``deepspeed_tpu_resilience_*`` name
on the process registry: the commit protocol, the resilience manager
and the retry helper all pull their counters from here.  Registration
is get-or-create, so these accessors are cheap to call on every event.
"""

from __future__ import annotations

from ..telemetry.registry import Counter, get_registry


def emergency_saves_total() -> Counter:
    return get_registry().counter(
        "deepspeed_tpu_resilience_emergency_saves_total",
        "emergency checkpoints written on preemption notice")


def restores_total() -> Counter:
    return get_registry().counter(
        "deepspeed_tpu_resilience_restores_total",
        "successful auto-resume restores from a verified checkpoint")


def corrupt_checkpoints_total() -> Counter:
    return get_registry().counter(
        "deepspeed_tpu_resilience_corrupt_checkpoints_total",
        "checkpoint tags that failed verification (torn manifest, "
        "checksum mismatch, missing files) and were skipped")


def io_retries_total() -> Counter:
    return get_registry().counter(
        "deepspeed_tpu_resilience_io_retries_total",
        "transient checkpoint-I/O failures retried with backoff")
