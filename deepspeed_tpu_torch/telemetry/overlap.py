"""Exposed-collective accounting: how much comm hides under compute (the
port's copy of ``deepspeed_tpu/telemetry/overlap.py``).

The port trains on one rank, where every report here is None (no
gradient exchange exists); the module is the single owner of the
arithmetic the engine's overlap gauges read once ZeRO across ranks
lands.

Two numbers, read from the engine's structural split of the gradient
exchange or from the span ring's collective events
(``grad_bucket_reduce`` / ``grad_tail_reduce``):

* ``overlapped_fraction`` — bytes-weighted share of the step's gradient
  exchange issued inside the backward loop, where it can hide under
  compute (1.0 = nothing is serialized after the backward).
* ``exposed_collective_seconds`` — an ESTIMATE of the wall time the
  non-overlapped bytes cost per step: wire bytes x the algorithmic bus
  factor over a nominal per-generation interconnect bandwidth.  It is a
  model, clearly labeled as one.

Engine gauges (single owner: ``runtime/engine.py``):
``deepspeed_tpu_train_overlapped_fraction`` and
``deepspeed_tpu_train_exposed_collective_seconds_estimated``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

#: nominal aggregate interconnect bytes/s per chip, keyed by device-kind
#: substring (first hit wins, specific before generic) — modeling
#: constants for the exposure ESTIMATE, not measured link rates.  The
#: CPU entry is a pinned nominal so the deterministic CPU tier produces
#: stable, clearly-not-a-chip numbers.  Override: DSTPU_ICI_BYTES_PER_S.
NOMINAL_ICI_BYTES_PER_S = {
    "TPU v5p": 450e9,
    "TPU v5 lite": 160e9,
    "TPU v5e": 160e9,
    "TPU v6 lite": 180e9,
    "TPU v6e": 180e9,
    "TPU v4": 270e9,
    "TPU v3": 140e9,
    "TPU v2": 100e9,
    "cpu": 10e9,
}


def interconnect_bytes_per_s(device_kind: str) -> float:
    """Nominal interconnect bandwidth for a device-kind string
    (``DSTPU_ICI_BYTES_PER_S`` wins)."""
    env = os.environ.get("DSTPU_ICI_BYTES_PER_S")
    if env:
        return float(env)
    kind = str(device_kind).lower()
    for name, bw in NOMINAL_ICI_BYTES_PER_S.items():
        if name.lower() in kind:
            return bw
    return NOMINAL_ICI_BYTES_PER_S["cpu"]


#: algorithmic bus factor per collective over an n-rank axis (the JAX
#: package's ``comm/comms_logger.py`` table; the port has no comm module yet)
_BUS_FACTORS = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "broadcast": lambda n: (n - 1) / n,
}


def bus_factor(op_name: str, n: int) -> float:
    """Algorithmic bus factor for ``op_name`` over an ``n``-rank axis."""
    if n <= 1:
        return 0.0
    return _BUS_FACTORS.get(op_name, lambda _n: 1.0)(n)


@dataclasses.dataclass
class OverlapReport:
    """One step's exposure split (bytes are per micro-step)."""

    total_bytes: int
    overlapped_bytes: int
    overlapped_fraction: float
    exposed_bytes: int
    #: estimated seconds the exposed bytes cost per optimizer step
    #: (bus-factor-scaled wire bytes over the nominal bandwidth)
    exposed_seconds_per_step: float
    bandwidth_bytes_per_s: float
    buckets: int
    #: in-loop codec of the compressed-overlap path ("int8"/"fp8"),
    #: None for the exact fp exchange (docs/COMM.md "Compressed overlap")
    compression: Optional[str] = None
    #: bytes of per-bucket error-feedback residual state in train state
    residual_bytes: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def structural_report(struct: Optional[Dict[str, int]], *, world: int,
                      device_kind: str = "cpu", gas: int = 1,
                      op: str = "all_reduce") -> Optional[OverlapReport]:
    """Exposure report from the engine's structural split
    (``engine._overlap_struct``: total/overlapped/tail grad bytes per
    micro-step + bucket count).  ``world``: data-axis rank count —
    the bus factor scales the exposed wire bytes; ``gas`` multiplies
    micro-steps per optimizer step."""
    if not struct or world <= 1:
        return None
    total = int(struct.get("total_bytes", 0))
    overlapped = int(struct.get("overlapped_bytes", 0))
    if total <= 0:
        return None
    exposed = total - overlapped
    bw = interconnect_bytes_per_s(device_kind)
    exposed_s = exposed * bus_factor(op, world) * int(gas) / bw
    return OverlapReport(
        total_bytes=total, overlapped_bytes=overlapped,
        overlapped_fraction=overlapped / total,
        exposed_bytes=exposed,
        exposed_seconds_per_step=exposed_s,
        bandwidth_bytes_per_s=bw,
        buckets=int(struct.get("buckets", 0)),
        compression=struct.get("compression"),
        residual_bytes=int(struct.get("residual_bytes", 0) or 0))


def report_from_spans(recorder=None, *, world: int, device_kind: str = "cpu",
                      gas: int = 1, op: str = "all_reduce"
                      ) -> Optional[OverlapReport]:
    """Exposure report from the span ring's trace-time collective
    events (``grad_bucket_reduce`` / ``grad_tail_reduce``) — the
    timeline view of what :func:`structural_report` computes from
    shapes.  Aggregates the LATEST traced program: events repeat per
    retrace, so bucket events are deduplicated by bucket index and the
    tail by its (single) owner site."""
    from .spans import get_span_recorder

    rec = recorder or get_span_recorder()
    buckets: Dict[int, int] = {}
    tail = None
    for sp in rec.spans():
        if sp.name == "grad_bucket_reduce":
            buckets[int(sp.attrs.get("bucket", 0))] = int(
                sp.attrs.get("bytes", 0))
        elif sp.name == "grad_tail_reduce":
            tail = int(sp.attrs.get("bytes", 0))
    if tail is None and not buckets:
        return None
    overlapped = sum(buckets.values())
    struct = {"total_bytes": overlapped + (tail or 0),
              "overlapped_bytes": overlapped, "buckets": len(buckets)}
    return structural_report(struct, world=world, device_kind=device_kind,
                             gas=gas, op=op)
