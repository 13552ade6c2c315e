"""Serving telemetry (the port's counterpart of ``deepspeed_tpu/telemetry``).

One process-local :class:`MetricsRegistry` (``registry.py``) is the
single sink for serving metrics; ``exporter.py`` gives it two wire
formats (Prometheus text, JSONL events); ``spans.py`` records host
spans into a ring dumped as a Chrome trace; ``tracing.py`` annotates
steps and phases for ``torch.profiler``; ``compile_sentinel.py`` counts
the CUDA-graph captures and kernel builds and attributes them to steps;
``memory.py`` attributes the caching allocator's bytes to the engines'
weights and KV pools; ``timeline.py`` splits a captured step's wall time
over the kernels ``torch.profiler`` saw; ``reqtrace.py`` keeps each
request's phase ledger and the SLO exemplars; ``flight.py`` dumps a
black box when a step raises.

The ``Telemetry`` bundle behind the training config's ``telemetry``
block, goodput, numerics, the watchdog and MFU come with ROADMAP
"Training telemetry and resilience".
"""

from __future__ import annotations

from .compile_sentinel import (RecompileSentinel, compile_counts,
                               expect_recompile, note_compile)
from .exporter import (JSONLWriter, PrometheusFileExporter,
                       PrometheusHTTPExporter, parse_prometheus_text,
                       record_export_failure, snapshot_metrics,
                       to_prometheus_text)
from .flight import (FlightRecorder, dump_on_exception, get_flight_recorder,
                     install_flight_recorder)
from .memory import (MemoryLedger, get_memory_ledger, is_resource_exhausted,
                     oom_hints, record_oom_incident, set_memory_ledger,
                     top_live_buffers)
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, get_registry, set_registry)
from .reqtrace import (ReqTraceLedger, RequestTrace, get_reqtrace_ledger,
                       last_reqtrace_summary, merged_trace_events,
                       set_reqtrace_ledger, slo_exemplar,
                       write_merged_trace)
from .spans import (SpanRecorder, begin_span, configure_spans, end_span,
                    get_span_recorder, record_event, set_span_recorder, span,
                    trace_dump)
from .timeline import (StepTimeline, capture_thunk, categorize_op,
                       decompose_events, last_timeline_record)
from .tracing import PhaseTimer, annotate, profiler_available, step_trace

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "get_registry", "set_registry",
    "to_prometheus_text", "parse_prometheus_text", "snapshot_metrics",
    "PrometheusFileExporter", "PrometheusHTTPExporter", "JSONLWriter",
    "record_export_failure",
    "step_trace", "annotate", "PhaseTimer", "profiler_available",
    "SpanRecorder", "span", "begin_span", "end_span", "record_event",
    "trace_dump", "get_span_recorder", "set_span_recorder", "configure_spans",
    "FlightRecorder", "get_flight_recorder", "install_flight_recorder",
    "dump_on_exception",
    "MemoryLedger", "get_memory_ledger", "set_memory_ledger",
    "is_resource_exhausted", "record_oom_incident", "oom_hints",
    "top_live_buffers",
    "RecompileSentinel", "expect_recompile", "compile_counts", "note_compile",
    "StepTimeline", "capture_thunk", "categorize_op", "decompose_events",
    "last_timeline_record",
    "RequestTrace", "ReqTraceLedger", "get_reqtrace_ledger",
    "set_reqtrace_ledger", "slo_exemplar", "last_reqtrace_summary",
    "merged_trace_events", "write_merged_trace",
]
