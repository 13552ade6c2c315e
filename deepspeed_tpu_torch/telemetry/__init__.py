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
black box when a step raises or stalls.  For training: ``mfu.py`` owns
the peak-FLOPs table, ``watchdog.py`` flags stalled steps,
``goodput.py`` classifies the run's seconds, ``numerics.py`` watches
training health and ``overlap.py`` the gradient exchange's exposure.
``Telemetry`` below bundles them behind the ``telemetry`` config block
(``runtime/config.py``) so the training engine wires them with one
object.
"""

from __future__ import annotations

from typing import Any, Optional

from .compile_sentinel import (RecompileSentinel, compile_counts,
                               expect_recompile, note_compile)
from .exporter import (JSONLWriter, PrometheusFileExporter,
                       PrometheusHTTPExporter, parse_prometheus_text,
                       record_export_failure, snapshot_metrics,
                       to_prometheus_text)
from .flight import (FlightRecorder, dump_on_exception, get_flight_recorder,
                     install_flight_recorder)
from .goodput import (GoodputLedger, get_goodput_ledger, last_goodput_summary,
                      set_goodput_ledger)
from .memory import (MemoryLedger, get_memory_ledger, is_resource_exhausted,
                     oom_hints, record_oom_incident, set_memory_ledger,
                     top_live_buffers)
from .mfu import (PEAK_BF16_FLOPS, mfu, peak_flops_for_device,
                  peak_flops_for_kind)
from .numerics import (NumericsLedger, compare_rank_checksums,
                       get_numerics_ledger, last_numerics_summary,
                       set_numerics_ledger)
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
from .watchdog import StallWatchdog

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
    "PEAK_BF16_FLOPS", "peak_flops_for_kind", "peak_flops_for_device", "mfu",
    "StepTimeline", "capture_thunk", "categorize_op", "decompose_events",
    "last_timeline_record",
    "GoodputLedger", "get_goodput_ledger", "set_goodput_ledger",
    "last_goodput_summary",
    "NumericsLedger", "get_numerics_ledger", "set_numerics_ledger",
    "last_numerics_summary", "compare_rank_checksums",
    "RequestTrace", "ReqTraceLedger", "get_reqtrace_ledger",
    "set_reqtrace_ledger", "slo_exemplar", "last_reqtrace_summary",
    "merged_trace_events", "write_merged_trace",
    "StallWatchdog", "Telemetry",
]


class Telemetry:
    """Config-driven export bundle: the engines create one of these from
    the ``telemetry`` config block and call ``export(step)`` at their
    reporting cadence and ``close()`` at teardown.

    Holds: the registry (shared process default unless injected), the
    optional Prometheus file/HTTP exporters, the optional JSONL log, the
    stall watchdog, and the timeline side — span-ring configuration, the
    flight recorder (installed as the process recorder so exception
    paths and the watchdog can dump), and the recompilation sentinel.
    All parts are individually optional — an empty config block yields a
    registry-only session.  ``device``: the device whose steps the
    timeline captures (the training engine's)."""

    def __init__(self, config=None, loop: str = "train",
                 registry: Optional[MetricsRegistry] = None, device: Any = None):
        self.config = config
        self.registry = registry or get_registry()
        self.loop = loop
        self.jsonl: Optional[JSONLWriter] = None
        self.prom_file: Optional[PrometheusFileExporter] = None
        self.prom_http: Optional[PrometheusHTTPExporter] = None
        self.watchdog: Optional[StallWatchdog] = None
        self.flight: Optional[FlightRecorder] = None
        self.sentinel: Optional[RecompileSentinel] = None
        self.ledger: Optional[MemoryLedger] = None
        self.timeline: Optional[StepTimeline] = None
        self.goodput: Optional[GoodputLedger] = None
        self.numerics: Optional[NumericsLedger] = None
        self.export_interval = 1
        self.trace_annotations = True
        self._last_export: Optional[int] = None
        if config is None:
            return
        self.export_interval = max(1, int(getattr(config, "export_interval", 1)))
        self.trace_annotations = bool(getattr(config, "trace_annotations", True))
        if getattr(config, "jsonl_path", ""):
            self.jsonl = JSONLWriter(config.jsonl_path)
        if getattr(config, "prometheus_path", ""):
            self.prom_file = PrometheusFileExporter(config.prometheus_path,
                                                    self.registry)
        if getattr(config, "prometheus_port", 0):
            self.prom_http = PrometheusHTTPExporter(
                port=config.prometheus_port, registry=self.registry).start()
        sp = getattr(config, "spans", None)
        if sp is not None:
            configure_spans(enabled=sp.enabled, ring_size=sp.ring_size,
                            profiler_annotations=sp.profiler_annotations)
        fr = getattr(config, "flight_recorder", None)
        if fr is not None and getattr(fr, "enabled", False):
            self.flight = FlightRecorder(path=fr.path, max_events=fr.events,
                                         registry=self.registry)
            install_flight_recorder(self.flight)
        mem = getattr(config, "memory", None)
        if mem is not None and getattr(mem, "enabled", False):
            # process-default ledger: engines attach their components to
            # it and flight dumps read it; the phase watch samples
            # occupancy watermarks at span boundaries.  Our registry is
            # passed so a FIRST-created ledger binds its gauges where
            # this session's exporters will look.
            self.ledger = get_memory_ledger(self.registry)
            self.ledger.top_buffers = int(getattr(mem, "top_buffers", 10))
            self.ledger.install_phase_watch()
        rs = getattr(config, "recompile_sentinel", None)
        if rs is not None and getattr(rs, "enabled", False):
            self.sentinel = RecompileSentinel(
                loop=loop, registry=self.registry,
                steady_after=rs.steady_after)
        wd = getattr(config, "stall_watchdog", None)
        if wd is not None and getattr(wd, "enabled", False):
            self.watchdog = StallWatchdog(multiple=wd.multiple,
                                          window=wd.window, name=loop,
                                          registry=self.registry,
                                          on_stall=self._on_stall)
        tl = getattr(config, "timeline", None)
        if tl is not None and getattr(tl, "enabled", False):
            self.timeline = StepTimeline(
                every_n_steps=getattr(tl, "every_n_steps", 0),
                artifact_dir=getattr(tl, "artifact_dir", ""),
                registry=self.registry, device=device)
        gp = getattr(config, "goodput", None)
        if gp is not None and getattr(gp, "enabled", False):
            self.goodput = GoodputLedger(
                registry=self.registry,
                run_file=getattr(gp, "run_file", ""))
            # process default: resilience (auto-resume reclassification)
            # and flight dumps reach the ledger without an engine handle
            set_goodput_ledger(self.goodput)
        nm = getattr(config, "numerics", None)
        if nm is not None and getattr(nm, "enabled", False):
            self.numerics = NumericsLedger(nm, registry=self.registry)
            # process default: flight dumps and checkpoint commits reach
            # the sentinel without an engine handle
            set_numerics_ledger(self.numerics)

    def _on_stall(self, name: str, step, ratio: float) -> None:
        """Watchdog incident edge -> flight-recorder dump (black box for
        a run that is wedging rather than crashing)."""
        if self.flight is not None:
            self.flight.note("stall", loop=name, step=step, ratio=ratio)
            self.flight.dump(reason=f"watchdog:{name}")

    def step_trace(self, step_num: int):
        """Profiler step annotation (no-op context when disabled)."""
        if not self.trace_annotations:
            from .tracing import _noop

            return _noop()
        return step_trace(step_num)

    def observe_step_time(self, dt_s: float, step: Optional[int] = None) -> bool:
        """Feed the stall watchdog; True when the step rates as a stall."""
        if self.watchdog is None:
            return False
        return self.watchdog.observe(dt_s, step)

    def export(self, step: int, force: bool = False) -> None:
        """Write the configured sinks at the configured cadence.

        Cadence is steps SINCE THE LAST EXPORT, not ``step %
        interval`` — callers invoke this at their own reporting
        boundaries (e.g. steps_per_print), and a modulo gate would
        stretch the effective cadence to the lcm of the two strides
        (steps_per_print=7, interval=10 -> an export every 70 steps)."""
        if not force:
            if (self._last_export is not None
                    and step - self._last_export < self.export_interval):
                return
        self._last_export = step
        if self.goodput is not None:
            try:
                self.goodput.publish()
            # dstpu-lint: allow[swallow] accounting must never break an
            # export boundary; the next publish retries the fold
            except Exception:
                pass
        if self.prom_file is None and self.jsonl is None:
            return
        # a broken sink (full disk, torn mount) must never raise out of
        # the boundary-cadence export into the train/serve step: warn
        # once + count, keep stepping (exporter.record_export_failure)
        with span("telemetry_export", step=step):
            if self.prom_file is not None:
                try:
                    self.prom_file.write()
                except Exception as e:
                    record_export_failure("prometheus_file", e,
                                          self.registry)
            if self.jsonl is not None:
                try:
                    self.jsonl.emit_snapshot(self.registry, step=step)
                except Exception as e:
                    record_export_failure("jsonl", e, self.registry)

    def close(self) -> None:
        if self.goodput is not None:
            try:
                self.goodput.close()  # freeze lifetime, final publish
            # dstpu-lint: allow[swallow] teardown must release the other
            # sinks below even when the final publish/persist fails
            except Exception:
                pass
            if get_goodput_ledger() is self.goodput:
                set_goodput_ledger(None)
        if self.numerics is not None \
                and get_numerics_ledger() is self.numerics:
            set_numerics_ledger(None)
        for sink, part in (("prometheus_file", self.prom_file),
                           ("prometheus_http", self.prom_http),
                           ("jsonl", self.jsonl)):
            if part is not None:
                try:
                    part.close()
                except Exception as e:
                    # engine.close() must release every other sink too —
                    # count + warn-once, never raise out of teardown
                    record_export_failure(sink, e, self.registry)
        # release the process flight-recorder slot if it is ours (a later
        # engine's Telemetry installs its own)
        if self.flight is not None and get_flight_recorder() is self.flight:
            install_flight_recorder(None)

