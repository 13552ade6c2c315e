"""Export paths for the metrics registry (the port's copy of
``deepspeed_tpu/telemetry/exporter.py``, pure Python, unchanged).

Two wire formats:

* **Prometheus text exposition** — ``to_prometheus_text`` renders the
  registry; ``PrometheusFileExporter`` rewrites a textfile atomically
  (node-exporter textfile-collector compatible) and
  ``PrometheusHTTPExporter`` serves ``/metrics`` from a daemon thread.
  ``parse_prometheus_text`` is the matching reader (tests and
  ``chip_smoke.py`` round-trip the output through it).

* **JSONL event log** — ``JSONLWriter`` appends one JSON object per
  line.  Two event kinds: ``{"kind": "event", "ts", "name", ...}`` for
  point events and ``{"kind": "snapshot", "ts", "step", "metrics": ...}``
  for full registry dumps.  Greppable, tailable, and loadable with one
  ``json.loads`` per line.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..utils.logging import logger
from .registry import Histogram, MetricsRegistry, get_registry

#: sinks already warned about this process (warn-once per sink kind: a
#: full disk would otherwise log every boundary for the rest of the run)
_warned_sinks: set = set()


def record_export_failure(sink: str, exc: BaseException,
                          registry: Optional[MetricsRegistry] = None) -> None:
    """Account a failed telemetry export WITHOUT raising.

    Observability must never kill the work it observes: a full disk, a
    torn NFS mount or a dead scrape socket turns into a warn-once log
    line plus ``deepspeed_tpu_telemetry_export_failures_total`` (labeled
    by sink), while the training/serving step goes on.  The counter
    itself is in-memory, so it survives the broken sink and surfaces on
    whichever exporter still works."""
    (registry or get_registry()).counter(
        "deepspeed_tpu_telemetry_export_failures_total",
        "telemetry exporter writes that failed (warn-once logged, "
        "never raised into the step)", labelnames=("sink",)).inc(sink=sink)
    if sink not in _warned_sinks:
        _warned_sinks.add(sink)
        logger.warning(
            f"telemetry: {sink} export failed ({exc!r}); exports to this "
            "sink will keep being attempted and counted in "
            "deepspeed_tpu_telemetry_export_failures_total, but this is "
            "the only log line you will see for it")


# --------------------------------------------------------------------------
# Prometheus text exposition format
# --------------------------------------------------------------------------
def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def to_prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in the text exposition format (v0.0.4)."""
    registry = registry or get_registry()
    lines = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.type}")
        for sample_name, labels, value in m.samples():
            lines.append(f"{sample_name}{_render_labels(labels)} {value!r}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Parse exposition text back to ``{(sample_name, labels): value}``.

    Minimal but faithful to what ``to_prometheus_text`` emits (and to
    well-formed scrape bodies generally); used for round-trip tests."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labelpart, valuepart = rest.rsplit("}", 1)
            labels = []
            for item in _split_labels(labelpart):
                k, v = item.split("=", 1)
                v = v.strip()[1:-1]  # strip quotes
                v = v.replace(r"\"", '"').replace(r"\n", "\n") \
                     .replace(r"\\", "\\")
                labels.append((k.strip(), v))
            value = float(valuepart.strip().split()[0])
            out[(name, tuple(sorted(labels)))] = value
        else:
            parts = line.split()
            out[(parts[0], ())] = float(parts[1])
    return out


def _split_labels(s: str):
    """Split ``a="x",b="y,z"`` on commas outside quotes."""
    items, depth, cur, in_q, esc = [], 0, "", False, False
    for ch in s:
        if esc:
            cur += ch
            esc = False
            continue
        if ch == "\\":
            cur += ch
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
            cur += ch
            continue
        if ch == "," and not in_q:
            if cur.strip():
                items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


class PrometheusFileExporter:
    """Atomically rewrite a Prometheus textfile on each ``write()``."""

    def __init__(self, path: str, registry: Optional[MetricsRegistry] = None):
        self.path = path
        self.registry = registry or get_registry()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def write(self) -> str:
        text = to_prometheus_text(self.registry)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, self.path)  # atomic: scrapers never see a torn file
        return self.path

    def close(self) -> None:
        self.write()


class PrometheusHTTPExporter:
    """Serve ``/metrics`` over HTTP from a daemon thread.

    Port 0 lets the OS pick (the bound port is ``self.port`` after
    ``start()``) — handy in tests and multi-process launches."""

    def __init__(self, port: int = 9184, addr: str = "0.0.0.0",
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry or get_registry()
        self.addr = addr
        self.port = port
        self._server = None
        self._thread = None

    def start(self) -> "PrometheusHTTPExporter":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = to_prometheus_text(registry).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet: scrapes are periodic
                pass

        self._server = ThreadingHTTPServer((self.addr, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="dstpu-metrics-http",
                                        daemon=True)
        self._thread.start()
        logger.info(f"telemetry: serving /metrics on "
                    f"{self.addr}:{self.port}")
        return self

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


# --------------------------------------------------------------------------
# JSONL event log
# --------------------------------------------------------------------------
def snapshot_metrics(registry: Optional[MetricsRegistry] = None) -> Dict[str, list]:
    """Registry contents as one JSON-safe dict: counters/gauges as
    values, histograms as ``{count, sum, p50, p95, p99}`` per label-set.
    Shared by ``JSONLWriter.emit_snapshot`` and the flight recorder."""
    registry = registry or get_registry()
    metrics: Dict[str, list] = {}
    for m in registry.collect():
        rows = []
        if isinstance(m, Histogram):
            for k, s in m.series():
                if s.count == 0:
                    continue
                rows.append({"labels": dict(k), "count": s.count,
                             "sum": s.sum, **m.percentiles(**dict(k))})
        else:
            for k, v in m.series():
                rows.append({"labels": dict(k), "value": v})
        if rows:
            metrics[m.name] = rows
    return metrics


class JSONLWriter:
    """Append-only JSON-lines event log with an explicit flush per emit."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def emit(self, name: str, **fields) -> None:
        """One point event: ``{"kind": "event", "ts", "name", **fields}``."""
        rec = {"kind": "event", "ts": time.time(), "name": name}
        rec.update(fields)
        self._write(rec)

    def emit_snapshot(self, registry: Optional[MetricsRegistry] = None,
                      step: Optional[int] = None) -> None:
        """Full registry dump: counters/gauges as values, histograms as
        ``{count, sum, p50, p95, p99}`` per label-set."""
        rec = {"kind": "snapshot", "ts": time.time(),
               "metrics": snapshot_metrics(registry)}
        if step is not None:
            rec["step"] = int(step)
        self._write(rec)

    def _write(self, rec: dict) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write(json.dumps(rec, default=float) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
