"""Static metric- and span-name lint over ``deepspeed_tpu_torch/`` (the
port's own copy of ``deepspeed_tpu/analysis/metric_lint.py``; ``python -m
deepspeed_tpu_torch.analysis.metric_lint [root]`` exits non-zero on a
violation).

AST-scans the port for metric registrations — ``<registry>.counter/gauge/
histogram("name", ...)`` calls and direct ``Counter/Gauge/Histogram("name",
...)`` constructions with a string-literal first argument — and enforces:

1. ``snake_case`` with the ``deepspeed_tpu_`` namespace prefix
   (the same ``METRIC_NAME_RE`` the registry enforces at runtime —
   this lint catches the violation at review time instead of first-run).
2. No duplicate registrations: a metric name is registered at exactly
   ONE call site across the package (get-or-create re-execution of the
   same site is fine; two sites claiming one name is how two subsystems
   silently sum into each other's series).
3. One name, one type: the same name must not appear as two different
   metric types anywhere.

It also scans span/event recordings — ``span("name", ...)``,
``begin_span("name", ...)``, ``record_event("name", ...)`` with a
string-literal first argument (``telemetry/spans.py``) — and enforces
the matching rules for the trace namespace:

4. ``snake_case`` WITHOUT the ``deepspeed_tpu_`` prefix (that namespace
   belongs to metrics; a prefixed span name would alias a metric family
   in dashboards that join the two artifacts).
5. Single owner: each literal span/event name is recorded from exactly
   one call site (multi-site phases thread the name through a helper).

And it cross-checks the metric CATALOG (``docs/OBSERVABILITY.md``)
against the code, so the two cannot drift apart:

6. Every registered ``deepspeed_tpu_*`` name must appear in
   docs/OBSERVABILITY.md (an undocumented metric is invisible to anyone
   reading the catalog).
7. Every metric named in a catalog TABLE row (lines starting with
   ``|``; backticked full names, plus combined-row ``_suffix`` tokens
   that expand against the row's base name, e.g. ``_misses_total``)
   must be registered somewhere in code — no dead catalog rows
   promising metrics that no longer exist.

   A row of a family whose owning module is not ported yet
   (``PENDING_OWNERS``: family prefix -> the port path that will register
   it) is reported by :func:`pending_rows` as pending, not as dead, while
   that file is absent.

Both catalog checks are skipped when ``docs/OBSERVABILITY.md`` does not
exist under the scanned root (fixture trees in tests).  The port feeds the
same ``deepspeed_tpu_*`` families as the JAX package, against the same
catalog.  Stdlib only: no torch and nothing of either package.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, List, Tuple

METRIC_NAME_RE = re.compile(r"^deepspeed_tpu_[a-z][a-z0-9_]*$")
SPAN_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

_METHODS = {"counter": "counter", "gauge": "gauge", "histogram": "histogram"}
_CTORS = {"Counter": "counter", "Gauge": "gauge", "Histogram": "histogram"}
_SPAN_FNS = {"span": "span", "begin_span": "span", "record_event": "event"}

#: the scanned package
PKG = "deepspeed_tpu_torch"

#: registration sites that define the generic machinery itself, not a metric
_EXCLUDE_FILES = {os.path.join(PKG, "telemetry", "registry.py")}
#: span sites that define the span machinery itself, not a span
_SPAN_EXCLUDE_FILES = {os.path.join(PKG, "telemetry", "spans.py")}

#: metric FAMILIES owned by a single module: beyond the per-name
#: single-owner rule, every member of these prefixes must be registered
#: in the named file — a second module minting into the family would
#: fork its accounting (the reqtrace ledger is the sole authority for
#: request-lifecycle metrics; see docs/OBSERVABILITY.md "Request
#: tracing")
_FAMILY_OWNERS = {
    "deepspeed_tpu_serving_reqtrace_":
        os.path.join(PKG, "telemetry", "reqtrace.py"),
    # the numerics sentinel is the sole authority for training-health
    # anomaly accounting (docs/OBSERVABILITY.md "Numerics observatory")
    "deepspeed_tpu_train_numerics_":
        os.path.join(PKG, "telemetry", "numerics.py"),
    # the cross-process serving fleet families (docs/SERVING.md
    # "Cross-process fleet") each have exactly one registering module
    "deepspeed_tpu_serving_transport_":
        os.path.join(PKG, "serving", "transport.py"),
    "deepspeed_tpu_serving_autoscale_":
        os.path.join(PKG, "serving", "autoscale.py"),
    "deepspeed_tpu_serving_kv_nvme_":
        os.path.join(PKG, "serving", "kv_tier.py"),
}

#: catalog families whose registering module the port has not yet: a
#: row of one is pending while its owner file is absent (ROADMAP Queue 1
#: #9 for the comms logger)
PENDING_OWNERS = {
    "deepspeed_tpu_comm_": os.path.join(PKG, "comm", "comms_logger.py"),
}

Site = Tuple[str, int, str]  # (relpath, lineno, metric_type)


def _scan_file(path: str, rel: str) -> List[Tuple[str, Site]]:
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        print(f"{rel}: syntax error during scan: {e}", file=sys.stderr)
        return []
    out: List[Tuple[str, Site]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
            continue
        mtype = None
        if isinstance(node.func, ast.Attribute) and node.func.attr in _METHODS:
            mtype = _METHODS[node.func.attr]
        elif isinstance(node.func, ast.Name) and node.func.id in _CTORS:
            mtype = _CTORS[node.func.id]
        if mtype is None:
            continue
        name = first.value
        # only treat it as a metric registration when it carries the
        # namespace prefix or claims to be one but got the case wrong —
        # plain .counter()/Counter() calls on unrelated objects
        # (itertools.count etc.) must not trip the lint
        if not name.lower().startswith("deepspeed_tpu_"):
            continue
        out.append((name, (rel, node.lineno, mtype)))
    return out


def _scan_spans(path: str, rel: str) -> List[Tuple[str, Site]]:
    """Span/event recordings: module-level ``span(...)`` /
    ``begin_span(...)`` / ``record_event(...)`` calls (bare or via an
    attribute, e.g. ``spans.record_event``) with a literal first arg."""
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        print(f"{rel}: syntax error during scan: {e}", file=sys.stderr)
        return []
    out: List[Tuple[str, Site]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
            continue
        fn = None
        if isinstance(node.func, ast.Name) and node.func.id in _SPAN_FNS:
            fn = _SPAN_FNS[node.func.id]
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _SPAN_FNS:
            fn = _SPAN_FNS[node.func.attr]
        if fn is None:
            continue
        out.append((first.value, (rel, node.lineno, fn)))
    return out


def _walk(root: str, scanner, exclude) -> Dict[str, List[Site]]:
    found: Dict[str, List[Site]] = {}
    for sub in (PKG,):
        base = os.path.join(root, sub)
        for dirpath, _dirs, files in os.walk(base):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root)
                if rel in exclude:
                    continue
                for name, site in scanner(path, rel):
                    found.setdefault(name, []).append(site)
    return found


def collect(root: str) -> Dict[str, List[Site]]:
    return _walk(root, _scan_file, _EXCLUDE_FILES)


_DOC_CATALOG = os.path.join("docs", "OBSERVABILITY.md")
_DOC_TOKEN_RE = re.compile(r"`([A-Za-z0-9_.*-]+)`")
_DOC_SUFFIX_RE = re.compile(r"^_[a-z][a-z0-9_]*$")


def collect_catalog(root: str) -> Dict[str, int]:
    """Metric names the docs/OBSERVABILITY.md catalog TABLES promise:
    backticked full ``deepspeed_tpu_*`` names in ``|`` rows, plus
    combined-row ``_suffix`` tokens expanded against the row's base
    name by replacing its trailing underscore segments
    (``deepspeed_tpu_x_hits_total`` + ``_misses_total`` ->
    ``deepspeed_tpu_x_misses_total``).  Returns ``{name: lineno}`` (the
    first row naming each), ``{}`` when the doc is absent."""
    path = os.path.join(root, _DOC_CATALOG)
    if not os.path.exists(path):
        return {}
    promised: Dict[str, int] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.lstrip().startswith("|"):
                continue
            base = None
            for tok in _DOC_TOKEN_RE.findall(line):
                if tok.startswith("deepspeed_tpu_"):
                    if "*" in tok or "." in tok or "-" in tok:
                        continue  # family glob / knob path, not a name
                    promised.setdefault(tok, lineno)
                    if base is None:
                        base = tok
                elif base is not None and _DOC_SUFFIX_RE.match(tok):
                    segs = tok[1:].split("_")
                    head = base.split("_")[:-len(segs)]
                    if head:
                        promised.setdefault("_".join(head + segs), lineno)
    return promised


def collect_spans(root: str) -> Dict[str, List[Site]]:
    return _walk(root, _scan_spans, _SPAN_EXCLUDE_FILES)


def check(root: str) -> List[str]:
    errors: List[str] = []
    found = collect(root)
    for name, sites in sorted(found.items()):
        where = ", ".join(f"{f}:{ln}" for f, ln, _t in sites)
        if not METRIC_NAME_RE.match(name):
            errors.append(
                f"{name!r} ({where}): must match "
                f"{METRIC_NAME_RE.pattern} (snake_case, "
                f"'deepspeed_tpu_' prefix)")
        types = {t for _f, _ln, t in sites}
        if len(types) > 1:
            errors.append(f"{name!r} registered as multiple types "
                          f"{sorted(types)} ({where})")
        if len(sites) > 1:
            errors.append(
                f"{name!r} registered at {len(sites)} call sites ({where}): "
                "each metric belongs to exactly one owner")
        for prefix, owner in _FAMILY_OWNERS.items():
            if name.startswith(prefix):
                strays = [f"{f}:{ln}" for f, ln, _t in sites if f != owner]
                if strays:
                    errors.append(
                        f"{name!r} registered outside the family owner "
                        f"({', '.join(strays)}): every '{prefix}*' metric "
                        f"is registered only in {owner}")
    for name, sites in sorted(collect_spans(root).items()):
        where = ", ".join(f"{f}:{ln}" for f, ln, _t in sites)
        if not SPAN_NAME_RE.match(name) or name.startswith("deepspeed_tpu_"):
            errors.append(
                f"span {name!r} ({where}): span/event names are "
                f"snake_case WITHOUT the 'deepspeed_tpu_' metric prefix")
        if len(sites) > 1:
            errors.append(
                f"span {name!r} recorded at {len(sites)} call sites "
                f"({where}): each span name belongs to exactly one owner "
                "(thread the name through a helper for shared phases)")
    doc_path = os.path.join(root, _DOC_CATALOG)
    if os.path.exists(doc_path):
        with open(doc_path) as f:
            doc_text = f.read()
        promised = collect_catalog(root)
        for name, sites in sorted(found.items()):
            # combined catalog rows document a name via suffix expansion
            # (`_misses_total`) without spelling it out — the expanded
            # promise counts as documented
            if name not in doc_text and name not in promised:
                where = ", ".join(f"{f}:{ln}" for f, ln, _t in sites)
                errors.append(
                    f"{name!r} ({where}): registered in code but absent "
                    f"from the {_DOC_CATALOG} metric catalog — document "
                    "it (or remove the registration)")
        pending = set(pending_rows(root))
        for name, lineno in sorted(promised.items()):
            if name not in found and name not in pending:
                errors.append(
                    f"{_DOC_CATALOG}:{lineno}: catalog row promises "
                    f"{name!r} but nothing in the code registers it "
                    "(dead catalog row — delete it or restore the metric)")
    return errors


def pending_rows(root: str) -> Dict[str, int]:
    """Catalog rows promised and registered nowhere in the port whose
    family's owning port file (``PENDING_OWNERS``) does not exist yet:
    ``{name: catalog line}``."""
    found = collect(root)
    out: Dict[str, int] = {}
    for name, lineno in collect_catalog(root).items():
        if name in found:
            continue
        for prefix, owner in PENDING_OWNERS.items():
            if name.startswith(prefix) and not os.path.exists(os.path.join(root, owner)):
                out[name] = lineno
                break
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    root = argv[0] if argv else os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    errors = check(root)
    names = collect(root)
    spans = collect_spans(root)
    if errors:
        print(f"check_metric_names: {len(errors)} violation(s) over "
              f"{len(names)} metric name(s) + {len(spans)} span name(s)")
        for e in errors:
            print(f"  ERROR: {e}")
        return 1
    print(f"check_metric_names: OK ({len(names)} metric names, "
          f"{len(spans)} span names, {len(pending_rows(root))} catalog rows pending "
          f"their owning module)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
