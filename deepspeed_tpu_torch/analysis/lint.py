"""Hazard AST linter over ``deepspeed_tpu_torch/`` (the port's own copy
of ``deepspeed_tpu/analysis/lint.py``; ``python -m
deepspeed_tpu_torch.analysis.lint [root]`` exits non-zero on a violation).

Pure AST and self-contained: no torch import and nothing of either
package.  The rules are the JAX package's, over the port's paths, and
``host-sync`` also knows torch's forms of a device read:

``host-sync``
    Device-value syncs — ``.item()``, ``.tolist()``, ``jax.device_get``,
    ``np.asarray``/``np.array``, ``float()``/``int()`` on a name or
    attribute, and torch's ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize()`` / ``.synchronize()`` — inside functions
    *reachable from the hot step paths*
    (the per-file root table below + a same-file call graph).  Each
    surviving sync on a step path is either a bug (a hidden device
    round-trip serializing the dispatch queue) or a deliberate boundary
    that deserves an inline justification.

``socket-hot``
    Blocking socket reads — ``.recv()``, ``.recv_into()``,
    ``.recvfrom()``, ``.accept()`` — inside functions reachable from
    the hot step roots (same reachability walk as ``host-sync``).  A
    blocking socket wait on the engine/router step path stalls device
    dispatch exactly like a host sync does; cross-process KV transport
    belongs on the dedicated sender thread
    (``serving/transport.BundleSender``), never inline in ``step``.

``wall-clock``
    ``time.time()`` in step/determinism paths.  Wall clock is fine for
    record timestamps; it is a hazard when used for *durations* or
    *deadlines* (NTP steps it backwards) or anywhere the
    determinism contract (replay drills, resumable chaos) depends on
    reproducible values — use ``time.perf_counter``/``time.monotonic``,
    or annotate why wall-clock semantics are required.

``unseeded-random``
    Module-level ``random.*`` / ``np.random.*`` draws from the global,
    unseeded RNG anywhere in the package.  Seeded objects
    (``random.Random(seed)``, ``np.random.RandomState``, generators)
    and ``jax.random`` are the sanctioned sources; the chaos/drill
    determinism contract threads ``--seed`` everywhere.

``swallow``
    Bare ``except:`` anywhere, and broad ``except Exception/
    BaseException`` handlers whose body is only ``pass``/``continue``.
    In engine step paths a swallowed exception turns a dead program
    into silent wrong answers; elsewhere (telemetry, best-effort
    cleanup) it is often intentional — then say so inline.

``mutable-default``
    ``def f(x=[], y={})`` — the shared-instance trap, package-wide.

``pytree-order``
    Iteration over ``set`` values (literal, ``set(...)`` or
    ``frozenset(...)``) without ``sorted(...)`` in sharding code.
    ``str`` hashes are salted per process, so set order differs across
    *processes* — in code that derives PartitionSpecs or flattens
    pytrees, that is cross-host sharding skew waiting to happen.

``slo-exemplar``
    Exemplar-coverage contract for SLO violation counters: every
    ``.inc()`` on a ``deepspeed_tpu_serving_slo_*`` counter must be
    accompanied (same function) by a ``slo_exemplar(...)`` call
    recording the offending request's trace_id — an SLO count without
    an exemplar is a number you cannot debug (docs/OBSERVABILITY.md
    "Request tracing").  Counter increments with no single offending
    request (e.g. a breaker *recovery*) suppress with a reason.

``grad-overlap``
    Regression guard for the compute/collective overlap structure
    (runtime/zero/overlap.py, docs/COMM.md "Overlap & scheduling"): the
    explicit gradient reducers — including the COMPRESSED in-loop
    bucket reducer of the overlap hook (docs/COMM.md "Compressed
    overlap") — must route their leaves through the shared bucketer,
    and the transformer forward must keep its overlap hook point.  A
    refactor that quietly reverts to a monolithic post-backward (or
    per-leaf in-loop quantized) grad reduce fails this rule by name
    instead of silently regressing MFU.

Suppression: every rule honors an inline allowlist comment on the
violation line or the line above::

    x = float(loss)  # dstpu-lint: allow[host-sync] reporting boundary,
                     # queue already drained

The reason text is REQUIRED — an allow marker without one is itself a
violation, so every suppression in the tree is documented.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: the scanned package
PKG = "deepspeed_tpu_torch"

#: rule ids (the JAX package's catalog, docs/STATIC_ANALYSIS.md)
RULES = ("host-sync", "socket-hot", "wall-clock", "unseeded-random",
         "swallow", "mutable-default", "pytree-order", "grad-overlap",
         "slo-exemplar")

ALLOW_RE = re.compile(
    r"#\s*dstpu-lint:\s*allow\[(?P<rules>[a-z, -]+)\]\s*(?P<reason>.*)")

#: hot step-path roots for the host-sync reachability walk, per relpath.
#: A function listed here — and everything reachable from it through the
#: same-file call graph — must not sync device values without a reason.
HOT_ROOTS: Dict[str, Set[str]] = {
    os.path.join(PKG, "runtime", "engine.py"):
        {"train_batch", "forward", "backward", "step", "eval_batch"},
    # the pipe tick body runs T = M + P - 1 times inside the step scan —
    # a host sync there serializes EVERY tick, not just the step boundary
    os.path.join(PKG, "runtime", "pipe", "engine.py"):
        {"train_batch", "_pipe_body"},
    os.path.join(PKG, "inference", "engine.py"):
        {"generate", "forward"},
    os.path.join(PKG, "inference", "v2", "engine_v2.py"):
        {"step", "_step_impl", "_spec_step", "_run_prefill_chunk"},
    os.path.join(PKG, "serving", "replica.py"): {"step"},
    os.path.join(PKG, "serving", "router.py"):
        {"step", "submit"},
}

#: directories whose files are step/determinism paths for the
#: ``wall-clock`` rule (telemetry exporters deliberately stamp wall
#: clock into records and are not step paths)
WALL_CLOCK_DIRS = (
    os.path.join(PKG, "runtime"),
    os.path.join(PKG, "inference"),
    os.path.join(PKG, "serving"),
    os.path.join(PKG, "resilience"),
    os.path.join(PKG, "autotuning"),
    os.path.join(PKG, "elasticity"),
    os.path.join(PKG, "comm"),
)

#: files that derive shardings / flatten pytrees for placement — the
#: ``pytree-order`` rule applies here
SHARDING_FILES = (
    os.path.join(PKG, "runtime", "zero", "strategy.py"),
    os.path.join(PKG, "runtime", "zero", "zeropp.py"),
    os.path.join(PKG, "runtime", "zero", "offload.py"),
    os.path.join(PKG, "parallel", "mesh.py"),
    os.path.join(PKG, "runtime", "tensor_parallel",
                 "tp_manager.py"),
    os.path.join(PKG, "module_inject", "auto_tp.py"),
    # the compressed-collective layer flattens grad pytrees and derives
    # axis_index_groups — order skew there IS cross-host sharding skew
    os.path.join(PKG, "comm", "collectives", "bucketer.py"),
    os.path.join(PKG, "comm", "collectives", "codec.py"),
    os.path.join(PKG, "comm", "collectives", "compressed.py"),
    os.path.join(PKG, "comm", "collectives", "hierarchical.py"),
    os.path.join(PKG, "runtime", "zero", "overlap.py"),
    os.path.join(PKG, "runtime", "pipe", "overlap.py"),
    os.path.join(PKG, "utils", "groups.py"),
)

#: seeded-RNG constructors / setup calls that are NOT violations
_SEEDED_RANDOM_OK = {"Random", "RandomState", "Generator", "default_rng",
                     "seed", "PRNGKey", "split", "fold_in", "key"}


@dataclass
class Violation:
    rule: str
    rel: str
    lineno: int
    message: str

    def __str__(self) -> str:
        return f"{self.rel}:{self.lineno}: [{self.rule}] {self.message}"


# --------------------------------------------------------------- allowlist
def _comment_lines(src: str) -> Optional[Set[int]]:
    """Line numbers carrying a real ``#`` comment token.  None when
    tokenization fails (fall back to treating every line as eligible).
    Needed so a marker EXAMPLE quoted in a docstring never registers as
    a live suppression."""
    import io
    import tokenize

    try:
        return {tok.start[0] for tok in
                tokenize.generate_tokens(io.StringIO(src).readline)
                if tok.type == tokenize.COMMENT}
    except Exception:
        return None


def _markers(src: str) -> List[Tuple[int, Set[str], str]]:
    """Every real allow marker: (lineno, rules, reason) — comment tokens
    only, never string literals."""
    lines = src.splitlines()
    comments = _comment_lines(src)
    out = []
    for i, line in enumerate(lines, start=1):
        if comments is not None and i not in comments:
            continue
        m = ALLOW_RE.search(line)
        if m:
            out.append((i, {r.strip() for r in m.group("rules").split(",")
                            if r.strip()}, m.group("reason").strip()))
    return out


def _allows(src: str) -> Dict[int, Tuple[Set[str], str]]:
    """lineno -> (rules allowed, reason).  A marker covers its own line
    and the next line (so it can sit above a long statement); a marker
    whose reason wraps onto further comment-only lines rides through
    them down to the code line it guards."""
    src_lines = src.splitlines()
    out: Dict[int, Tuple[Set[str], str]] = {}
    markers = [(i, (rules, reason)) for i, rules, reason in _markers(src)]
    for i, entry in markers:
        out[i] = entry
    # ride each marker down through the rest of its comment block — but a
    # line carrying its OWN marker (registered above) is never overridden
    for i, entry in markers:
        j = i + 1
        while j <= len(src_lines) and src_lines[j - 1].lstrip().startswith("#"):
            out.setdefault(j, entry)
            j += 1
    return out


def _suppressed(allows, lineno: int, rule: str,
                stmt_start: Optional[int] = None) -> Optional[str]:
    """Reason when (rule, lineno) is allowlisted; None otherwise.  An
    empty reason returns "" — the caller reports it as undocumented.
    A marker covers its own line and the next; ``stmt_start`` lets a
    marker above a multi-line statement cover calls on its later lines."""
    candidates = [lineno, lineno - 1]
    if stmt_start is not None and stmt_start != lineno:
        candidates += [stmt_start, stmt_start - 1]
    for ln in candidates:
        entry = allows.get(ln)
        if entry and rule in entry[0]:
            return entry[1]
    return None


def _stmt_starts(tree: ast.AST) -> Dict[int, int]:
    """line -> first line of the innermost enclosing statement.  Simple
    statements map their whole span; compound statements (if/for/with/
    try/def) map only their HEADER lines, so a marker at an ``if`` head
    never blankets the body."""
    out: Dict[int, int] = {}

    def span(node, last):
        for ln in range(node.lineno, last + 1):
            out[ln] = node.lineno  # innermost wins: children visit later

    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.stmt):
            span(node, body[0].lineno - 1)  # header only
        else:
            span(node, getattr(node, "end_lineno", node.lineno)
                 or node.lineno)
    return out


# ------------------------------------------------------------- call graph
def _defs_and_calls(tree: ast.AST):
    """name -> def node (classes flattened; duplicate method names merge
    conservatively: any same-named def is considered reachable)."""
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    return defs


def _called_names(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute):
                out.add(f.attr)
    return out


def _reachable(tree: ast.AST, roots: Set[str]) -> List[Tuple[str, ast.AST]]:
    defs = _defs_and_calls(tree)
    seen: Set[str] = set()
    work = [r for r in roots if r in defs]
    while work:
        cur = work.pop()
        if cur in seen:
            continue
        seen.add(cur)
        for fn in defs[cur]:
            for name in _called_names(fn):
                if name in defs and name not in seen:
                    work.append(name)
    return [(name, fn) for name in sorted(seen) for fn in defs[name]]


# ------------------------------------------------------------------ rules
def _is_np(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id in ("np", "numpy")


def _is_torch_cuda(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "cuda" \
        and isinstance(node.value, ast.Name) and node.value.id == "torch"


def _host_sync_label(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in ("item", "tolist", "cpu", "numpy") and not call.args:
            return f".{f.attr}()"
        if f.attr == "synchronize":
            return ("torch.cuda.synchronize()" if _is_torch_cuda(f.value)
                    else ".synchronize()")
        if f.attr == "device_get":
            return "jax.device_get"
        if f.attr in ("asarray", "array") and _is_np(f.value) and call.args \
                and isinstance(call.args[0],
                               (ast.Name, ast.Attribute, ast.Subscript)):
            return f"np.{f.attr}"
    elif isinstance(f, ast.Name) and f.id in ("float", "int") \
            and len(call.args) == 1 \
            and isinstance(call.args[0], (ast.Name, ast.Attribute)):
        return f"{f.id}()"
    return None


def _check_host_sync(rel, tree, out: List[Violation]) -> None:
    roots = HOT_ROOTS.get(rel)
    if not roots:
        return
    for fname, fn in _reachable(tree, roots):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                label = _host_sync_label(node)
                if label:
                    out.append(Violation(
                        "host-sync", rel, node.lineno,
                        f"{label} in '{fname}' (reachable from hot step "
                        f"path {sorted(roots)}): device-value sync on the "
                        "step path serializes the dispatch queue"))


#: blocking socket receive-side calls — each parks the calling thread
#: until the peer sends, which on a step path stalls device dispatch
_SOCKET_BLOCKING_ATTRS = ("recv", "recv_into", "recvfrom", "accept")


def _check_socket_hot(rel, tree, out: List[Violation]) -> None:
    roots = HOT_ROOTS.get(rel)
    if not roots:
        return
    for fname, fn in _reachable(tree, roots):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SOCKET_BLOCKING_ATTRS:
                out.append(Violation(
                    "socket-hot", rel, node.lineno,
                    f".{node.func.attr}() in '{fname}' (reachable from "
                    f"hot step path {sorted(roots)}): a blocking socket "
                    "wait on the step path stalls device dispatch — "
                    "route cross-process I/O through the transport "
                    "sender thread"))


def _check_wall_clock(rel, tree, out: List[Violation]) -> None:
    if not any(rel.startswith(d + os.sep) or os.path.dirname(rel) == d
               for d in WALL_CLOCK_DIRS):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "time" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in ("time", "_time"):
            out.append(Violation(
                "wall-clock", rel, node.lineno,
                "time.time() in a step/determinism path: use "
                "perf_counter/monotonic for durations and deadlines, or "
                "justify the wall-clock semantics inline"))


def _check_unseeded_random(rel, tree, out: List[Violation]) -> None:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        if f.attr in _SEEDED_RANDOM_OK:
            continue
        # random.shuffle(...) / random.randint(...) on the global RNG
        if isinstance(f.value, ast.Name) and f.value.id == "random":
            out.append(Violation(
                "unseeded-random", rel, node.lineno,
                f"random.{f.attr}() draws from the global unseeded RNG; "
                "thread a seeded random.Random through (determinism "
                "contract)"))
        # np.random.randint(...) on the global numpy RNG
        elif isinstance(f.value, ast.Attribute) and f.value.attr == "random" \
                and _is_np(f.value.value):
            out.append(Violation(
                "unseeded-random", rel, node.lineno,
                f"np.random.{f.attr}() draws from the global numpy RNG; "
                "use a np.random.RandomState(seed)"))


def _check_swallow(rel, tree, out: List[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        bare = node.type is None
        broad = isinstance(node.type, ast.Name) and \
            node.type.id in ("Exception", "BaseException")
        if bare:
            out.append(Violation(
                "swallow", rel, node.lineno,
                "bare 'except:' catches SystemExit/KeyboardInterrupt too; "
                "name the exception (or Exception) and justify the scope"))
            continue
        if broad and all(isinstance(s, (ast.Pass, ast.Continue))
                         for s in node.body):
            out.append(Violation(
                "swallow", rel, node.lineno,
                f"'except {node.type.id}' swallows the exception silently "
                "(body is pass/continue): handle, log, or justify inline"))


def _check_mutable_default(rel, tree, out: List[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + \
            [d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                    and d.func.id in ("list", "dict", "set")):
                out.append(Violation(
                    "mutable-default", rel, d.lineno,
                    f"mutable default argument in '{node.name}': the "
                    "instance is shared across calls; default to None"))


def _check_pytree_order(rel, tree, out: List[Violation]) -> None:
    if rel not in SHARDING_FILES:
        return

    def _is_set_expr(e: ast.AST) -> bool:
        if isinstance(e, ast.Set):
            return True
        return isinstance(e, ast.Call) and isinstance(e.func, ast.Name) \
            and e.func.id in ("set", "frozenset")

    for node in ast.walk(tree):
        iter_expr = None
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iter_expr = node.iter
        elif isinstance(node, ast.comprehension):
            iter_expr = node.iter
        if iter_expr is not None and _is_set_expr(iter_expr):
            out.append(Violation(
                "pytree-order", rel, iter_expr.lineno,
                "iterating a set in sharding code: str hashes are salted "
                "per process, so the order differs across hosts — wrap in "
                "sorted(...) before deriving specs/placements from it"))


#: rel path -> (root function, names one of which must be transitively
#: called/referenced from it, what breaking that means).  The guard is
#: structural presence, not behavior: losing the bucketer routing or the
#: hook point IS the monolithic-reduce regression returning.
_GRAD_OVERLAP_CONTRACTS: Dict[str, Tuple[str, Set[str], str]] = {
    os.path.join(PKG, "runtime", "zero", "zeropp.py"): (
        "quantized_grad_reduce",
        {"bucketed_map", "assign_buckets", "coalesce_flat"},
        "the qgZ gradient reduce no longer routes leaves through the "
        "shared bucketer (comm/collectives/bucketer.py) — a monolithic "
        "per-leaf post-backward reduce reappeared"),
    os.path.join(PKG, "comm", "collectives",
                 "hierarchical.py"): (
        "hierarchical_grad_reduce",
        {"bucketed_map", "assign_buckets", "coalesce_flat"},
        "the hierarchical gradient reduce no longer routes leaves "
        "through the shared bucketer (comm/collectives/bucketer.py) — a "
        "monolithic per-leaf post-backward reduce reappeared"),
    os.path.join(PKG, "models", "transformer.py"): (
        "transformer_forward", {"wrap_block"},
        "the transformer forward lost its overlap hook point "
        "(OverlapPlan.wrap_block) — the ZeRO grad reduce falls back to "
        "one monolithic post-backward block"),
    os.path.join(PKG, "runtime", "zero", "overlap.py"): (
        "_compressed_bucket_reduce",
        {"bucketed_map", "assign_buckets", "coalesce_flat"},
        "the compressed in-loop bucket reducer no longer routes leaves "
        "through the shared bucketer (comm/collectives/bucketer.py) — a "
        "monolithic per-leaf quantized reduce reappeared inside the "
        "overlap hook"),
    os.path.join(PKG, "runtime", "pipe", "overlap.py"): (
        "reduce_stage_grads",
        {"bucketed_map", "assign_buckets", "coalesce_flat"},
        "the pipe in-scan stage-grad reducer no longer routes leaves "
        "through the shared bucketer (comm/collectives/bucketer.py) — "
        "the bubble-overlapped pipeline grad reduce regressed to one "
        "monolithic fp post-backward all-reduce"),
}


#: the port file whose presence turns the grad-overlap contracts on
OVERLAP_FILE = os.path.join(PKG, "runtime", "zero", "overlap.py")


def _check_grad_overlap(rel, tree, out: List[Violation], root: str = "") -> None:
    contract = _GRAD_OVERLAP_CONTRACTS.get(rel)
    if contract is None or not os.path.exists(os.path.join(root, OVERLAP_FILE)):
        return
    fname, needed, why = contract
    reachable = _reachable(tree, {fname})
    if not reachable:
        out.append(Violation(
            "grad-overlap", rel, 1,
            f"'{fname}' is gone from {rel}: {why}"))
        return
    called: Set[str] = set()
    for _name, fn in reachable:
        called |= _called_names(fn)
    if called.isdisjoint(needed):
        lineno = min(fn.lineno for _n, fn in reachable)
        out.append(Violation(
            "grad-overlap", rel, lineno,
            f"'{fname}' reaches none of {sorted(needed)}: {why}"))


#: metric-name prefix whose counters carry the exemplar contract
_SLO_PREFIX = "deepspeed_tpu_serving_slo_"


def _slo_registration_name(call: ast.Call) -> Optional[str]:
    """Metric name when ``call`` registers an SLO counter
    (``<registry>.counter("deepspeed_tpu_serving_slo_*", ...)``)."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "counter" and call.args):
        return None
    first = call.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str) \
            and first.value.startswith(_SLO_PREFIX):
        return first.value
    return None


def _check_slo_exemplar(rel, tree, out: List[Violation]) -> None:
    # pass 1 (file-wide): which names hold SLO counters?
    #   x = reg.counter("…slo_…")  /  self._m_x = reg.counter("…slo_…")
    # and which FUNCTIONS return one (accessor idiom: shed_counter()).
    tracked: Dict[str, str] = {}      # bare/attr name -> metric name
    accessors: Dict[str, str] = {}    # function name -> metric name
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            if not (isinstance(value, ast.Call)):
                continue
            metric = _slo_registration_name(value)
            if metric is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    tracked[t.id] = metric
                elif isinstance(t, ast.Attribute):
                    tracked[t.attr] = metric
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Return) \
                        and isinstance(stmt.value, ast.Call):
                    metric = _slo_registration_name(stmt.value)
                    if metric is not None:
                        accessors[node.name] = metric
    if not tracked and not accessors:
        return

    def _inc_metric(call: ast.Call) -> Optional[str]:
        """Metric name when ``call`` is ``<slo counter>.inc(...)``."""
        f = call.func
        if not (isinstance(f, ast.Attribute) and f.attr == "inc"):
            return None
        v = f.value
        if isinstance(v, ast.Name):
            return tracked.get(v.id)
        if isinstance(v, ast.Attribute):
            return tracked.get(v.attr)
        if isinstance(v, ast.Call):  # shed_counter().inc(...)
            g = v.func
            if isinstance(g, ast.Name):
                return accessors.get(g.id)
            if isinstance(g, ast.Attribute):
                return accessors.get(g.attr)
        return None

    # pass 2: every function incrementing an SLO counter must also call
    # slo_exemplar (the trace_id may legitimately be None at runtime —
    # the contract is that the CALL SITE forwards one when it exists)
    for _name, fn in sorted(_defs_and_calls(tree).items()):
        for f in fn:
            has_exemplar = "slo_exemplar" in _called_names(f)
            if has_exemplar:
                continue
            for node in ast.walk(f):
                if isinstance(node, ast.Call):
                    metric = _inc_metric(node)
                    if metric is not None:
                        out.append(Violation(
                            "slo-exemplar", rel, node.lineno,
                            f"{metric}.inc() in '{f.name}' without a "
                            "slo_exemplar(...) call recording the "
                            "offending trace_id — an SLO violation count "
                            "with no exemplar cannot be traced back to a "
                            "request (docs/OBSERVABILITY.md)"))


_CHECKS = (_check_host_sync, _check_socket_hot, _check_wall_clock,
           _check_unseeded_random,
           _check_swallow, _check_mutable_default, _check_pytree_order,
           _check_grad_overlap, _check_slo_exemplar)


# ------------------------------------------------------------------- scan
def scan_file(path: str, rel: str) -> List[Violation]:
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Violation("parse-error", rel, e.lineno or 0,
                          f"syntax error during scan: {e.msg}")]
    raw: List[Violation] = []
    root = path[:len(path) - len(rel)] if path.endswith(rel) else os.path.dirname(path)
    for chk in _CHECKS:
        if chk is _check_grad_overlap:
            chk(rel, tree, raw, root)
        else:
            chk(rel, tree, raw)
    # dedup by (rule, line): a sync inside a nested def is visited both
    # through the enclosing function's walk and as its own reachable
    # entry — report it once
    seen_keys: Set[Tuple[str, int]] = set()
    deduped: List[Violation] = []
    for v in raw:
        if (v.rule, v.lineno) not in seen_keys:
            seen_keys.add((v.rule, v.lineno))
            deduped.append(v)
    raw = deduped
    allows = _allows(src)
    stmt_starts = _stmt_starts(tree)
    out: List[Violation] = []
    for v in raw:
        reason = _suppressed(allows, v.lineno, v.rule,
                             stmt_starts.get(v.lineno))
        if reason is None:
            out.append(v)
        elif not reason:
            out.append(Violation(
                v.rule, v.rel, v.lineno,
                f"allow[{v.rule}] marker without a reason: every "
                "suppression must say WHY (was: " + v.message[:80] + ")"))
    # markers that allow an unknown rule are typos that silently
    # suppress nothing — surface them
    for ln, rules, _reason in _markers(src):
        for r in sorted(rules - set(RULES)):
            out.append(Violation(
                "bad-allow", rel, ln,
                f"allow[{r}] names an unknown rule (known: "
                f"{', '.join(RULES)})"))
    return out


def check(root: str, subdirs: Iterable[str] = (PKG,)) -> List[Violation]:
    out: List[Violation] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, _dirs, files in os.walk(base):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root)
                out.extend(scan_file(path, rel))
    out.sort(key=lambda v: (v.rel, v.lineno, v.rule))
    return out


def suppressions(root: str, subdirs: Iterable[str] = (PKG,)
                 ) -> List[Tuple[str, int, Set[str], str]]:
    """Every allow marker in the tree, with its reason — the audit view."""
    out = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, _dirs, files in os.walk(base):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root)
                with open(path) as f:
                    for ln, rules, reason in _markers(f.read()):
                        out.append((rel, ln, rules, reason))
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    root = argv[0] if argv else os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    violations = check(root)
    if violations:
        print(f"port hazard lint: {len(violations)} violation(s)")
        for v in violations:
            print(f"  ERROR: {v}")
        return 1
    n_allows = len(suppressions(root))
    print(f"port hazard lint: OK ({n_allows} documented suppressions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
