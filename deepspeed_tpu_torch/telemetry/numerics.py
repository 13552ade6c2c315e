"""Numerics observatory: training-health stats + anomaly sentinel (the
port's counterpart of ``deepspeed_tpu/telemetry/numerics.py``).

Three parts:

1. **Stat builders** — torch reductions over device tensors: tree and
   per-layer norms / max-abs / nonfinite counts, per-leaf nonfinite
   counts keyed by the JAX package's pytree path strings, EF-residual
   norms per ``comm_errors`` slot, and bit-exact leaf checksums for the
   cross-rank divergence audit.  The JAX engine computes them inside
   every fused step and pulls them at the ``steps_per_print`` boundary;
   the port's eager engine takes per-tensor norms only on the step that
   ends at a boundary (:func:`leaf_stats`: ``torch._foreach_norm`` over
   the leaf list), keeps them on the device, copies them to the host once
   (:func:`pull_to_host`, which counts nonfinite elements exactly where a
   norm is nonfinite) and folds them there into the builders' numbers
   (:func:`fold_leaf_stats`).  A step that ends off a boundary runs none
   of this.

   Trees: nested dicts, lists, tensors or a ``ParamTree``.  The port
   keeps a model's layers as a LIST of per-layer trees where the JAX
   package stacks them ``[L, ...]``; a list whose elements are all
   sub-trees (dicts / ``ParamTree``s) reads as that stack — its leaves
   are keyed ``layers/attn/wq`` as JAX keys the stacked leaf, and summed
   over the layers — while a list of tensors is indexed (``0``, ``1``,
   ...) as JAX indexes one.  Dict keys are visited in sorted order, as
   ``jax.tree_util`` flattens a dict.

2. **:class:`NumericsLedger`** — the host-side anomaly sentinel
   (unchanged): at every boundary it folds the pulled stats into rolling
   windows and runs the detectors (nonfinite / loss-spike /
   grad-norm-spike / overflow-storm / stagnant-loss / divergence).  A
   firing detector counts
   ``deepspeed_tpu_train_numerics_anomalies_total{kind}``, fires ONE
   flight-recorder dump carrying the full per-layer breakdown, and
   records a pending incident that the next checkpoint commit stamps into
   its manifest meta (``checkpoint/saving.py``).

3. **:func:`compare_rank_checksums`** — the host half of the divergence
   audit (unchanged): given per-rank ``{path: checksum}`` maps it names
   the FIRST diverging leaf.

This module is the single owner of the ``deepspeed_tpu_train_numerics_*``
metric family.
"""

from __future__ import annotations

import collections
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .registry import MetricsRegistry, get_registry

__all__ = [
    "NumericsLedger", "tree_health", "stacked_health", "leaf_nonfinite",
    "leaf_checksums", "ef_residual_norms", "activation_stats",
    "compare_rank_checksums", "shape_boundary_report",
    "get_numerics_ledger", "set_numerics_ledger",
    "last_numerics_summary", "pending_incident_meta",
    "pull_to_host", "leaf_stats", "fold_leaf_stats", "leaf_index",
]

#: anomaly kinds the sentinel can emit (the {kind} label values)
ANOMALY_KINDS = ("nonfinite", "loss_spike", "grad_spike", "overflow_storm",
                 "stagnant_loss", "divergence")


# ---------------------------------------------------------------- tree utils
def _is_subtree(node: Any) -> bool:
    return isinstance(node, (dict, torch.nn.Module))


def _children(node: Any) -> List[Tuple[str, Any]]:
    """A dict's or a ``ParamTree``'s children in sorted key order (a
    ``ParamTree``'s parameters and sub-trees are one namespace, as the
    JAX dict they mirror)."""
    if isinstance(node, torch.nn.Module):
        items = dict(node._parameters)
        items.update(node._modules)
    else:
        items = node
    return sorted(((str(k), v) for k, v in items.items()), key=lambda kv: kv[0])


def _walk(node: Any, path: Tuple[str, ...], out: "collections.OrderedDict") -> None:
    if node is None:
        return
    if _is_subtree(node):
        for k, v in _children(node):
            _walk(v, path + (k,), out)
        return
    if isinstance(node, (list, tuple, torch.nn.ModuleList)):
        items = list(node)
        if items and all(_is_subtree(v) for v in items):
            for v in items:  # a stack of layers: same paths, one entry per layer
                _walk(v, path, out)
        else:
            for i, v in enumerate(items):
                _walk(v, path + (str(i),), out)
        return
    out.setdefault("/".join(path), []).append(node)


def _groups(tree: Any) -> "collections.OrderedDict":
    """``{path: [tensor per layer]}`` in the JAX package's leaf order."""
    out: collections.OrderedDict = collections.OrderedDict()
    _walk(tree, (), out)
    return out


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
            for ts in _groups(tree).values() for t in ts]


def _f32_stats(ts: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tensor fp32 (L2 norm, max-abs, nonfinite count) as three
    vectors: the norms batched over the list, the counts stacked."""
    fl = [t if t.is_floating_point() else t.float() for t in ts]
    norm = torch.stack(torch._foreach_norm(fl, 2, dtype=torch.float32))
    max_abs = torch.stack(torch._foreach_norm(fl, float("inf"), dtype=torch.float32))
    nonfinite = torch.stack([torch.isfinite(t).logical_not_().sum() for t in fl])
    return norm, max_abs, nonfinite


# ------------------------------------------------------------ stat builders
def tree_health(tree: Any, inv_scale=None) -> Dict[str, Any]:
    """Whole-tree health scalars: fp32 L2 norm, max-abs and nonfinite
    element count over every leaf.  ``inv_scale`` (e.g.
    ``1 / (gas * loss_scale)``) rescales the magnitude stats so fp16
    loss-scaled gradients report their TRUE magnitudes; nonfinite counts
    are scale-invariant and stay raw."""
    ts = _tensors(tree)
    if not ts:
        z = torch.zeros((), dtype=torch.float32)
        return {"norm": z, "max_abs": z, "nonfinite": torch.zeros((), dtype=torch.int32)}
    n, m, c = _f32_stats(ts)
    norm = torch.sqrt(torch.sum(torch.square(n)))
    max_abs = torch.max(m)
    if inv_scale is not None:
        norm = norm * inv_scale
        max_abs = max_abs * inv_scale
    return {"norm": norm, "max_abs": max_abs, "nonfinite": c.sum().to(torch.int32)}


def stacked_health(subtree: Any, inv_scale=None) -> Optional[Dict[str, Any]]:
    """Per-layer health: ``[L]`` fp32 norm, max-abs and nonfinite count
    vectors.  ``subtree`` is the port's list of per-layer trees (the JAX
    stacked tree's layers, in order), or a JAX-layout tree whose leaves
    share a leading layer dim.  None when the tree is empty or is not a
    stack: layers whose leaf paths differ, or leading dims that
    disagree."""
    if isinstance(subtree, (list, tuple, torch.nn.ModuleList)):
        layers = list(subtree)
        if not layers:
            return None
        per = [_groups(layer) for layer in layers]
        keys = list(per[0])
        if not keys or any(list(g) != keys for g in per):
            return None
        ts = [t for g in per for k in keys for t in g[k]]
        L, k = len(layers), len(ts) // len(layers)
        n, m, c = _f32_stats([t.detach() for t in ts])
        norm = torch.sqrt(torch.sum(torch.square(n).reshape(L, k), dim=1))
        max_abs = torch.max(m.reshape(L, k), dim=1).values
        nonfinite = c.reshape(L, k).sum(dim=1).to(torch.int32)
    else:
        ts = _tensors(subtree)
        if not ts or any(t.dim() < 1 for t in ts):
            return None
        L = ts[0].shape[0]
        if any(t.shape[0] != L for t in ts) or L == 0:
            return None
        rows = [t[i] for i in range(L) for t in ts]  # views, layer-major
        n, m, c = _f32_stats(rows)
        k = len(ts)
        norm = torch.sqrt(torch.sum(torch.square(n).reshape(L, k), dim=1))
        max_abs = torch.max(m.reshape(L, k), dim=1).values
        nonfinite = c.reshape(L, k).sum(dim=1).to(torch.int32)
    if inv_scale is not None:
        norm = norm * inv_scale
        max_abs = max_abs * inv_scale
    return {"norm": norm, "max_abs": max_abs, "nonfinite": nonfinite}


def leaf_nonfinite(tree: Any) -> Dict[str, Any]:
    """Per-leaf nonfinite element counts keyed by the JAX pytree path
    (a stacked leaf's count summed over its layers).  This is what lets a
    dump NAME the offending leaf (``layers/attn/wq`` or ``layer_1/w``)
    instead of reporting a global count."""
    groups = _groups(tree)
    if not groups:
        return {}
    ts = [t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
          for g in groups.values() for t in g]
    _, _, c = _f32_stats(ts)
    out, i = {}, 0
    for path, g in groups.items():
        out[path] = c[i:i + len(g)].sum().to(torch.int32)
        i += len(g)
    return out


def activation_stats(x: Any) -> Any:
    """``[3]`` fp32 activation-health row for one layer's output:
    ``(l2_norm, max_abs, nonfinite_count)``.  Read from ``x`` without
    feeding anything back (no autograd edge)."""
    f = torch.as_tensor(x).detach()
    return torch.stack([torch.linalg.vector_norm(f, 2, dtype=torch.float32),
                        torch.linalg.vector_norm(f, float("inf"), dtype=torch.float32),
                        torch.isfinite(f).logical_not_().sum().to(torch.float32)])


def ef_residual_norms(comm_errors: Any) -> Dict[str, Any]:
    """Per-slot L2 norm of the error-feedback residual state.
    ``comm_errors`` maps a slot (``overlap`` / ``reduce`` / ``pipe``) to
    its residual tree.  A residual whose norm grows without bound means
    EF is diverging, not converging."""
    out = {}
    for slot, sub in (comm_errors or {}).items():
        ts = _tensors(sub)
        if not ts:
            continue
        n, _, _ = _f32_stats(ts)
        out[str(slot)] = torch.sqrt(torch.sum(torch.square(n)))
    return out


#: same-width integer view of each element size, and its unsigned mask
_INT_OF_WIDTH = {1: (torch.uint8, 0xFF), 2: (torch.int16, 0xFFFF),
                 4: (torch.int32, 0xFFFFFFFF)}


def _checksum(x: torch.Tensor) -> torch.Tensor:
    """Sum mod 2^32 of ``x``'s elements read as unsigned integers of their
    own width (int64 accumulation: torch has no uint32 sum)."""
    x = x.detach()
    width = _INT_OF_WIDTH.get(x.element_size())
    if width is None:  # exotic width: hash the fp32 cast instead
        x = x.float()
        width = _INT_OF_WIDTH[4]
    idt, mask = width
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    bits = x.contiguous().view(idt).to(torch.int64) & mask
    return bits.sum() & 0xFFFFFFFF


def leaf_checksums(tree: Any) -> Dict[str, Any]:
    """Bit-exact per-leaf checksums keyed by the JAX pytree path: each
    leaf read as the same-width unsigned int and summed mod 2^32 (a
    stacked leaf over all its layers), equal to the JAX package's
    ``uint32`` sums.  Integer addition is exact and commutative, so two
    ranks holding bit-identical leaves ALWAYS produce equal sums, and a
    single flipped mantissa bit changes the sum."""
    out = {}
    for path, g in _groups(tree).items():
        s = torch.stack([_checksum(torch.as_tensor(t)) for t in g]).sum()
        out[path] = s & 0xFFFFFFFF
    return out


#: the key of a :func:`leaf_stats` dict that holds its tensors (never copied)
TENSORS = "_tensors"


def leaf_stats(tensors: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """Per-tensor fp32 L2 norm and max-abs vectors over a list of tensors,
    each batched over the whole list (``torch._foreach_norm``): the
    training engine's boundary stats, folded on the host
    (:func:`fold_leaf_stats`) into the whole-tree, per-leaf and per-layer
    numbers the builders above give.  The nonfinite counts are not
    reduced here: a tensor holds a nonfinite element only if its L2 norm
    is nonfinite (a NaN or an Inf propagates into the sum of squares), so
    :func:`pull_to_host` counts exactly, after its one copy, only the
    tensors whose norm came back nonfinite — a healthy boundary costs two
    batched reductions per list and no per-tensor launch.  The tensors
    are kept (``TENSORS``) until then; their finiteness must not change
    meanwhile (scaling by a finite factor, as the update's unscale and
    clip do, keeps it)."""
    fl = [t.detach() if t.is_floating_point() else t.detach().float() for t in tensors]
    if not fl:
        z = torch.zeros(0, dtype=torch.float32)
        return {"norm": z, "max_abs": z, TENSORS: []}
    return {"norm": torch.stack(torch._foreach_norm(fl, 2, dtype=torch.float32)),
            "max_abs": torch.stack(torch._foreach_norm(fl, float("inf"), dtype=torch.float32)),
            TENSORS: fl}


def fold_leaf_stats(host: Dict[str, Any], index: Sequence[Tuple[str, Optional[int]]],
                    scale: float = 1.0) -> Dict[str, Any]:
    """Fold a pulled :func:`leaf_stats` dict into ``{"whole", "leaf",
    "layers"}``: the whole list's health (as :func:`tree_health`), the
    nonfinite counts per JAX leaf path (as :func:`leaf_nonfinite`), and the
    per-layer vectors (as :func:`stacked_health`; None when no tensor is a
    layer's or the layers' paths differ).  ``index[i]`` is tensor i's (JAX
    path, layer or None); ``scale`` multiplies the magnitudes (the
    gradients' ``inv_scale``)."""
    n = np.asarray(host["norm"], np.float64).reshape(-1)
    m = np.asarray(host["max_abs"], np.float64).reshape(-1)
    c = np.asarray(host["nonfinite"], np.int64).reshape(-1)

    def health(idx):
        if not idx:
            return {"norm": 0.0, "max_abs": 0.0, "nonfinite": 0}
        return {"norm": float(np.sqrt(np.sum(np.square(n[idx])))) * scale,
                "max_abs": float(np.max(m[idx])) * scale, "nonfinite": int(np.sum(c[idx]))}

    whole = health(list(range(len(n))))
    leaf: Dict[str, int] = {}
    by_layer: Dict[int, List[int]] = {}
    paths: Dict[int, List[str]] = {}
    for i, (path, layer) in enumerate(index):
        leaf[path] = leaf.get(path, 0) + int(c[i])
        if layer is not None:
            by_layer.setdefault(layer, []).append(i)
            paths.setdefault(layer, []).append(path)
    layers = None
    order = sorted(by_layer)
    if order and order == list(range(len(order))) \
            and all(paths[l] == paths[order[0]] for l in order):
        rows = [health(by_layer[l]) for l in order]
        layers = {k: np.asarray([r[k] for r in rows]) for k in ("norm", "max_abs", "nonfinite")}
    return {"whole": whole, "leaf": leaf, "layers": layers}


def leaf_index(names: Sequence[str]) -> List[Tuple[str, Optional[int]]]:
    """(JAX path, layer or None) of each dotted ``named_parameters`` name:
    ``layers.3.attn.wq`` -> ``("layers/attn/wq", 3)``, the JAX package's
    key of the stacked leaf that layer's tensor is a slice of."""
    out = []
    for name in names:
        parts = name.split(".")
        layer = next((int(p) for p in parts if p.isdigit()), None)
        out.append(("/".join(p for p in parts if not p.isdigit()), layer))
    return out


def pull_to_host(stats: Any) -> Any:
    """The whole stats tree to the host in ONE device-to-host copy per
    device: every tensor leaf is packed into one float64 vector (counts
    are far below 2^53, so exact), copied, and unpacked into numpy scalars
    and arrays of the leaf's own kind (integers for integer leaves).  A
    :func:`leaf_stats` dict comes back with its ``nonfinite`` counts, read
    exactly for the tensors whose norms are nonfinite (one more read each,
    only then)."""
    leaves: List[torch.Tensor] = []

    def collect(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k != TENSORS:
                    collect(v)
        elif isinstance(node, torch.Tensor):
            leaves.append(node)

    collect(stats)
    if not leaves:
        return stats
    by_dev: Dict[torch.device, List[int]] = collections.OrderedDict()
    for i, t in enumerate(leaves):
        by_dev.setdefault(t.device, []).append(i)
    parts: List[Any] = [None] * len(leaves)
    for dev, idx in by_dev.items():
        host = torch.cat([leaves[i].detach().reshape(-1).to(torch.float64)
                          for i in idx]).cpu().numpy()
        off = 0
        for i in idx:
            n = leaves[i].numel()
            parts[i] = host[off:off + n]
            off += n
    flat = np.concatenate(parts) if parts else np.zeros(0)
    pos = [0]

    def build(node):
        if isinstance(node, dict):
            out = {k: build(v) for k, v in node.items() if k != TENSORS}
            if TENSORS in node:  # a leaf_stats dict: count where a norm is nonfinite
                bad = ~(np.isfinite(out["norm"]) & np.isfinite(out["max_abs"]))
                counts = np.zeros(len(node[TENSORS]), np.int64)
                for i in np.nonzero(np.atleast_1d(bad))[0]:
                    counts[i] = int(torch.isfinite(node[TENSORS][i]).logical_not_().sum())
                out["nonfinite"] = counts
            return out
        if not isinstance(node, torch.Tensor):
            return node
        n = node.numel()
        vals = flat[pos[0]:pos[0] + n].reshape(tuple(node.shape))
        pos[0] += n
        if not node.is_floating_point():
            vals = vals.astype(np.int64)
        return vals[()] if node.dim() == 0 else vals

    return build(stats)


# ------------------------------------------------------- divergence (host)
def compare_rank_checksums(per_rank: Dict[Any, Dict[str, int]]) -> dict:
    """Host half of the divergence audit: given ``{rank: {path: sum}}``
    maps, name every leaf whose checksum differs across ranks.  Returns
    ``{"ok", "ranks", "first_diverging_leaf", "diverging"}`` — the first
    diverging leaf (lexicographic path order, stable across runs) is
    what the anomaly and the dump report."""
    ranks = sorted(per_rank, key=str)
    if len(ranks) < 2:
        return {"ok": True, "ranks": len(ranks),
                "first_diverging_leaf": None, "diverging": []}
    paths = sorted({p for r in ranks for p in per_rank[r]})
    diverging = []
    for p in paths:
        vals = {int(per_rank[r][p]) for r in ranks if p in per_rank[r]}
        if len(vals) > 1:
            diverging.append(p)
    return {"ok": not diverging, "ranks": len(ranks),
            "first_diverging_leaf": diverging[0] if diverging else None,
            "diverging": diverging}


def shape_boundary_report(host: dict) -> dict:
    """Shape the engine's pulled (host-side) stats tree into the
    sentinel's boundary report: scalars to Python numbers plus the
    'which layer went nonfinite first' attribution — activation stats
    give the forward-order first offender; gradient per-layer counts
    are the fallback attribution.  Pure host-side numpy (the one
    device-to-host copy, :func:`pull_to_host`, already happened in the
    engine)."""
    rep = {
        "loss": float(host["loss"]),
        "grad_norm": float(host["grad_norm"]),
        "skipped_steps": int(host["skipped_steps"]),
        "grad_nonfinite": int(host["grad"]["nonfinite"]),
        "grad_norm_unscaled": float(host["grad"]["norm"]),
        "grad_max_abs": float(host["grad"]["max_abs"]),
        "param_norm": float(host["param"]["norm"]),
        "param_max_abs": float(host["param"]["max_abs"]),
        "param_nonfinite": int(host["param"]["nonfinite"]),
        "opt_nonfinite": int(host["opt_nonfinite"]),
    }
    ls = host.get("loss_scale")
    if ls is not None:
        rep["loss_scale"] = float(ls["cur_scale"])
        rep["loss_scale_growth_tracker"] = int(ls["growth_tracker"])
    layers: dict = {}
    first_layer = None
    al = host.get("act_layers")
    if al is not None:
        a = np.asarray(al, np.float64)
        layers["act_norm"] = [float(v) for v in a[:, 0]]
        layers["act_max_abs"] = [float(v) for v in a[:, 1]]
        layers["act_nonfinite"] = [int(v) for v in a[:, 2]]
        bad = np.nonzero(~np.isfinite(a[:, :2]).all(axis=1)
                         | (a[:, 2] > 0))[0]
        if bad.size:
            first_layer = int(bad[0])
    gl = host.get("grad_layers")
    if gl is not None:
        nf = np.asarray(gl["nonfinite"])
        layers["grad_norm"] = [float(v) for v in np.asarray(gl["norm"])]
        layers["grad_max_abs"] = [float(v)
                                  for v in np.asarray(gl["max_abs"])]
        layers["grad_nonfinite"] = [int(v) for v in nf]
        bad = np.nonzero(nf > 0)[0]
        if bad.size and first_layer is None:
            first_layer = int(bad[0])
    pl = host.get("param_layers")
    if pl is not None:
        layers["param_norm"] = [float(v) for v in np.asarray(pl["norm"])]
    if layers:
        rep["layers"] = layers
    if first_layer is not None:
        rep["first_nonfinite_layer"] = first_layer
    leaf_nf = host.get("grad_leaf_nonfinite") or {}
    bad_leaves = sorted(p for p, v in leaf_nf.items() if int(v) > 0)
    if bad_leaves:
        rep["first_nonfinite_leaf"] = bad_leaves[0]
        rep["nonfinite_leaves"] = bad_leaves[:16]
    ef = host.get("ef_residual")
    if ef:
        rep["ef_residual_norm"] = {str(k): float(v)
                                   for k, v in ef.items()}
    efb = host.get("ef_bucket")
    if efb:
        rep["ef_bucket_norm"] = {str(k): float(v)
                                 for k, v in efb.items()}
    return rep


# ----------------------------------------------------------- host sentinel
def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _json_safe(obj):
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)  # json.dump(allow_nan=False)-safe
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    try:
        f = float(obj)
    except (TypeError, ValueError):
        return str(obj)
    return _json_safe(f) if isinstance(f, float) else f


class NumericsLedger:
    """Anomaly sentinel + numerics accounting (host side, boundary
    cadence only).  The engine pulls the device stats tree at its
    ``steps_per_print`` boundary and feeds :meth:`observe_boundary`;
    everything here is plain Python on already-pulled values."""

    def __init__(self, config=None, registry: Optional[MetricsRegistry] = None):
        self.config = config
        reg = registry or get_registry()
        hist = int(getattr(config, "history", 64) or 64)
        self.min_history = max(2, int(getattr(config, "min_history", 8)))
        self.loss_spike_factor = float(getattr(config, "loss_spike_factor", 3.0))
        self.grad_spike_factor = float(getattr(config, "grad_spike_factor", 10.0))
        self.overflow_storm = int(getattr(config, "overflow_storm", 3))
        self.stagnant_boundaries = int(getattr(config, "stagnant_boundaries", 8))
        self.stagnant_tol = float(getattr(config, "stagnant_tol", 0.0))
        self._loss_hist: collections.deque = collections.deque(maxlen=hist)
        self._gnorm_hist: collections.deque = collections.deque(maxlen=hist)
        self._last_skipped: Optional[int] = None
        self._last_report: Optional[dict] = None
        self._last_anomalies: List[dict] = []
        self._pending_incident: Optional[dict] = None
        self.boundaries = 0
        self.anomaly_counts: Dict[str, int] = {}
        # --- deepspeed_tpu_train_numerics_* family (single owner: this
        # module; analysis/metric_lint.py pins it)
        self._m_anomalies = reg.counter(
            "deepspeed_tpu_train_numerics_anomalies_total",
            "Numerics-sentinel anomaly detections by kind",
            labelnames=("kind",))
        self._m_boundaries = reg.counter(
            "deepspeed_tpu_train_numerics_boundaries_total",
            "Numerics boundary observations (stats pulls)")
        self._m_nonfinite = reg.gauge(
            "deepspeed_tpu_train_numerics_grad_nonfinite_elems",
            "Nonfinite gradient elements at the last numerics boundary")
        self._m_gnorm_median = reg.gauge(
            "deepspeed_tpu_train_numerics_grad_norm_median",
            "Rolling-median global gradient norm (sentinel window)")
        self._m_div_failures = reg.counter(
            "deepspeed_tpu_train_numerics_divergence_failures_total",
            "Cross-data-rank divergence-audit failures")

    # ------------------------------------------------------------ detectors
    def _detect(self, report: dict) -> List[dict]:
        anomalies: List[dict] = []
        loss = report.get("loss")
        gnorm = report.get("grad_norm")
        nonfinite = int(report.get("grad_nonfinite") or 0)
        loss_bad = loss is not None and not math.isfinite(loss)
        if nonfinite > 0 or loss_bad:
            anomalies.append({
                "kind": "nonfinite",
                "nonfinite_elems": nonfinite,
                "loss": _json_safe(loss),
                "first_nonfinite_layer": report.get("first_nonfinite_layer"),
                "first_nonfinite_leaf": report.get("first_nonfinite_leaf"),
            })
        if (loss is not None and math.isfinite(loss)
                and len(self._loss_hist) >= self.min_history):
            med = _median(self._loss_hist)
            if med > 0 and loss > self.loss_spike_factor * med:
                anomalies.append({"kind": "loss_spike", "loss": loss,
                                  "rolling_median": med,
                                  "factor": loss / med})
        if (gnorm is not None and math.isfinite(gnorm)
                and len(self._gnorm_hist) >= self.min_history):
            med = _median(self._gnorm_hist)
            if med > 0 and gnorm > self.grad_spike_factor * med:
                anomalies.append({"kind": "grad_spike", "grad_norm": gnorm,
                                  "rolling_median": med,
                                  "factor": gnorm / med})
        skipped = report.get("skipped_steps")
        if skipped is not None and self._last_skipped is not None:
            delta = int(skipped) - self._last_skipped
            if delta >= max(1, self.overflow_storm):
                anomalies.append({"kind": "overflow_storm",
                                  "skipped_since_last_boundary": delta,
                                  "loss_scale": report.get("loss_scale")})
        if (self.stagnant_boundaries > 0 and loss is not None
                and math.isfinite(loss)):
            recent = list(self._loss_hist)[-(self.stagnant_boundaries - 1):] \
                + [loss]
            if (len(recent) >= self.stagnant_boundaries
                    and max(recent) - min(recent) <= self.stagnant_tol):
                anomalies.append({"kind": "stagnant_loss",
                                  "boundaries": len(recent),
                                  "loss": loss,
                                  "tolerance": self.stagnant_tol})
        div = report.get("divergence")
        if div is not None and not div.get("ok", True):
            self._m_div_failures.inc()
            anomalies.append({
                "kind": "divergence",
                "first_diverging_leaf": div.get("first_diverging_leaf"),
                "diverging": list(div.get("diverging") or [])[:16],
                "ranks": div.get("ranks"),
            })
        return anomalies

    # ------------------------------------------------------------- observe
    def observe_boundary(self, report: dict) -> List[dict]:
        """Fold one boundary report, run the detectors, fire the flight
        dump + metrics on anomaly.  Returns the anomaly list (empty =
        healthy boundary)."""
        self.boundaries += 1
        self._m_boundaries.inc()
        anomalies = self._detect(report)
        loss, gnorm = report.get("loss"), report.get("grad_norm")
        # spikes are judged against the HEALTHY window: fold after
        # detection, and never fold nonfinite values (they would poison
        # every later median)
        if loss is not None and math.isfinite(loss):
            self._loss_hist.append(float(loss))
        if gnorm is not None and math.isfinite(gnorm):
            self._gnorm_hist.append(float(gnorm))
        skipped = report.get("skipped_steps")
        if skipped is not None:
            self._last_skipped = int(skipped)
        self._m_nonfinite.set(float(report.get("grad_nonfinite") or 0))
        if self._gnorm_hist:
            self._m_gnorm_median.set(_median(self._gnorm_hist))
        self._last_report = _json_safe(report)
        self._last_anomalies = _json_safe(anomalies)
        if anomalies:
            for a in anomalies:
                kind = a["kind"]
                self._m_anomalies.inc(kind=kind)
                self.anomaly_counts[kind] = self.anomaly_counts.get(kind, 0) + 1
            self._record_incident(report, anomalies)
            self._fire_dump(report, anomalies)
        return anomalies

    def _record_incident(self, report: dict, anomalies: List[dict]) -> None:
        """Pending incident for the NEXT checkpoint commit: stamped into
        the tag's manifest meta by ``checkpoint/saving.py`` so
        resume-time triage (``resilience/commit.py`` manifest readers)
        sees what went wrong and when."""
        self._pending_incident = _json_safe({
            "step": report.get("step"),
            "kinds": [a["kind"] for a in anomalies],
            "anomalies": anomalies,
        })

    def _fire_dump(self, report: dict, anomalies: List[dict]) -> None:
        """ONE flight dump per anomalous boundary, carrying the full
        per-layer breakdown (the dump's numerics record also rides every
        OTHER dump via :func:`last_numerics_summary`)."""
        try:
            from .flight import get_flight_recorder

            fr = get_flight_recorder()
            if fr is None:
                return
            fr.note("numerics_anomaly", step=report.get("step"),
                    kinds=[a["kind"] for a in anomalies])
            fr.dump(reason=f"numerics:{anomalies[0]['kind']}")
        # dstpu-lint: allow[swallow] the sentinel must never turn an
        # anomaly report into a training crash; the metrics still count
        except Exception:
            pass

    # ------------------------------------------------------------- readout
    def pending_incident(self) -> Optional[dict]:
        return self._pending_incident

    def consume_incident(self) -> Optional[dict]:
        """Pop the pending incident (one incident annotates ONE
        checkpoint tag; a later clean save must not re-stamp it)."""
        inc, self._pending_incident = self._pending_incident, None
        return inc

    def summary(self) -> dict:
        """JSON-safe snapshot for flight dumps / tools / bench annexes."""
        return {
            "boundaries": self.boundaries,
            "anomaly_counts": dict(self.anomaly_counts),
            "grad_norm_median": (_median(self._gnorm_hist)
                                 if self._gnorm_hist else None),
            "loss_median": (_median(self._loss_hist)
                            if self._loss_hist else None),
            "last_report": self._last_report,
            "last_anomalies": self._last_anomalies,
            "pending_incident": self._pending_incident,
        }

    # ------------------------------------------------- checkpoint round-trip
    def state_dict(self) -> dict:
        """Sentinel state for checkpoint client_state: the rolling
        windows and incident bookkeeping survive preemption-resume, so
        a spike right after restore is still judged against the real
        history (and a pre-crash incident is not lost)."""
        return _json_safe({
            "loss_hist": list(self._loss_hist),
            "gnorm_hist": list(self._gnorm_hist),
            "last_skipped": self._last_skipped,
            "boundaries": self.boundaries,
            "anomaly_counts": dict(self.anomaly_counts),
            "pending_incident": self._pending_incident,
        })

    def load_state_dict(self, state: Optional[dict]) -> None:
        if not state:
            return
        self._loss_hist.clear()
        self._loss_hist.extend(float(v) for v in state.get("loss_hist", []))
        self._gnorm_hist.clear()
        self._gnorm_hist.extend(float(v) for v in state.get("gnorm_hist", []))
        ls = state.get("last_skipped")
        self._last_skipped = None if ls is None else int(ls)
        self.boundaries = int(state.get("boundaries", 0))
        self.anomaly_counts = {str(k): int(v) for k, v in
                               (state.get("anomaly_counts") or {}).items()}
        self._pending_incident = state.get("pending_incident")


# ------------------------------------------------------- process default
_LEDGER: Optional[NumericsLedger] = None


def set_numerics_ledger(ledger: Optional[NumericsLedger]) -> None:
    global _LEDGER
    _LEDGER = ledger


def get_numerics_ledger() -> Optional[NumericsLedger]:
    return _LEDGER


def last_numerics_summary() -> Optional[dict]:
    """The numerics record every flight dump carries (same contract as
    ``last_goodput_summary`` / ``last_reqtrace_summary``): None when no
    ledger is live or nothing has been observed yet."""
    if _LEDGER is None or not _LEDGER.boundaries:
        return None
    return _LEDGER.summary()


def pending_incident_meta() -> Optional[dict]:
    """Consume the pending anomaly incident for a checkpoint commit's
    manifest meta (``checkpoint/saving.py``).  None when healthy."""
    if _LEDGER is None:
        return None
    inc = _LEDGER.consume_incident()
    if inc is None:
        return None
    # manifest meta is json.dump'd with default=str; make it round-trip
    return json.loads(json.dumps(inc, default=str))
