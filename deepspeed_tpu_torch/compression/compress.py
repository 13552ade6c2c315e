"""Compression transforms over a parameter tree (the port's counterpart of
``deepspeed_tpu/compression/compress.py``).

``init_compression`` returns the transformed parameters and the
:class:`CompressionScheduler` that made them; ``transform_params`` applies,
per global step, per-tensor fake quantization with a straight-through
gradient, magnitude pruning (masks made once, at the first pruning step)
and structured head and FFN-channel pruning; ``redundancy_clean`` folds the
masks in and, given the model config, slices pruned heads and channels out
of the arrays.  Nothing is changed in place: every call returns a new tree
(a ``ParamTree`` for a ``ParamTree``, a dict for a dict).

The port holds a transformer's layers as a list (``layers.<i>.mlp.w_up``);
the JAX package stacks them (``['layers']['mlp']['w_up']``, ``[L, ...]``).
The transforms keep the JAX results by working on the stacked view: a
leaf's name is its JAX path (``checkpoint/saving.leaf_paths``' mapping),
which the ``modules`` patterns match; its rank counts the layer axis; the
fake-quantization scale is ``max|w|`` over all L layers of a path, and the
pruning threshold is the k-th largest ``|w|`` over them (a radix select
over their bit patterns, the value a sort of the concatenation gives).
Structured importances are scored per layer in float64, so that which
channel a near-tie keeps does not hang on a device's reduction order; the
keeps are a stable argsort, as ``jnp.argsort`` is.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import ParamTree
from ..utils.logging import logger

Parts = Tuple[Any, ...]


@dataclasses.dataclass
class QuantizeConfig:
    enabled: bool = False
    bits: int = 8
    schedule_offset: int = 0
    groups: int = 1  # per-row groups
    modules: List[str] = dataclasses.field(default_factory=lambda: ["*"])


@dataclasses.dataclass
class PruneConfig:
    enabled: bool = False
    method: str = "l1"  # l1 | topk
    ratio: float = 0.5
    schedule_offset: int = 0
    modules: List[str] = dataclasses.field(default_factory=lambda: ["*"])


@dataclasses.dataclass
class LayerReductionConfig:
    """Depth reduction for distillation: the student keeps
    ``keep_number_layer`` layers, initialised from the teacher layers
    listed in ``teacher_layer``."""

    enabled: bool = False
    keep_number_layer: int = 0
    teacher_layer: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StructuredPruneConfig:
    """Head or FFN-channel pruning."""

    enabled: bool = False
    ratio: float = 0.25  # fraction of heads/channels REMOVED
    schedule_offset: int = 0


def _matches(key: str, patterns: List[str]) -> bool:
    for p in patterns:
        if p == "*" or re.search(p, key):
            return True
    return False


# ---------------------------------------------------------------- the tree
def _named_leaves(tree: Any, prefix: Parts = ()) -> List[Tuple[Parts, torch.Tensor]]:
    """Every tensor leaf with its path of keys and list indices."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.ModuleList):
        items = list(enumerate(tree))
    elif isinstance(tree, nn.Module):
        items = list(tree._parameters.items()) + list(tree._modules.items())
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"compression: parameter tree node {type(tree)}")
    return [leaf for k, v in items for leaf in _named_leaves(v, prefix + (k,))]


def _rebuild(tree: Any, fn: Callable[[Parts, torch.Tensor], torch.Tensor],
             layers: Optional[List[Any]] = None) -> Any:
    """A tree of the same structure with ``fn(path, leaf)`` at every leaf
    (its layer list walked from ``layers`` instead, when given); a
    ``ParamTree`` comes back as a new ``ParamTree``."""

    def walk(node, pre):
        if isinstance(node, torch.Tensor):
            return fn(pre, node.detach() if isinstance(node, nn.Parameter) else node)
        if layers is not None and pre == ("layers",):
            return [walk(lay, pre + (i,)) for i, lay in enumerate(layers)]
        if isinstance(node, nn.ModuleList):
            return [walk(v, pre + (i,)) for i, v in enumerate(node)]
        if isinstance(node, nn.Module):
            out = {k: walk(v, pre + (k,)) for k, v in node._parameters.items()}
            out.update({k: walk(v, pre + (k,)) for k, v in node._modules.items()})
            return out
        if isinstance(node, dict):
            return {k: walk(v, pre + (k,)) for k, v in node.items()}
        return type(node)(walk(v, pre + (i,)) for i, v in enumerate(node))

    out = walk(tree, ())
    return ParamTree(out) if isinstance(tree, nn.Module) else out


def _jax_path(parts: Parts) -> Tuple[str, Optional[int]]:
    """``('layers', 3, 'mlp', 'w_up')`` -> (``"['layers']['mlp']['w_up']"``,
    3): the JAX key path of the stacked leaf and the layer index."""
    layer = None
    keys = []
    for i, p in enumerate(parts):
        if isinstance(p, int) and i == 1 and parts[0] == "layers":
            layer = p
        else:
            keys.append(f"[{p}]" if isinstance(p, int) else f"['{p}']")
    return "".join(keys), layer


def _groups(tree: Any) -> Dict[str, List[Tuple[Parts, torch.Tensor]]]:
    """Leaves grouped by JAX path: a layer leaf's group holds its L slices
    in layer order (the stacked leaf), any other a single leaf."""
    out: Dict[str, List[Tuple[Optional[int], Parts, torch.Tensor]]] = {}
    for parts, t in _named_leaves(tree):
        key, layer = _jax_path(parts)
        out.setdefault(key, []).append((layer, parts, t))
    return {k: [(p, t) for _, p, t in sorted(v, key=lambda e: -1 if e[0] is None else e[0])]
            for k, v in out.items()}


def _stacked_ndim(members: List[Tuple[Parts, torch.Tensor]]) -> int:
    parts, t = members[0]
    return t.dim() + (1 if _jax_path(parts)[1] is not None else 0)


def _layers(tree: Any) -> Optional[List[Any]]:
    layers = tree.get("layers") if isinstance(tree, (dict, ParamTree)) else None
    return list(layers) if isinstance(layers, (list, nn.ModuleList)) else None


def _leaf(node: Any, *keys: str) -> Optional[torch.Tensor]:
    for k in keys:
        if node is None:
            return None
        node = node.get(k) if isinstance(node, (dict, ParamTree)) else None
    return node


# -------------------------------------------------------------- transforms
def _quantize_group(ws: List[torch.Tensor], bits: int) -> List[torch.Tensor]:
    """``w + (round(w / scale) * scale - w)``, the difference cut from the
    graph (the straight-through estimator), with one ``scale`` for the
    group: ``max|w|`` over all members / ``2^(bits-1) - 1``."""
    qmax = 2.0 ** (bits - 1) - 1
    with torch.no_grad():
        amax = torch.stack([torch.maximum(hi, -lo) for lo, hi in map(torch.aminmax, ws)]).max()
        # a tensor divisor: a Python scalar goes through its reciprocal on CUDA
        scale = torch.clamp_min(amax, 1e-12) / torch.tensor(qmax, dtype=amax.dtype,
                                                            device=amax.device)
        diffs = [torch.div(w, scale).round_().mul_(scale).sub_(w) for w in ws]
    # d + w is w + d (IEEE addition commutes): in d's storage unless w
    # carries a gradient to pass straight through
    return [w + d if w.requires_grad else d.add_(w) for w, d in zip(ws, diffs)]


def fake_quantize(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-tensor fake quantization with a straight-through
    gradient (``w + (q - w).detach()``)."""
    return _quantize_group([w], bits)[0]


def _kth_largest(xs: List[torch.Tensor], k: int) -> torch.Tensor:
    """The k-th largest value (1-based, ties counted) over the non-negative
    floats ``xs`` together, exactly what a sort of their concatenation
    would put at ``[-k]``: a radix select over the float32 bit patterns,
    which order as the values do, 11, 11 and 9 bits at a time.  It reads
    each member in place (no concatenated copy) and sorts nothing."""
    cands = [x.float().reshape(-1).view(torch.int32) for x in xs]
    rank, bits = k, 0
    for shift, width in ((20, 11), (9, 11), (0, 9)):
        digits = [torch.bitwise_right_shift(c, shift).bitwise_and_((1 << width) - 1)
                  for c in cands]
        hist = sum(torch.bincount(d, minlength=1 << width) for d in digits)
        at_or_above = hist.flip(0).cumsum(0).flip(0)
        d = int(torch.nonzero(at_or_above >= rank).max())
        rank -= int(at_or_above[d] - hist[d])
        bits |= d << shift
        cands = [c[dg == d] for c, dg in zip(cands, digits)]
    return torch.tensor(bits, dtype=torch.int32, device=xs[0].device).view(torch.float32)


def _prune_masks(ws: List[torch.Tensor], ratio: float) -> List[torch.Tensor]:
    """Keep-masks by magnitude over the group: ``|w| >=`` the k-th largest
    ``|w|`` of all its members, ``k = max(1, int(size * (1 - ratio)))``."""
    if ratio <= 0:
        return [torch.ones_like(w, dtype=torch.bool) for w in ws]
    mags = [w.abs() for w in ws]
    k = max(1, int(sum(m.numel() for m in mags) * (1.0 - ratio)))
    thresh = _kth_largest(mags, k).to(mags[0].dtype)
    return [m >= thresh for m in mags]


def prune_mask(w: torch.Tensor, ratio: float, method: str = "l1") -> torch.Tensor:
    """Boolean keep-mask by magnitude (``>=`` the threshold: ties kept);
    ``method`` l1 and topk both rank by ``|w|``."""
    return _prune_masks([w], ratio)[0]


def _norm64(w: torch.Tensor, dim: int) -> torch.Tensor:
    """L2 norm along ``dim``: the squares in ``w``'s dtype (one rounding
    each, the same on every device), summed in float64, where the order of
    the sum moves the result by ~1e-16 relative."""
    return w.square().sum(dim, dtype=torch.float64).sqrt()


def _stable_keep(imp: torch.Tensor, keep: int) -> torch.Tensor:
    """``[L, keep]`` indices of the ``keep`` largest scores per row, as the
    JAX package takes them: the tail of a stable ascending argsort, sorted."""
    n = imp.shape[-1]
    order = torch.argsort(imp, dim=-1, stable=True)
    return torch.sort(order[:, n - keep:], dim=-1).values


def _keep_mask(keep: torch.Tensor, n: int) -> torch.Tensor:
    mask = torch.zeros((keep.shape[0], n), dtype=torch.bool, device=keep.device)
    return mask.scatter(1, keep, True)


class CompressionScheduler:
    """Applies the configured compressions to parameters by global step
    (the reference's ``check_and_apply``)."""

    def __init__(self, config: Dict[str, Any]):
        wq = (config.get("weight_quantization", {})
              .get("shared_parameters", {}))
        sp = (config.get("sparse_pruning", {}).get("shared_parameters", {}))
        self.quant = QuantizeConfig(
            enabled=wq.get("enabled", False),
            bits=int(wq.get("quantize_weight_in_forward", 8)
                     if isinstance(wq.get("quantize_weight_in_forward"), int)
                     else wq.get("bits", 8)),
            schedule_offset=int(wq.get("schedule_offset", 0)))
        self.prune = PruneConfig(
            enabled=sp.get("enabled", False),
            method=sp.get("method", "l1"),
            ratio=float(sp.get("ratio", 0.5)),
            schedule_offset=int(sp.get("schedule_offset", 0)))
        hp = (config.get("head_pruning", {}).get("shared_parameters", {}))
        cp = (config.get("channel_pruning", {}).get("shared_parameters", {}))
        self.head_prune = StructuredPruneConfig(
            enabled=hp.get("enabled", False),
            ratio=1.0 - float(hp.get("dense_ratio", 1.0 - hp.get("ratio", 0.25))),
            schedule_offset=int(hp.get("schedule_offset", 0)))
        self.channel_prune = StructuredPruneConfig(
            enabled=cp.get("enabled", False),
            ratio=1.0 - float(cp.get("dense_ratio", 1.0 - cp.get("ratio", 0.25))),
            schedule_offset=int(cp.get("schedule_offset", 0)))
        lr = config.get("layer_reduction", {})
        self.layer_reduction = LayerReductionConfig(
            enabled=lr.get("enabled", False),
            keep_number_layer=int(lr.get("keep_number_layer", 0)),
            teacher_layer=list(lr.get("teacher_layer", [])))
        #: JAX path -> one keep-mask per member (None: not pruned)
        self._masks: Optional[Dict[str, List[Optional[torch.Tensor]]]] = None
        self._head_keep: Optional[torch.Tensor] = None  # [L, H_keep] kept heads
        self._head_col: Optional[torch.Tensor] = None  # [L, NH*D]
        self._chan_keep: Optional[torch.Tensor] = None  # [L, F_keep] kept channels
        self._chan_mask: Optional[torch.Tensor] = None  # [L, F]

    # -- structured pruning --------------------------------------------------
    def _structured_keeps(self, params: Any, n_heads: Optional[int],
                          do_head: bool, do_chan: bool) -> None:
        layers = _layers(params)
        if layers is None or _leaf(layers[0], "mlp") is None:
            if self.head_prune.enabled or self.channel_prune.enabled:
                logger.warning("structured pruning needs the models/* "
                               "transformer layout; disabling")
                self.head_prune.enabled = self.channel_prune.enabled = False
            return
        up0 = _leaf(layers[0], "mlp", "w_up")
        if do_chan and self._chan_keep is None and up0 is not None and up0.dim() == 2:
            imps = []
            for lay in layers:
                up, down = lay.get("mlp").get("w_up"), lay.get("mlp").get("w_down")
                imp = _norm64(up, 0) * _norm64(down, 1)
                gate = _leaf(lay, "mlp", "w_gate")
                if gate is not None and gate.dim() == 2:
                    imp = imp * _norm64(gate, 0)
                imps.append(imp)
            imp = torch.stack(imps)  # [L, F]
            n = imp.shape[-1]
            keep = max(1, int(round(n * (1.0 - self.channel_prune.ratio))))
            self._chan_keep = _stable_keep(imp, keep)
            self._chan_mask = _keep_mask(self._chan_keep, n)
        if do_head:
            if not n_heads:
                logger.warning("head_pruning enabled but n_heads was not "
                               "passed to init_compression/transform_params; "
                               "no heads will be pruned")
            elif self._head_keep is None:
                nd, h = layers[0].get("attn").get("wo").shape  # [NH*D, H]
                d = nd // n_heads
                imp = torch.stack([_norm64(lay.get("attn").get("wo").reshape(n_heads, d * h), -1)
                                   for lay in layers])  # [L, NH]
                keep = max(1, int(round(n_heads * (1.0 - self.head_prune.ratio))))
                self._head_keep = _stable_keep(imp, keep)
                self._head_col = torch.repeat_interleave(_keep_mask(self._head_keep, n_heads),
                                                         d, dim=-1)  # [L, NH*D]

    def _structured_mask(self, parts: Parts, w: torch.Tensor, do_head: bool,
                         do_chan: bool, owned: bool) -> torch.Tensor:
        """``w`` times the structured masks that apply to its path (in
        place when ``owned``: a tensor this transform made)."""
        key, layer = _jax_path(parts)
        if layer is None:
            return w

        def times(m):
            return w.mul_(m) if owned else w * m

        if do_chan and self._chan_mask is not None:
            m = self._chan_mask[layer].to(device=w.device, dtype=w.dtype)
            if key in ("['layers']['mlp']['w_up']", "['layers']['mlp']['w_gate']"):
                w = times(m[None, :])
            elif key == "['layers']['mlp']['b_up']":
                w = times(m)
            elif key == "['layers']['mlp']['w_down']":
                w = times(m[:, None])
        if do_head and self._head_col is not None:
            # zero the head's output rows (kills its contribution) and its
            # query columns (kills its compute's gradient signal)
            c = self._head_col[layer].to(device=w.device, dtype=w.dtype)
            if key == "['layers']['attn']['wo']":
                w = times(c[:, None])
            elif key == "['layers']['attn']['wq']":
                w = times(c[None, :])
            elif key == "['layers']['attn']['bq']":
                w = times(c)
        return w

    def transform_params(self, params: Any, global_step: int,
                         n_heads: Optional[int] = None) -> Any:
        """The parameters as the forward at ``global_step`` sees them: a new
        tree; ``params`` is left as it was (a tensor this call made is
        masked in place, one of ``params`` never)."""
        originals: Dict[Parts, torch.Tensor] = dict(_named_leaves(params))
        cur = dict(originals)

        def owned(p: Parts) -> bool:
            return cur[p] is not originals[p]

        if self.quant.enabled and global_step >= self.quant.schedule_offset:
            for key, members in _groups(params).items():
                if _stacked_ndim(members) >= 2 and _matches(key, self.quant.modules):
                    qs = _quantize_group([cur[p] for p, _ in members], self.quant.bits)
                    cur.update({p: q for (p, _), q in zip(members, qs)})
        if self.prune.enabled and global_step >= self.prune.schedule_offset:
            if self._masks is None:
                self._masks = {}
                for key, members in _groups(params).items():
                    if _stacked_ndim(members) >= 2 and _matches(key, self.prune.modules):
                        self._masks[key] = _prune_masks([t for _, t in members],
                                                        self.prune.ratio)
            for key, members in _groups(params).items():
                for (p, _), m in zip(members, self._masks.get(key, ())):
                    # a negative weight masked is -0.0, as in JAX
                    cur[p] = cur[p].mul_(m) if owned(p) else cur[p] * m
        do_head = (self.head_prune.enabled
                   and global_step >= self.head_prune.schedule_offset)
        do_chan = (self.channel_prune.enabled
                   and global_step >= self.channel_prune.schedule_offset)
        if do_head or do_chan:
            self._structured_keeps(_rebuild(params, lambda p, t: cur[p]), n_heads,
                                   do_head, do_chan)
            # _structured_keeps may have disabled the feature (wrong layout)
            do_head = do_head and self.head_prune.enabled
            do_chan = do_chan and self.channel_prune.enabled
            if do_head or do_chan:
                cur = {p: self._structured_mask(p, t, do_head, do_chan, owned(p))
                       for p, t in cur.items()}
        return _rebuild(params, lambda p, t: cur[p] if owned(p) else cur[p].clone())


def student_initialization(student_params: Any, teacher_params: Any,
                           lr_config: LayerReductionConfig) -> Any:
    """A reduced-depth student from a teacher: the teacher's layers listed in
    ``teacher_layer`` (copies) and its other leaves (embeddings, final norm,
    LM head).  ``student_params`` gives the expected layer shapes (its values
    are discarded); a mismatch raises."""
    ids = list(lr_config.teacher_layer)
    if lr_config.keep_number_layer and \
            len(ids) != lr_config.keep_number_layer:
        raise ValueError(
            f"layer_reduction: teacher_layer {ids} does not match "
            f"keep_number_layer={lr_config.keep_number_layer}")
    t_layers, s_layers = _layers(teacher_params), _layers(student_params)
    n_teacher = len(t_layers)
    first = sorted(_jax_path(p)[0] for p, _ in _named_leaves(t_layers[0]))[0]
    if any(i < 0 or i >= n_teacher for i in ids):
        raise ValueError(f"layer_reduction: teacher_layer {ids} out of "
                         f"range for {first} with {n_teacher} layers")

    def shapes(layers):
        out: Dict[str, Tuple[int, ...]] = {}
        for lay in layers:
            for p, t in _named_leaves(lay):
                out[_jax_path(p)[0]] = (len(layers),) + tuple(t.shape)
        return out

    want, got = shapes(s_layers), shapes([t_layers[i] for i in ids])
    bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
    if bad:
        raise ValueError(f"layer_reduction: student/teacher layer shape "
                         f"mismatch at {bad}")

    def pick(parts: Parts, t: torch.Tensor) -> torch.Tensor:
        if parts[0] == "layers":  # the student's layer i is teacher layer ids[i]
            node = t_layers[ids[parts[1]]]
            for p in parts[2:]:
                node = node.get(p)
            return node.detach().clone()
        return t.clone()

    return _rebuild(teacher_params, pick, layers=s_layers)


def distillation_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """Soft-target KD loss: T^2-scaled cross-entropy of the student against
    the teacher's softened distribution, averaged over tokens (same
    gradients as KL(teacher || student))."""
    t = temperature
    sp = F.log_softmax(student_logits.float() / t, dim=-1)
    tp = F.softmax(teacher_logits.float() / t, dim=-1)
    return -torch.mean(torch.sum(tp * sp, dim=-1)) * (t * t)


def init_compression(params: Any, deepspeed_config: Dict[str, Any],
                     global_step: int = 0, n_heads: Optional[int] = None,
                     teacher_params: Any = None) -> Tuple[Any, CompressionScheduler]:
    """``(transformed params, scheduler)`` from the ds-config's
    ``compression_training`` block.  With ``teacher_params`` and an enabled
    ``layer_reduction``, ``params`` (the student) is first initialised from
    the teacher's configured layers."""
    sched = CompressionScheduler(deepspeed_config.get("compression_training", {}))
    if sched.layer_reduction.enabled and teacher_params is not None:
        params = student_initialization(params, teacher_params, sched.layer_reduction)
    return sched.transform_params(params, global_step, n_heads=n_heads), sched


def redundancy_clean(params: Any, scheduler: CompressionScheduler,
                     model_config: Any = None) -> Any:
    """Fold the masks into the weights for good.  With ``model_config`` (a
    ``TransformerConfig``), pruned FFN channels and (under MHA) attention
    heads are sliced out of the arrays and the config's
    ``intermediate_size``, ``n_heads``, ``n_kv_heads`` and
    ``head_dim_override`` follow: returns ``(params, new_config)``, else
    ``params``."""
    n_heads = getattr(model_config, "n_heads", None)
    out = scheduler.transform_params(params, global_step=10 ** 9, n_heads=n_heads)
    if model_config is None:
        return out

    cfg = copy.copy(model_config)
    chan = scheduler._chan_keep
    heads = None
    if scheduler._head_keep is not None and n_heads:
        if getattr(model_config, "kv_heads", n_heads) != n_heads:
            logger.warning("redundancy_clean: physical head pruning needs "
                           "MHA (kv_heads == n_heads); keeping masked heads")
        else:
            heads = scheduler._head_keep  # [L, H_keep]
    d = None
    if heads is not None:
        d = _layers(out)[0].get("attn").get("wo").shape[0] // n_heads

    def take_heads(w: torch.Tensor, dim: int, keep: torch.Tensor) -> torch.Tensor:
        shape = list(w.shape)
        split = shape[:dim] + [n_heads, d] + shape[dim + 1:]
        taken = torch.index_select(w.reshape(split), dim, keep.to(w.device))
        shape[dim] = keep.numel() * d
        return taken.reshape(shape)

    def shrink(parts: Parts, w: torch.Tensor) -> torch.Tensor:
        key, layer = _jax_path(parts)
        if layer is None:
            return w
        if chan is not None:
            k = chan[layer].to(w.device)
            if key in ("['layers']['mlp']['w_up']", "['layers']['mlp']['w_gate']"):
                return torch.index_select(w, 1, k)
            if key in ("['layers']['mlp']['b_up']", "['layers']['mlp']['w_down']"):
                return torch.index_select(w, 0, k)
        if heads is not None:
            k = heads[layer]
            if key in ("['layers']['attn']['wq']", "['layers']['attn']['wk']",
                       "['layers']['attn']['wv']"):
                return take_heads(w, 1, k)
            if key in ("['layers']['attn']['bq']", "['layers']['attn']['bk']",
                       "['layers']['attn']['bv']", "['layers']['attn']['wo']"):
                return take_heads(w, 0, k)
        return w

    out = _rebuild(out, shrink)
    if chan is not None:
        fk = chan.shape[-1]
        cfg.intermediate_size = int(fk)
        logger.info(f"redundancy_clean: FFN channels {model_config.ffn_size} -> {fk}")
    if heads is not None:
        hk = heads.shape[-1]
        cfg.head_dim_override = int(d)  # head_dim no longer hidden/NH
        cfg.n_heads = int(hk)
        if cfg.n_kv_heads is not None:
            cfg.n_kv_heads = int(hk)
        logger.info(f"redundancy_clean: heads {n_heads} -> {hk}")
    return out, cfg
