"""Runtime utilities (``deepspeed_tpu/runtime/utils.py``).

``see_memory_usage`` reads the accelerator (``get_accelerator()``: the
caching allocator on the card) through the memory ledger, ``clip_grad_norm_`` clips a list of gradients by their global norm,
``flatten_tree`` / ``unflatten_tree`` pack a tree of tensors into one 1-D
buffer and back, ``partition_uniform`` / ``partition_balanced`` split items
into parts, and ``set_random_seed`` seeds every host generator and
PyTorch's CPU and CUDA generators.
"""

from __future__ import annotations

import random
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..accelerator import get_accelerator
from ..utils.logging import logger
from .precision import clip_by_global_norm, global_grad_norm

__all__ = ["see_memory_usage", "clip_grad_norm_", "flatten_tree", "unflatten_tree",
           "partition_uniform", "partition_balanced", "set_random_seed"]


def see_memory_usage(message: str, force: bool = False) -> dict:
    """Publish the memory ledger's live gauges (``deepspeed_tpu_memory_
    bytes_in_use`` / ``_peak_bytes_in_use`` / ``_bytes_limit``) on every
    call, and with ``force`` log them in the JAX package's format.  On the
    card the numbers are the caching allocator's allocated bytes and the
    card's total; on the CPU the process's resident set and the host's
    memory.  Returns the stats read."""
    from ..telemetry.memory import get_memory_ledger

    stats = get_memory_ledger().publish_stats()
    if force:
        s = stats or get_accelerator().memory_stats()
        used = s.get("bytes_in_use", 0) / 2**30
        peak = s.get("peak_bytes_in_use", 0) / 2**30
        limit = s.get("bytes_limit", 0) / 2**30
        logger.info(f"{message} | device MA {used:.2f} GB  Max_MA {peak:.2f} GB  "
                    f"limit {limit:.2f} GB")
    return stats


def clip_grad_norm_(grads: Sequence[torch.Tensor], max_norm: float
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Global-norm clip over a list of gradients: ``(clipped, norm)``, the
    norm an fp32 0-d tensor on the gradients' device (no host sync)."""
    grads = list(grads)
    norm = global_grad_norm(grads)
    return clip_by_global_norm(grads, norm, max_norm), norm


def _flatten(node: Any, out: List[torch.Tensor]) -> Any:
    """Leaves of a nested dict / list / tuple tree in JAX's order (dict keys
    sorted), and the tree's structure with each leaf replaced by None."""
    if isinstance(node, dict):
        return {k: _flatten(node[k], out) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_flatten(v, out) for v in node)
    out.append(node)
    return None


def _unflatten(spec: Any, leaves) -> Any:
    if isinstance(spec, dict):
        return {k: _unflatten(v, leaves) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(_unflatten(v, leaves) for v in spec)
    return next(leaves)


def _leaves(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    if isinstance(tree, nn.Module):
        return [p.detach() for p in tree.parameters()], ("module", tree)
    leaves: List[torch.Tensor] = []
    spec = _flatten(tree, leaves)
    return leaves, ("tree", spec)


def flatten_tree(tree: Any) -> Tuple[torch.Tensor, Any, List[Tuple[int, ...]]]:
    """Flatten a tree of tensors (nested dicts, lists and tuples, dict keys
    in sorted order as JAX flattens them, or a ``ParamTree`` in its
    parameter order) into one 1-D buffer: ``(flat, treedef, shapes)``."""
    leaves, treedef = _leaves(tree)
    shapes = [tuple(x.shape) for x in leaves]
    flat = (torch.cat([x.reshape(-1) for x in leaves]) if leaves
            else torch.zeros((0,)))
    return flat, treedef, shapes


def unflatten_tree(flat: torch.Tensor, treedef: Any,
                   shapes: Sequence[Tuple[int, ...]]) -> Any:
    """Inverse of :func:`flatten_tree`: views of ``flat`` in the tree's
    structure (a ``ParamTree`` comes back as a new ``ParamTree``)."""
    out, off = [], 0
    for shp in shapes:
        n = int(np.prod(shp)) if shp else 1
        out.append(flat[off:off + n].reshape(shp))
        off += n
    if treedef[0] == "module":
        it = iter(out)
        return treedef[1].map(lambda _: next(it))
    return _unflatten(treedef[1], iter(out))


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Boundaries of a uniform split: ``num_parts + 1`` offsets, the first
    ``num_items % num_parts`` parts one item longer."""
    parts = [0] * (num_parts + 1)
    chunk, residual = divmod(num_items, num_parts)
    for p in range(num_parts):
        parts[p + 1] = parts[p] + chunk + (1 if p < residual else 0)
    return parts


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Greedy prefix-sum split of weighted items into ``num_parts``
    contiguous parts of about equal weight (pipeline layer placement)."""
    n = len(weights)
    if num_parts >= n:
        return list(range(n + 1)) + [n] * (num_parts - n)
    prefix = np.concatenate([[0.0], np.cumsum(np.asarray(weights, np.float64))])
    total = prefix[-1]
    bounds = [0]
    for p in range(1, num_parts):
        idx = int(np.searchsorted(prefix, total * p / num_parts))
        idx = max(bounds[-1] + 1, min(idx, n - (num_parts - p)))
        bounds.append(idx)
    bounds.append(n)
    return bounds


def set_random_seed(seed: int) -> torch.Generator:
    """Seed ``random``, numpy's global generator and PyTorch's CPU and CUDA
    generators (every card's, when there is one).  Returns a fresh CPU
    ``torch.Generator`` seeded with ``seed``, the port's counterpart of the
    JAX package's returned ``PRNGKey``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # seeds the CUDA generators too
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
    return torch.Generator().manual_seed(seed)
