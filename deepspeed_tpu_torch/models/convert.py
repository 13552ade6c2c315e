"""The weight bridge between the JAX package and the port.

Training: ``deepspeed_tpu_torch.initialize(model_parameters=tree)`` adopts a
JAX-layout numpy tree (or a port ``ParamTree``) leaf for leaf through
:func:`adopt_params`, and ``params_to_numpy(engine.get_params())`` gives the
fp32 master back in the JAX layout, so tests compare master weights after N
steps of both engines.

The JAX parameter tree (``init_transformer_params`` layout: nested dicts,
layers stacked on axis 0 as ``[L, ...]``, matmul weights ``[in, out]``)
crosses as numpy arrays, or as CPU tensors in the checkpoint's own dtype
(``checkpoint/hf_import.load_hf_model``).  The port keeps the ``[in, out]`` layout
(``x @ W``), so no leaf is transposed; the only reshaping is splitting
the stacked layer axis into per-layer trees and back.  Weight-only
quantized ``{"wq", "scale"}`` sub-trees cross both ways like any other:
their codes keep their integer type and their scales stay fp32 whatever
the tree's dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device
from .transformer import ParamTree, TransformerConfig


def _to_tensor(a: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A leaf as a new tensor on ``device``, floating leaves in ``dtype``.
    A torch leaf (the HF importer's) is copied in its own type straight
    to ``dtype``, so a bf16 checkpoint is never widened on the host; a
    transposed view of a contiguous tensor (the importer's ``[in, out]``
    of an ``[out, in]`` weight) crosses as stored and is transposed on
    ``device``."""
    if isinstance(a, torch.Tensor):
        dt = dtype if a.is_floating_point() else a.dtype
        if a.dim() >= 2 and not a.is_contiguous() and a.mT.is_contiguous():
            return a.mT.to(device=device, dtype=dt, copy=True).mT.contiguous()
        return a.to(device=device, dtype=dt, copy=True,
                    memory_format=torch.contiguous_format)
    arr = np.asarray(a)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        # bfloat16 numpy arrays (ml_dtypes) are widened first: torch cannot
        # read them directly
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig,
                      device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> ParamTree:
    """JAX parameter tree (numpy leaves, or CPU tensors as the HF importer
    gives them) -> the port's ``ParamTree`` with floating leaves cast to
    ``dtype`` on ``device`` (None means ``cuda``, as everywhere in the
    port); the scales of a quantized sub-tree stay fp32.  Each layer's
    slice of a stacked leaf is cut on the host and moved alone, so the
    device never holds a stacked copy."""
    device = resolve_device(device)

    def walk(node, i=None):
        quantized = _is_quantized(node)
        return {k: walk(v, i) if isinstance(v, dict) else
                _to_tensor(v if i is None else v[i], device,
                           torch.float32 if quantized and k == "scale" else dtype)
                for k, v in node.items()}

    out = {k: walk(v) for k, v in tree.items() if k != "layers"}
    n = cfg.n_layers
    depth = {leaf.shape[0] for leaf in _leaves(tree["layers"])}
    if depth != {n}:
        raise ValueError(f"stacked layer axis {sorted(depth)} != n_layers {n}")
    out["layers"] = [walk(tree["layers"], i) for i in range(n)]
    return ParamTree(out)


def params_to_numpy(params: ParamTree) -> Dict[str, Any]:
    """The reverse: per-layer trees stacked back on axis 0, floating leaves
    as fp32 numpy, integer leaves (quantized codes) in their own type."""

    def walk(mod):
        out = {}
        for name, p in mod._parameters.items():
            t = p.detach()
            out[name] = (t.float() if t.is_floating_point() else t).cpu().numpy()
        for name, child in mod._modules.items():
            if isinstance(child, torch.nn.ModuleList):
                per = [walk(c) for c in child]
                out[name] = _stack(per)
            else:
                out[name] = walk(child)
        return out

    return walk(params)


def _is_quantized(node) -> bool:
    """A weight-only quantized ``{"wq": codes, "scale": scales}`` node."""
    return isinstance(node, dict) and set(node) == {"wq", "scale"}


def _leaves(node):
    for v in node.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _stack(trees):
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else np.stack([t[k] for t in trees]) for k, v in first.items()}


def adopt_params(given: Any, cfg: TransformerConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32) -> ParamTree:
    """Parameters handed to the training engine: a JAX-layout tree of numpy
    arrays (converted by :func:`params_from_numpy`) or a ``ParamTree``,
    copied leaf for leaf into ``dtype`` on ``device`` — the caller's
    tensors are never updated in place by the optimizer."""
    device = resolve_device(device)
    if isinstance(given, ParamTree):
        return given.map(lambda t: t.to(device=device, dtype=dtype, copy=True)
                         if t.is_floating_point() else t.to(device=device, copy=True))
    if isinstance(given, dict):
        return params_from_numpy(given, cfg, device, dtype)
    raise TypeError(f"model_parameters: a JAX-layout dict of arrays or a ParamTree, "
                    f"got {type(given)}")
