"""Weight-only quantization for inference (the port's counterpart of
``deepspeed_tpu/inference/quantization.py``).

Post-training weight-only int8/int4: the big matmul weights are stored as
codes + fp32 group scales (``ops/wq_matmul.quantize_weight``) and
multiplied by the ``wq_matmul`` kernel, which reads the codes and
dequantizes on the chip — roughly half (int8) or a quarter (int4) of the
weight bytes at rest and per decode step.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from torch import nn

from ..models.transformer import ParamTree
from ..ops.wq_matmul import quantize_weight
from ..utils.logging import logger

#: weight leaves eligible for weight-only quantization: the seven big
#: matmuls of the transformer core plus the (untied) LM head.  Embeddings
#: stay full precision (gather, not matmul).  Matched against the JAX tree's
#: path spelling, which has no layer index (``layers/attn/wq``).
WQ_PATTERNS = (r"attn/w[qkvo]$", r"mlp/w_(gate|up|down)$", r"lm_head/w$")


def quantize_inference_params(params: ParamTree, bits: int = 8, group: int = 128,
                              min_size: int = 1 << 14) -> Tuple[ParamTree, int, int]:
    """A new tree with each eligible ``[K, N]`` weight replaced by a
    ``{"wq": codes, "scale": fp32 scales}`` sub-tree.

    Eligibility is the JAX rule on its stacked ``[L, K, N]`` leaves: the
    path matches ``WQ_PATTERNS``, the per-layer matrix is 2-D and holds at
    least ``min_size`` elements.  Here each layer's leaf is that matrix and
    is quantized alone, which is what JAX's vmap over the stacked axis does.
    Returns (quantized params, bytes before, bytes after).  Unquantized
    leaves are shared with ``params``, not copied."""
    before = after = 0

    def walk(mod: nn.Module, path: List[str]) -> Dict[str, Any]:
        nonlocal before, after
        out: Dict[str, Any] = {}
        for name, p in mod._parameters.items():
            t = p.detach()
            nbytes = t.numel() * t.element_size()
            before += nbytes
            key = "/".join(path + [name])
            if (any(re.search(pat, key) for pat in WQ_PATTERNS) and t.ndim == 2
                    and t.numel() >= min_size):
                codes, scale = quantize_weight(t, bits, group)
                out[name] = {"wq": codes, "scale": scale}
                after += codes.numel() * codes.element_size() + scale.numel() * 4
            else:
                out[name] = t
                after += nbytes
        for name, child in mod._modules.items():
            if isinstance(child, nn.ModuleList):  # layers: the JAX path has no index
                out[name] = [walk(c, path + [name]) for c in child]
            else:
                out[name] = walk(child, path + [name])
        return out

    tree = walk(params, [])
    logger.info(f"weight-only quantization: int{bits}, {before / 1e6:.1f}MB -> "
                f"{after / 1e6:.1f}MB")
    return ParamTree(tree), before, after
