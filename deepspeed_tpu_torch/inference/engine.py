"""Inference engine v1 (the port's counterpart of ``deepspeed_tpu/
inference/engine.py``): a dense ``[L, B, S, KVH, D]`` KV cache per
``generate`` call, whole-prompt prefill, then one token per step for every
row of the batch.

JAX compiles the decode loop into one ``lax.scan``; here it is a Python
loop over :func:`~..models.transformer.forward_with_cache` whose sampled
tokens stay on the device until the loop ends.  Sampling draws from a
``torch.Generator`` seeded with ``seed`` after JAX's top-k and top-p
filtering (:func:`filter_logits`); JAX draws from its PRNG, so only greedy
streams (``temperature=0``) match JAX token for token.

``module_quantize`` quantizes and dequantizes every parameter leaf of two
or more dimensions in place through the int8 block codec
(``ops/quantization.py``, kernels Q and DQ on the card), leaf by leaf as
the JAX engine's stacked tree holds them.  Tensor parallelism is not
ported: ``tensor_parallel.tp_size > 1`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device
from ..models.convert import params_from_numpy
from ..models.transformer import (ParamTree, TransformerConfig, forward_with_cache,
                                  init_kv_cache)
from ..runtime.config_utils import ConfigModel
from ..runtime.precision import cast_tree, cast_tree_copy
from ..utils.logging import logger
from .v2.engine_v2 import DTYPES

ROADMAP_TP = "ROADMAP Queue 1 #8/#9 'ZeRO across ranks' and 'Communication'"


@dataclasses.dataclass
class InferenceConfig(ConfigModel):
    """The JAX engine's config, field for field."""

    dtype: str = "bf16"  # fp32 | bf16 | fp16
    tensor_parallel: Dict[str, Any] = dataclasses.field(default_factory=dict)
    max_out_tokens: int = 256
    max_batch_size: int = 8
    max_seq_len: int = 2048
    replace_with_kernel_inject: bool = True  # accepted for API parity
    enable_cuda_graph: bool = False  # accepted for API parity

    def validate(self) -> None:
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {sorted(DTYPES)}")
        if self.tp_size > 1:
            raise NotImplementedError(
                f"tensor_parallel.tp_size={self.tp_size}: tensor-parallel inference is not "
                f"ported yet ({ROADMAP_TP})")

    @property
    def tp_size(self) -> int:
        return int(self.tensor_parallel.get("tp_size", 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """``logits / temperature`` with the tokens outside top-k and outside
    the nucleus set to -inf, JAX's threshold rule: keep the logits at or
    above the k-th largest value, then at or above the smallest value of
    the shortest prefix of the sorted order whose exclusive cumulative
    probability stays below ``top_p`` (the most likely token always
    stays).  logits ``[B, V]`` fp32."""
    logits = logits / temperature
    neg_inf = torch.full_like(logits, float("-inf"))
    if top_k and top_k > 0:
        # dstpu-lint: allow[host-sync] top_k is a Python sampling setting, not a device
        # value
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p and 0.0 < top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        n_keep = (cum - probs < top_p).sum(dim=-1, keepdim=True)
        thresh = sorted_desc.gather(-1, n_keep - 1)
        logits = torch.where(logits < thresh, neg_inf, logits)
    return logits


class InferenceEngine:
    """Greedy or sampled generation over a ``models/*`` model carrying a
    :class:`TransformerConfig`.

    ``params``: a :class:`ParamTree` (used as it is where it already lies
    on ``device`` in the config's dtype, else copied there: the caller's
    tree never changes), the JAX parameter tree as numpy arrays, or
    None for random weights from a ``torch.Generator`` seeded with
    ``seed``.  ``device``: None means ``cuda``."""

    def __init__(self, model: Any, config: Optional[InferenceConfig] = None,
                 params: Any = None, seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config or InferenceConfig()
        self.config.validate()  # directly built configs skip from_dict
        if not hasattr(model, "config") or not isinstance(model.config, TransformerConfig):
            raise TypeError("InferenceEngine needs a model with a TransformerConfig "
                            "(models.llama.llama_model)")
        self.model = model
        self.cfg: TransformerConfig = model.config
        if self.cfg.post_norm:
            raise NotImplementedError(
                "InferenceEngine serves causal decoders with a KV cache; post_norm "
                "(BERT-style encoder) models have no generative path")
        dtype = self.config.torch_dtype
        given = params
        if params is None:  # the engine's own tree: cast in place
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = cast_tree(model.init_params(gen, self.device), dtype)
        elif isinstance(params, dict):
            params = params_from_numpy(params, self.cfg, self.device, dtype)
        elif not isinstance(params, ParamTree):
            raise TypeError(f"params must be a ParamTree or a numpy tree, not {type(params)}")
        self.params = cast_tree_copy(params, dtype, self.device)
        #: the caller's own tree, served as it is: ``module_quantize`` rewrites
        #: a copy of it, never the caller's leaves
        self._shares_callers_tree = self.params is given
        logger.info(f"InferenceEngine: dtype={self.config.dtype} device={self.device}")

    # ------------------------------------------------------------ public API
    @torch.no_grad()
    def generate(self, input_ids: Any, max_new_tokens: int = 32, temperature: float = 0.0,
                 *, seed: int = 0, top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
        """input_ids ``[B, T]`` prompt; returns ``[B, T + max_new_tokens]``
        on the engine's device.  ``temperature=0`` is greedy; ``top_k`` /
        ``top_p`` filter the sampled distribution.  The JAX engine clamps
        cache writes past ``max_seq_len`` silently; here a prompt plus
        ``max_new_tokens`` beyond ``config.max_seq_len`` raises."""
        ids = self._ids(input_ids)
        if ids.ndim != 2:
            raise ValueError(f"input_ids must be [B, T], got {tuple(ids.shape)}")
        B, T = ids.shape
        if T + max_new_tokens > self.config.max_seq_len:
            raise ValueError(f"prompt {T} + max_new_tokens {max_new_tokens} > max_seq_len "
                             f"{self.config.max_seq_len}")
        if max_new_tokens <= 0:
            return ids
        cache = init_kv_cache(self.cfg, B, T + max_new_tokens, self.config.torch_dtype,
                              self.device)
        logits, cache = forward_with_cache(self.cfg, self.params, ids, cache, 0)
        last = logits[:, -1]
        # dstpu-lint: allow[host-sync] seed is a Python sampling setting, not a device value
        gen = (torch.Generator(device=self.device).manual_seed(int(seed))
               if temperature > 0 else None)
        tokens: List[torch.Tensor] = []
        for t in range(max_new_tokens):
            tok = self._sample(last.float(), gen, temperature, top_k, top_p)
            tokens.append(tok)
            if t + 1 < max_new_tokens:  # the last token needs no forward
                logits, cache = forward_with_cache(self.cfg, self.params, tok[:, None],
                                                   cache, T + t)
                last = logits[:, -1]
        return torch.cat([ids, torch.stack(tokens, dim=1)], dim=1)

    def _ids(self, input_ids: Any) -> torch.Tensor:
        """Token ids (a tensor on any device, a numpy array or a list) as
        int64 on the engine's device."""
        if not isinstance(input_ids, torch.Tensor):
            # dstpu-lint: allow[host-sync] a host input (numpy array or list) becomes a
            # tensor; a tensor never takes this branch
            input_ids = torch.as_tensor(np.asarray(input_ids))
        return input_ids.to(self.device).long()

    @staticmethod
    def _sample(logits: torch.Tensor, gen: Optional[torch.Generator], temperature: float,
                top_k: int, top_p: float) -> torch.Tensor:
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p), dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.no_grad()
    def forward(self, input_ids: Any) -> Any:
        """Plain forward logits (the model's ``apply_fn``)."""
        if self.model.apply_fn is None:
            raise ValueError("model has no apply_fn")
        return self.model.apply_fn(self.params, {"input_ids": self._ids(input_ids)})

    __call__ = forward

    def _stacked_leaves(self) -> Iterator[Tuple[str, int, List[torch.nn.Parameter]]]:
        """(JAX path, ndim as JAX stacks it, the port's tensors in layer
        order) for every leaf of the JAX tree: a layer leaf is the ``[L, ...]``
        stack of the per-layer tensors."""
        for name, p in self.params.named_parameters():
            if not name.startswith("layers."):
                yield name, p.ndim, [p]
        layers = self.params.layers
        for name, p in layers[0].named_parameters():
            yield f"layers.{name}", p.ndim + 1, [lay.get_parameter(name) for lay in layers]

    @torch.no_grad()
    def module_quantize(self, bits: int = 8) -> "InferenceEngine":
        """Quantize-dequantize every floating leaf of two or more dimensions
        in place (in a copy first when the engine serves its caller's tree
        as it is) through the int8 block codec (``bits`` is accepted for API
        parity: the codec is int8, as in JAX).

        The rule applies to each leaf as the JAX engine stacks it: a
        ``[L, H]`` norm scale is quantized, and the 128-wide rows run
        across layer boundaries, so the layers' tensors are concatenated
        in layer order, coded as one flat vector (one launch of each kernel
        per stacked leaf) and split back."""
        from ..ops.quantization import dequantize_int8, quantize_int8

        if self._shares_callers_tree:
            self.params = self.params.map(lambda t: t.clone())
            self._shares_callers_tree = False
        for _, ndim, tensors in self._stacked_leaves():
            if ndim < 2 or not tensors[0].is_floating_point():
                continue
            flat = torch.cat([t.reshape(-1) for t in tensors])
            q, s, n = quantize_int8(flat)
            deq = dequantize_int8(q, s, n, flat.dtype)
            for t, part in zip(tensors, torch.split(deq, [t.numel() for t in tensors])):
                t.copy_(part.view_as(t))
        return self
