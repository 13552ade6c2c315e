"""Speculative decoding: proposers and the greedy accept rule (the port's
counterpart of ``deepspeed_tpu/inference/v2/speculative.py``).

The engine (engine_v2.py) drives the loop: a *proposer* guesses up to
``k`` continuation tokens from host state, one batched **verify** program
(``model_runner.paged_verify``) scores all of them in a single model
invocation, and the longest prefix that matches the model's own greedy
choices is accepted, plus the model's own token at the first mismatch, so
every verify call emits at least one token.

The contract is lossless: greedy speculative decoding is bit-identical to
plain greedy decoding, because each accepted token is checked against the
model's own argmax given the same KV state.  Sampled requests are not
speculated: the engine runs them through the plain decode program.

Proposers are pluggable: anything with ``propose(tokens, k) -> list``.
Two built-ins: :class:`NgramProposer` (prompt lookup in the sequence's own
history, no weights) and :class:`DraftModelProposer` (a small draft model
run greedily through the port's transformer forward; on a CUDA device its
attention is the flash kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...accelerator import DeviceLike, resolve_device
from ...runtime.config_utils import ConfigModel

SPEC_MODES = ("off", "ngram", "draft")


@dataclasses.dataclass
class SpeculativeConfig(ConfigModel):
    """The ``speculative`` block of ``RaggedInferenceConfig``.

    ``k`` is the most draft tokens per verify call: the verify program has
    one width, ``k + 1`` tokens (the last accepted token and the drafts),
    so one program serves every acceptance outcome."""

    mode: str = "off"
    #: most draft tokens proposed per step (verify width = k + 1)
    k: int = 4
    #: n-gram proposer: shortest and longest trailing n-gram searched in
    #: the sequence's own history (the longest match wins)
    ngram_min: int = 1
    ngram_max: int = 3
    #: draft-model proposer: a ``models/llama`` size (e.g. "tiny").  A size
    #: alone gets seed-initialized weights (lossless, low acceptance); pass
    #: ``proposer=DraftModelProposer(model, params)`` for real weights
    draft_model: str = ""

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def validate(self) -> None:
        if self.mode not in SPEC_MODES:
            raise ValueError(f"speculative.mode {self.mode!r} not in {SPEC_MODES}")
        if self.k < 1:
            raise ValueError("speculative.k must be >= 1")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError("need 1 <= speculative.ngram_min <= ngram_max")
        if self.mode == "draft" and not self.draft_model:
            raise ValueError("speculative.mode='draft' needs speculative.draft_model")


class NgramProposer:
    """Prompt lookup: propose the continuation of an earlier occurrence of
    the sequence's trailing n-gram.

    The longest n-gram wins (``ngram_max`` down to ``ngram_min``); among
    matches of one length, the most recent whose continuation fills ``k``
    (in a generation loop the nearest occurrence sits one period back with
    its continuation cut by the end of the history, and one more period
    back the same cycle supplies all ``k``), else the longest cut
    continuation, most recent first."""

    def __init__(self, ngram_min: int = 1, ngram_max: int = 3):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        n_tok = len(tokens)
        if k < 1 or n_tok < self.ngram_min + 1:
            return []
        arr = np.asarray(tokens, dtype=np.int64)
        for n in range(min(self.ngram_max, n_tok - 1), self.ngram_min - 1, -1):
            tail = arr[n_tok - n:]
            # candidate starts 0 .. n_tok - n - 1 (the tail itself excluded);
            # a match at i proposes tokens[i + n : i + n + k]
            wins = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
            hits = np.nonzero((wins == tail).all(axis=1))[0]
            best: List[int] = []
            for i in hits[::-1]:
                cont = arr[i + n:i + n + k]
                if len(cont) == k:
                    return [int(t) for t in cont]
                if len(cont) > len(best):
                    best = [int(t) for t in cont]
            if best:
                return best
        return []


class DraftModelProposer:
    """Greedy proposals from a small draft model (a ``models/*`` spec).

    Each proposed token is one dense forward of the draft over the whole
    history, padded to a power-of-two bucket (``transformer_forward``: the
    flash kernel on a CUDA device).  There is no draft KV cache, so the
    draft's state never has to follow the target's accept and rollback;
    the recompute is what only a tiny draft can afford.

    ``params``: a ``ParamTree``, the JAX parameter tree as numpy arrays,
    or None for weights drawn from a ``torch.Generator`` seeded with
    ``seed``.  ``device``: None means ``cuda``."""

    def __init__(self, model: Any, params: Any = None, seed: int = 0, min_bucket: int = 32,
                 device: DeviceLike = None):
        from ...models.convert import params_from_numpy
        from ...models.transformer import ParamTree

        self.device = resolve_device(device)
        self.cfg = model.config
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = model.init_params(gen, self.device)
        elif isinstance(params, dict):
            params = params_from_numpy(params, self.cfg, self.device)
        elif not isinstance(params, ParamTree):
            raise TypeError(f"params must be a ParamTree or a numpy tree, not {type(params)}")
        self.params = params.to(self.device)
        self.min_bucket = min_bucket
        #: draft forwards run (one per proposed token)
        self.forwards = 0

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.cfg.max_seq_len)

    @torch.no_grad()
    def _next(self, hist: List[int]) -> int:
        from ...models.transformer import logits_fn, transformer_forward

        ids = torch.zeros((1, self._bucket(len(hist))), dtype=torch.long)
        # a token past the draft's vocabulary embeds as its last row, as the
        # JAX draft's gather clamps it
        ids[0, :len(hist)] = torch.tensor(hist, dtype=torch.long).clamp(
            max=self.cfg.vocab_size - 1)
        h, _ = transformer_forward(self.cfg, self.params, ids.to(self.device))
        self.forwards += 1
        logits = logits_fn(self.cfg, self.params, h[:, len(hist) - 1])
        return int(torch.argmax(logits.float(), dim=-1)[0])

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        hist = [int(t) for t in tokens]
        out: List[int] = []
        for _ in range(k):
            if len(hist) >= self.cfg.max_seq_len:
                break
            tok = self._next(hist)
            out.append(tok)
            hist.append(tok)
        return out


def build_proposer(spec: SpeculativeConfig, device: DeviceLike = None) -> Optional[Any]:
    """The proposer of a config block (None when mode is off); the draft
    model lives on ``device``."""
    if not spec.enabled:
        return None
    if spec.mode == "ngram":
        return NgramProposer(spec.ngram_min, spec.ngram_max)
    from ...models.llama import llama_model

    return DraftModelProposer(llama_model(spec.draft_model), device=device)


def longest_accepted(draft: Sequence[int], verified: Sequence[int]) -> Tuple[List[int], int]:
    """Greedy accept rule: ``verified[w]`` is the model's argmax after the
    last accepted token and ``draft[:w]``.  The longest prefix of ``draft``
    matching ``verified`` position by position is accepted, and
    ``verified[m]``, the model's own choice at the first mismatch (or past
    a fully accepted draft), is the bonus token.  Returns
    ``(accepted_tokens, bonus_token)``."""
    m = 0
    while m < len(draft) and int(draft[m]) == int(verified[m]):
        m += 1
    return [int(t) for t in draft[:m]], int(verified[m])


__all__ = ["SpeculativeConfig", "NgramProposer", "DraftModelProposer", "build_proposer",
           "longest_accepted", "SPEC_MODES"]
