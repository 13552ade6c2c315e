"""Continuous-batching inference engine (the port's counterpart of
``deepspeed_tpu/inference/v2/engine_v2.py``).

Requests enter a queue, are admitted when KV pages and a decode slot are
free, prefill and decode interleave, and finished sequences release
their pages at once so new requests start while others are
mid-generation.  The device work is the programs of ``model_runner.py``
(whole-prompt and chunked prefill, run eagerly; the decode step, the
multi-step decode and the speculative verify, captured as CUDA graphs by
``captured.py``); everything here is host bookkeeping between them.

Decode samples on the device and returns only token ids: ``[max_seqs]``
per step, ``[max_seqs, K]`` per multi-step dispatch, the per-position
argmax ``[max_seqs, k + 1]`` per verify.  Prefill (once per admitted
request) returns the last token's logits and samples on the host with
numpy, exactly as the JAX engine does.

This slice ports the single-replica scheduler: admission by priority
class, KV-pressure preemption, deadlines, whole-prompt and chunked
prefill, the decode loop one token or ``decode_horizon`` tokens per host
round trip, speculative decoding (``speculative``: n-gram or draft-model
proposals, greedy requests only), and weight-only int8/int4 weights
(``quant_bits``: every projection and the LM head through the
``wq_matmul`` kernel; MoE expert leaves stay full precision, as in JAX).
Mixtral MoE models serve through the same programs.  The prefix cache,
the KV tiers and the telemetry layer are not ported yet; setting one of
their knobs raises ``NotImplementedError`` naming the ROADMAP item that
brings it.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.convert import params_from_numpy
from ...models.transformer import ParamTree, TransformerConfig
from ...runtime.config_utils import ConfigModel
from ...runtime.precision import cast_tree
from ..quantization import quantize_inference_params
from ...utils.logging import logger
from .captured import DecodePrograms
from .model_runner import paged_prefill, paged_prefill_chunk
from .ragged import (PRIORITY_NORMAL, BlockAllocator, KVBlockConfig,
                     PagedKVCache, RejectedError, SequenceState)
from .speculative import SpeculativeConfig, build_proposer, longest_accepted

ROADMAP_PREFIX = "ROADMAP Queue 1 'Serving: prefix cache, KV export and tiers'"
ROADMAP_TELEMETRY = "ROADMAP Queue 1 'Serving telemetry'"

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def retry_after_hint(queued: int) -> float:
    """Back-off hint for a shed request (the port's copy of
    ``serving/admission.retry_after_hint`` without the page term): ~50 ms
    per queued request, clamped to [0.1 s, 30 s]."""
    return round(min(30.0, max(0.1, 0.05 * queued)), 3)


def _horizon_pages_needed(length: int, budget: int, page_size: int) -> int:
    """Pages a decode row needs to emit ``budget`` more tokens: its t-th
    token this dispatch (1-indexed) writes KV at position
    ``length - 2 + t``, so the page table must cover position
    ``length - 2 + budget`` (the multi-step headroom reservation)."""
    return (length - 2 + budget) // page_size + 1


def _shrink_horizon(k: int, cap: int) -> int:
    """Walk the halving chain ``K, ceil(K/2), ...`` down to the smallest
    value still covering ``cap`` (floor 1).  Dispatch horizons only take
    values on the chain, so there is one multi-step program per value."""
    while k > 1 and (k + 1) // 2 >= cap:
        k = (k + 1) // 2
    return max(1, k)


def _horizon_chain(k: int) -> List[int]:
    """Every value of the halving chain from ``k`` down to 1."""
    chain = [k]
    while chain[-1] > 1:
        chain.append((chain[-1] + 1) // 2)
    return chain


def _deadline_clamp(budget: int, deadline_left: float,
                    tpot_est: Optional[float]) -> int:
    """Clamp a row's horizon when its deadline lands mid-horizon: at
    ~``tpot_est`` seconds per step, only the tokens that fit the time left
    (floor 1).  Without an estimate the budget passes through: the
    boundary sweep still expires the row, at most one horizon late."""
    if tpot_est is None or tpot_est <= 0.0:
        return budget
    return min(budget, max(1, int(deadline_left / tpot_est)))


@dataclasses.dataclass
class RaggedInferenceConfig(ConfigModel):
    """Every field of the JAX engine's config, by the same name.  The
    knobs of features this slice does not port must stay at their
    defaults (``validate`` raises otherwise)."""

    dtype: str = "bf16"
    page_size: int = 16
    num_pages: int = 256
    max_seqs: int = 8
    max_pages_per_seq: int = 16
    min_prefill_bucket: int = 16
    #: chunked prefill: prompts run in chunks of this many tokens (rounded
    #: up to page_size) so decode steps interleave; 0 = whole-prompt
    prefill_chunk: int = 0
    #: weight-only quantized weights: 8 or 4 bits (0 = off), per group of
    #: ``quant_group`` rows; matrices under ``quant_min_size`` elements stay
    quant_bits: int = 0
    quant_group: int = 128
    quant_min_size: int = 1 << 14
    #: int8 KV pages + per-(page, slot, head) fp32 scales
    kv_quant: bool = False
    enable_prefix_cache: bool = False
    prefix_cache_pages: int = 0
    kv_tier: Any = None
    recompile_sentinel: bool = True
    sentinel_steady_after: int = 3
    timeline_every_n_steps: int = 0
    timeline_artifact_dir: str = ""
    memory_ledger: bool = True
    speculative: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)
    decode_horizon: int = 1
    #: bounded request queue: once this many requests wait, ``put()``
    #: raises RejectedError; <= 0 = unbounded
    max_queue_depth: int = 0
    slo_ttft_s: float = 0.0
    slo_tpot_s: float = 0.0

    def validate(self) -> None:
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {sorted(DTYPES)}")
        if isinstance(self.speculative, dict):
            self.speculative = SpeculativeConfig.from_dict(self.speculative)
        not_ported = [
            ("enable_prefix_cache", self.enable_prefix_cache, ROADMAP_PREFIX),
            ("kv_tier", self.kv_tier is not None, ROADMAP_PREFIX),
            ("timeline_every_n_steps", self.timeline_every_n_steps != 0,
             ROADMAP_TELEMETRY),
            ("timeline_artifact_dir", self.timeline_artifact_dir != "",
             ROADMAP_TELEMETRY),
            ("slo_ttft_s", self.slo_ttft_s > 0, ROADMAP_TELEMETRY),
            ("slo_tpot_s", self.slo_tpot_s > 0, ROADMAP_TELEMETRY),
        ]
        for name, is_set, item in not_ported:
            if is_set:
                raise NotImplementedError(
                    f"RaggedInferenceConfig.{name}: not ported yet ({item})")
        if self.quant_bits not in (0, 4, 8):
            raise ValueError(f"quant_bits must be 0, 4 or 8, got {self.quant_bits}")
        if self.decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got {self.decode_horizon}")
        self.speculative.validate()

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def block(self) -> KVBlockConfig:
        return KVBlockConfig(page_size=self.page_size, num_pages=self.num_pages,
                             max_seqs=self.max_seqs,
                             max_pages_per_seq=self.max_pages_per_seq)


@dataclasses.dataclass
class RaggedRequest:
    prompt_ids: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    eos_id: Optional[int] = None
    uid: Optional[int] = None
    #: priority class (``ragged.PRIORITY_*``, smaller = more urgent)
    priority: int = PRIORITY_NORMAL
    #: seconds from enqueue after which the request expires (None = never)
    deadline_s: Optional[float] = None
    trace_id: Optional[str] = None


class InferenceEngineV2:
    """Paged continuous batching over a ``models/*`` transformer.

    ``params``: a :class:`ParamTree` (moved to ``device`` and cast to the
    serving dtype in place), the JAX parameter tree as numpy arrays, or
    None for random weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``.  ``device``: None means ``cuda``; without a
    CUDA device only an explicit ``"cpu"`` runs.

    With ``config.quant_bits`` the engine casts to the serving dtype
    first, then quantizes into a new tree (the given tree keeps its
    weights), and sets ``wq_bits``/``wq_group`` on its own model-config
    copy; ``param_bytes`` is then the quantized tree's bytes.

    ``proposer``: anything with ``propose(tokens, k) -> list`` (see
    ``speculative.py``); given, it turns speculative decoding on whatever
    ``speculative.mode`` says, with ``speculative.k`` drafts a step.  On a
    CUDA device the decode, multi-step and verify programs are captured
    as CUDA graphs here, at construction (``captured.py``)."""

    @classmethod
    def from_pretrained(cls, model_dir: str, config: Optional[RaggedInferenceConfig] = None,
                        **kw: Any) -> "InferenceEngineV2":
        """Serve a Hugging Face checkpoint directory: its ``config.json``
        picks the family, its weights are read in the serving dtype (never
        widened on the host) and moved to the device layer by layer.
        ``kw`` goes to the constructor (``device``, ``seed``, ...)."""
        from ...checkpoint.hf_import import load_hf_model
        from ...models.families import causal_lm_spec

        cfg = config or RaggedInferenceConfig()
        mcfg, params = load_hf_model(model_dir, dtype=cfg.torch_dtype)
        return cls(causal_lm_spec(mcfg), config=cfg, params=params, **kw)

    def __init__(self, model: Any, config: Optional[RaggedInferenceConfig] = None,
                 params: Any = None, seed: int = 0, device: Any = None,
                 proposer: Any = None):
        self.device = resolve_device(device)
        self.config = config or RaggedInferenceConfig()
        self.config.validate()  # directly built configs skip from_dict
        if not hasattr(model, "config") or not isinstance(model.config, TransformerConfig):
            raise TypeError("InferenceEngineV2 needs a models/* model carrying "
                            "a TransformerConfig")
        # own COPY of the model config: the quantization flags must not leak
        # into other engines sharing the model object
        self.cfg: TransformerConfig = dataclasses.replace(model.config)
        if self.cfg.post_norm:
            raise NotImplementedError(
                "InferenceEngineV2 serves causal decoders; post_norm "
                "(BERT-style encoder) models have no generative path")
        block = self.config.block
        if block.num_pages < block.max_pages_per_seq:
            raise ValueError(
                f"num_pages ({block.num_pages}) < max_pages_per_seq "
                f"({block.max_pages_per_seq}): one sequence could never run to "
                "completion even with the whole pool")
        dtype = self.config.torch_dtype
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = model.init_params(gen, self.device)
        elif isinstance(params, dict):
            params = params_from_numpy(params, self.cfg, self.device, dtype)
        elif not isinstance(params, ParamTree):
            raise TypeError(f"params must be a ParamTree or a numpy tree, not {type(params)}")
        # cast first: cast_tree casts every floating leaf, so it must never
        # run after quantization (the scales stay fp32)
        self.params = cast_tree(params.to(self.device), dtype)
        self.param_bytes = sum(p.numel() * p.element_size()
                               for p in self.params.parameters())
        if self.config.quant_bits:
            self.cfg.wq_bits = int(self.config.quant_bits)
            self.cfg.wq_group = int(self.config.quant_group)
            self.params, _, self.param_bytes = quantize_inference_params(
                self.params, self.cfg.wq_bits, self.cfg.wq_group,
                min_size=self.config.quant_min_size)
        self._pools = PagedKVCache.init(
            self.cfg.n_layers, self.cfg.kv_heads, self.cfg.head_dim, block,
            dtype, kv_quant=self.config.kv_quant, device=self.device)
        self.block = block
        self.max_seq_len = min(block.max_seq_len, self.cfg.max_seq_len)
        self.allocator = BlockAllocator(block.num_pages)
        self._uid = itertools.count()
        self._admit_counter = itertools.count()
        self._enqueue_counter = itertools.count()
        self._rng = np.random.RandomState(seed)
        self._seed = int(seed)
        self._queue: List[SequenceState] = []
        self._slots: List[Optional[SequenceState]] = [None] * block.max_seqs
        # host mirror of the device page tables, trash-filled
        self._page_table = np.full((block.max_seqs, block.max_pages_per_seq),
                                   block.trash_page, dtype=np.int32)
        ps = block.page_size
        self._chunk = (-(-self.config.prefill_chunk // ps) * ps
                       if self.config.prefill_chunk > 0 else 0)
        #: per-engine counters: program calls, tokens and the wall seconds
        #: of each phase (each phase ends in a host read of its result, so
        #: on CUDA the seconds include the device work);
        #: ``decode_device_steps``: decode bodies run (a K-step dispatch
        #: runs K; a verify runs none)
        self._stats = {"prefill_calls": 0, "prefill_chunk_calls": 0,
                       "prefill_admitted_tokens": 0, "prefill_computed_tokens": 0,
                       "prefill_seconds": 0.0, "decode_seconds": 0.0,
                       "decode_device_steps": 0, "preemptions": 0}
        #: decode-phase counters by the JAX engine's names (decode_stats)
        self._dstats = {"decode_model_invocations": 0, "decode_tokens": 0,
                        "decode_host_syncs": 0, "decode_horizon_shrinks": 0,
                        "spec_proposed_tokens": 0, "spec_accepted_tokens": 0,
                        "spec_verify_calls": 0, "spec_rollback_pages": 0,
                        "spec_fallback_requests": 0}
        # speculative decoding: an explicit proposer wins; otherwise the
        # config block builds one (None when off)
        self.spec = self.config.speculative
        if proposer is not None:
            if self.spec.k < 1:
                raise ValueError("speculative.k must be >= 1")
            self._proposer = proposer
        else:
            self._proposer = build_proposer(self.spec, self.device)
        self._spec_fallback_uids: set = set()
        self._spec_fallback_warned = False
        # multi-step decode: one decode path at a time, so a proposer owns
        # the loop and the horizon stands down, loudly
        self._horizon = int(self.config.decode_horizon)
        if self._proposer is not None and self._horizon > 1:
            logger.warning(
                f"multi-step decode: speculative decoding is enabled and owns the "
                f"decode loop; decode_horizon {self._horizon} stands down to 1 "
                "(disable speculative.mode to fuse decode steps)")
            self._horizon = 1
        #: EMA of the wall time per fused step, the deadline clamp's
        #: estimate; only warm dispatches feed it (a horizon's first
        #: dispatch pays one-time costs: the graph's upload on CUDA)
        self._tpot_ema: Optional[float] = None
        self._warm_horizons: set = set()
        self._programs = DecodePrograms(
            self.cfg, self.params, self._pools, block.max_seqs, block.max_pages_per_seq,
            self._seed, _horizon_chain(self._horizon) if self._horizon > 1 else (),
            verify_width=self.spec.k + 1 if self._proposer is not None else 0)

    # -- request API ---------------------------------------------------------
    def put(self, request: RaggedRequest) -> int:
        """Queue a request; returns its uid.  A full bounded queue
        (``max_queue_depth``) raises :class:`RejectedError`."""
        uid = request.uid if request.uid is not None else next(self._uid)
        n = len(request.prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if n >= self.max_seq_len:
            raise ValueError(f"prompt length {n} >= max_seq_len {self.max_seq_len}")
        if (self.config.max_queue_depth > 0
                and len(self._queue) >= self.config.max_queue_depth):
            raise RejectedError("engine_queue_full",
                                retry_after_s=retry_after_hint(len(self._queue)),
                                priority=request.priority)
        now = time.perf_counter()
        self._queue.append(SequenceState(
            uid=uid, tokens=list(request.prompt_ids), prompt_len=n,
            max_new_tokens=request.max_new_tokens,
            temperature=request.temperature, eos_id=request.eos_id,
            priority=int(request.priority),
            deadline=(now + max(0.0, float(request.deadline_s))
                      if request.deadline_s is not None else 0.0),
            enqueue_order=next(self._enqueue_counter),
            queued_at=now, trace_id=request.trace_id))
        return uid

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def stats(self) -> Dict[str, float]:
        """Cumulative program-call, token and phase-time counters (the
        decode-phase ones of :meth:`decode_stats` included)."""
        return {**self._stats, **self._dstats}

    def decode_stats(self) -> Dict[str, float]:
        """Decode-phase counters by the JAX engine's names (cumulative; the
        spec entries stay 0 with speculation off): model invocations,
        host syncs, tokens, horizon shrinks, and the speculative
        propose/accept/rollback tallies, with the derived
        ``decode_tokens_per_invocation``, ``decode_tokens_per_host_sync``
        and ``spec_acceptance_rate``."""
        s: Dict[str, float] = dict(self._dstats)
        inv, syncs = s["decode_model_invocations"], s["decode_host_syncs"]
        s["decode_tokens_per_invocation"] = s["decode_tokens"] / inv if inv else 0.0
        s["decode_tokens_per_host_sync"] = s["decode_tokens"] / syncs if syncs else 0.0
        prop = s["spec_proposed_tokens"]
        s["spec_acceptance_rate"] = s["spec_accepted_tokens"] / prop if prop else 0.0
        return s

    def assert_no_leaks(self) -> None:
        """Exact allocator audit against the live sequences: every page's
        refcount equals its live references (after rollback, preemption or
        retirement)."""
        self.allocator.assert_no_leaks([s.pages for s in self._slots if s is not None])

    def abort_all(self, reason: str = "abort") -> List[int]:
        """Free every queued and admitted request without running it;
        returns their uids."""
        uids = [s.uid for s in self._queue]
        self._queue.clear()
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            self.allocator.free(s.pages)
            self._page_table[i, :] = self.block.trash_page
            self._slots[i] = None
            s.slot, s.pages = -1, []
            uids.append(s.uid)
        if uids:
            logger.info(f"serving: aborted {len(uids)} request(s) ({reason})")
        return uids

    def close(self) -> None:
        """Abort what is still queued or running, loudly."""
        dropped = self.abort_all(reason="close")
        if dropped:
            logger.warning(
                f"engine_v2.close: aborted {len(dropped)} unfinished "
                f"request(s) (uids {dropped[:8]}{'…' if len(dropped) > 8 else ''})")

    # -- scheduling ----------------------------------------------------------
    def _bucket(self, n: int) -> int:
        """Power-of-two prefill bucket from a page-size multiple, capped at
        the page-rounded model window."""
        ps = self.block.page_size
        b = max(self.config.min_prefill_bucket, ps)
        b = -(-b // ps) * ps
        while b < n:
            b *= 2
        cap = -(-self.max_seq_len // ps) * ps
        return min(b, cap)

    def _preempt(self, seq: SequenceState) -> None:
        """Evict a running sequence to the queue; it re-prefills its prefix
        when pages free up."""
        self.allocator.free(seq.pages)
        self._page_table[seq.slot, :] = self.block.trash_page
        self._slots[seq.slot] = None
        seq.slot, seq.pages, seq.prefilled = -1, [], 0
        seq.queued_at = time.perf_counter()
        self._queue.insert(0, seq)
        self._stats["preemptions"] += 1
        a = self.allocator
        logger.info(
            f"serving: preempted uid={seq.uid} (prefix {seq.length} tokens) "
            f"under KV-pool pressure: {a.used_pages} pages used, "
            f"{a.free_pages} free of {self.block.num_pages}")

    def _admit(self) -> List[SequenceState]:
        admitted = []
        ps = self.block.page_size
        for i, slot in enumerate(self._slots):
            if not self._queue:
                break
            if slot is not None:
                continue
            # highest priority class first, FCFS within a class
            seq = min(self._queue, key=lambda s: (s.priority, s.enqueue_order))
            need_new = -(-seq.length // ps)
            while need_new > self.allocator.free_pages:
                # a high class preempts strictly-lower-class running
                # sequences (lowest class, then youngest)
                victims = [s for s in self._slots
                           if s is not None and s.priority > seq.priority]
                if not victims:
                    break
                # futility guard: evict nobody if even every victim's
                # pages could not cover the head
                if need_new > (self.allocator.free_pages
                               + sum(len(v.pages) for v in victims)):
                    break
                self._preempt(max(victims, key=lambda s: (s.priority, s.admit_order)))
            if need_new > self.allocator.free_pages:
                break  # head-of-line blocking
            self._queue.remove(seq)
            seq.pages = self.allocator.alloc(need_new)
            seq.prefilled = 0
            self._stats["prefill_admitted_tokens"] += seq.length
            self._stats["prefill_computed_tokens"] += seq.length
            seq.slot = i
            seq.admit_order = next(self._admit_counter)
            self._page_table[i, :] = self.block.trash_page
            self._page_table[i, :len(seq.pages)] = seq.pages
            admitted.append(seq)
            self._slots[i] = seq
        return admitted

    def _emit_sampled(self, seq: SequenceState, logits: torch.Tensor,
                      out: Dict[int, Dict[str, Any]]) -> None:
        """Sample off prefix-end logits, append, record, maybe retire."""
        tok = self._sample(seq, logits.float().cpu().numpy())
        seq.tokens.append(tok)
        out[seq.uid] = {"tokens": [tok], "done": False}
        self._maybe_finish(seq, tok)
        if seq.done:
            out[seq.uid]["done"] = True
            out[seq.uid]["finish_reason"] = seq.finish_reason

    @staticmethod
    def _ready_to_decode(seq: SequenceState) -> bool:
        """KV written for tokens[0:length-1] and a token sampled off the
        prefix end: mid-chunked-prefill sequences do not decode."""
        return seq.generated > 0 and seq.prefilled >= seq.length - 1

    def _sample(self, seq: SequenceState, logits: np.ndarray) -> int:
        if seq.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / seq.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _retire(self, seq: SequenceState) -> None:
        self.allocator.free(seq.pages)
        self._page_table[seq.slot, :] = self.block.trash_page
        self._slots[seq.slot] = None
        seq.slot, seq.pages, seq.done = -1, [], True

    def _expire(self, seq: SequenceState, out: Dict[int, Dict[str, Any]]) -> None:
        """Retire one past-deadline sequence (queued or admitted) with
        ``finish_reason="deadline"``."""
        seq.finish_reason = "deadline"
        if seq.slot >= 0:
            self._retire(seq)
        else:
            self.allocator.free(seq.pages)
            seq.pages, seq.done = [], True
        out[seq.uid] = {"tokens": [], "done": True, "finish_reason": "deadline"}

    def _expire_deadlines(self, out: Dict[int, Dict[str, Any]]) -> None:
        """Step-boundary deadline sweep over the queue and the slots."""
        now = time.perf_counter()
        for seq in [s for s in self._queue if s.deadline and now >= s.deadline]:
            self._queue.remove(seq)
            self._expire(seq, out)
        for seq in list(self._slots):
            if seq is not None and seq.deadline and now >= seq.deadline:
                self._expire(seq, out)

    def _finish_reason_for(self, seq: SequenceState, token: int) -> str:
        """The finish predicate ("" = keep running)."""
        if seq.generated >= seq.max_new_tokens:
            return "length"
        if seq.eos_id is not None and token == seq.eos_id:
            return "eos"
        if seq.length >= self.max_seq_len:
            return "max_seq_len"
        return ""

    def _maybe_finish(self, seq: SequenceState, token: int) -> None:
        reason = self._finish_reason_for(seq, token)
        if reason:
            seq.finish_reason = reason
            self._retire(seq)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_prefill_chunk(self, seq: SequenceState, start: int, c_n: int,
                           C: int) -> torch.Tensor:
        """One start-offset prefill call covering tokens [start, start+c_n)
        in a C-token program (C a page multiple).  Returns the logits of
        token start+c_n-1."""
        ps = self.block.page_size
        ids = np.zeros((C,), np.int32)
        ids[:c_n] = seq.tokens[start:start + c_n]
        rows = np.full((C // ps,), self.block.trash_page, np.int32)
        npg = -(-c_n // ps)
        rows[:npg] = seq.pages[start // ps:start // ps + npg]
        # the window THROUGH this chunk, bucketed to power-of-two pages:
        # early chunks do not attend the whole max window, and the flash
        # kernel finds the chunk's own keys in the table
        used = -(-(start + c_n) // ps)
        b = 1
        while b < max(used, 1):
            b *= 2
        prev = self._page_table[seq.slot][:min(b, self.block.max_pages_per_seq)]
        logits, self._pools = paged_prefill_chunk(
            self.cfg, self.params, self._pools, self._tensor(ids).long(),
            self._tensor(rows), self._tensor(np.ascontiguousarray(prev)), start, c_n)
        self._stats["prefill_chunk_calls"] += 1
        seq.prefilled = start + c_n
        return logits

    def _prefill_whole(self, seq: SequenceState, out: Dict[int, Dict[str, Any]]) -> None:
        """Whole-prompt prefill of an admitted sequence (a preempted one
        re-prefills prompt + the tokens it had generated)."""
        ps = self.block.page_size
        n = seq.length
        bucket = self._bucket(n)
        ids = np.zeros((bucket,), np.int32)
        ids[:n] = seq.tokens
        rows = np.full((bucket // ps,), self.block.trash_page, np.int32)
        rows[:len(seq.pages)] = seq.pages
        logits, self._pools = paged_prefill(
            self.cfg, self.params, self._pools, self._tensor(ids).long(),
            self._tensor(rows), n)
        self._stats["prefill_calls"] += 1
        seq.prefilled = n
        self._emit_sampled(seq, logits, out)

    # -- the engine step -----------------------------------------------------
    def step(self) -> Dict[int, Dict[str, Any]]:
        """Admit + prefill new sequences, decode one token for running ones.

        Returns {uid: {"tokens": [newly generated], "done": bool}};
        finished records also carry ``"finish_reason"``
        ("length"/"eos"/"max_seq_len"/"deadline").  Past-deadline requests
        expire first, at the step boundary, before admission."""
        out: Dict[int, Dict[str, Any]] = {}
        ps = self.block.page_size
        self._expire_deadlines(out)
        admitted = self._admit()
        t0 = time.perf_counter()
        if self._chunk:
            # one chunk per pending-prefill sequence per step; decode for
            # ready sequences runs below in the same step
            pending = [s for s in self._slots
                       if s is not None and not self._ready_to_decode(s)]
            for seq in pending:
                start = seq.prefilled  # page-aligned: chunk % ps == 0
                c_n = min(self._chunk, seq.length - start)
                logits = self._run_prefill_chunk(seq, start, c_n, self._chunk)
                if seq.prefilled >= seq.length:
                    self._emit_sampled(seq, logits, out)
        else:
            for seq in admitted:
                self._prefill_whole(seq, out)
        self._stats["prefill_seconds"] += time.perf_counter() - t0

        active = [s for s in self._slots if s is not None and self._ready_to_decode(s)]
        if not active:
            return out

        # grow page tables where the pending token crosses a page boundary;
        # under pool pressure preempt (lowest class, then youngest) — never
        # crash mid-step
        for seq in list(active):
            if seq.slot < 0:
                continue  # already preempted this step
            pos = seq.length - 1  # position the pending token will occupy
            if pos // ps == len(seq.pages):
                while self.allocator.free_pages < 1:
                    victims = [s for s in self._slots if s is not None and s is not seq]
                    victim = (max(victims, key=lambda s: (s.priority, s.admit_order))
                              if victims else seq)
                    if victim is not seq and victim.priority < seq.priority:
                        victim = seq
                    self._preempt(victim)
                    if victim is seq:
                        break
                if seq.slot < 0:
                    continue
                page = self.allocator.alloc(1)[0]
                seq.pages.append(page)
                self._page_table[seq.slot, len(seq.pages) - 1] = page
        active = [s for s in self._slots if s is not None and self._ready_to_decode(s)]
        if not active:
            return out

        # speculative split: greedy sequences go through the verify
        # program; sampled ones fall back, loudly, to plain decode (the
        # accept rule is exact only for argmax)
        if self._proposer is not None:
            spec_seqs = [s for s in active if s.temperature <= 0.0]
            decode_seqs = [s for s in active if s.temperature > 0.0]
            for seq in decode_seqs:
                if seq.uid not in self._spec_fallback_uids:
                    self._spec_fallback_uids.add(seq.uid)
                    self._dstats["spec_fallback_requests"] += 1
                    if not self._spec_fallback_warned:
                        self._spec_fallback_warned = True
                        logger.warning(
                            "speculative decoding: sampled requests fall back to the "
                            "plain decode program (their distribution is kept; the "
                            "gain applies to greedy requests only)")
            if spec_seqs:
                decode_seqs += self._spec_step(spec_seqs, out)
        else:
            decode_seqs = active
        if decode_seqs and self._horizon > 1:
            self._multi_decode(decode_seqs, out)
        elif decode_seqs:
            self._decode_step(decode_seqs, out)
        return out

    def _dispatch(self, key, k: int) -> np.ndarray:
        """Run a decode-phase program over the staged inputs: one model
        invocation, one host read; ``k`` decode bodies run."""
        t0 = time.perf_counter()
        res = self._programs.run(key)
        self._stats["decode_seconds"] += time.perf_counter() - t0
        self._stats["decode_device_steps"] += k
        self._dstats["decode_model_invocations"] += 1
        self._dstats["decode_host_syncs"] += 1
        return res

    def _decode_step(self, seqs: List[SequenceState], out: Dict[int, Dict[str, Any]]) -> None:
        """One token for each of ``seqs`` through the decode program."""
        last, pos, act, temps, sids = self._decode_inputs(seqs)
        self._programs.stage(last=last, pos=pos, table=self._page_table, act=act,
                             temps=temps, sids=sids)
        tokens = self._dispatch("decode", 1)
        self._dstats["decode_tokens"] += len(seqs)
        for seq in seqs:
            tok = int(tokens[seq.slot])
            seq.tokens.append(tok)
            seq.prefilled = seq.length - 1  # the step wrote the consumed token's KV
            rec = out.setdefault(seq.uid, {"tokens": [], "done": False})
            rec["tokens"].append(tok)
            self._maybe_finish(seq, tok)
            rec["done"] = seq.done
            if seq.done:
                rec["finish_reason"] = seq.finish_reason

    # -- multi-step decode -----------------------------------------------------
    def _multi_decode(self, seqs: List[SequenceState], out: Dict[int, Dict[str, Any]]) -> None:
        """One multi-step dispatch: clamp each row's budget (max_new, the
        model window, its deadline), take the dispatch horizon on the
        halving chain, shrink it while the truly free pages cannot cover
        the headroom (never preempting mid-program), reserve every row's
        pages, run the K-step program, then advance every sequence from
        its one ``[B, K]`` read."""
        ps = self.block.page_size
        B = self.block.max_seqs
        now = time.perf_counter()
        budgets: Dict[int, int] = {}
        for seq in seqs:
            b = min(self._horizon, seq.max_new_tokens - seq.generated,
                    self.max_seq_len - seq.length)
            if seq.deadline > 0.0:
                b = _deadline_clamp(b, seq.deadline - now, self._tpot_ema)
            budgets[seq.uid] = max(1, b)
        # the smallest chain value covering the largest budget, shrunk while
        # the headroom (tokens a row may never produce) needs more than the
        # truly free pages; k = 1 always fits (step() gave every pending
        # token its page)
        k = _shrink_horizon(self._horizon, max(budgets.values()))

        def extra_pages(k_: int) -> int:
            return sum(max(0, _horizon_pages_needed(s.length, min(k_, budgets[s.uid]), ps)
                           - len(s.pages)) for s in seqs)

        while k > 1 and extra_pages(k) > self.allocator.uncached_free_pages:
            k = (k + 1) // 2
        if k < self._horizon:
            self._dstats["decode_horizon_shrinks"] += 1
        # reserve each row's headroom; a refused reservation clamps that
        # row to the pages it holds
        for seq in seqs:
            b = min(k, budgets[seq.uid])
            extra = _horizon_pages_needed(seq.length, b, ps) - len(seq.pages)
            if extra > 0:
                fresh = self.allocator.try_alloc(extra, uncached_only=True)
                if fresh is None:
                    b = max(1, len(seq.pages) * ps - seq.length + 1)
                else:
                    base = len(seq.pages)
                    seq.pages.extend(fresh)
                    self._page_table[seq.slot, base:base + extra] = fresh
            budgets[seq.uid] = b

        last, pos, act, temps, sids = self._decode_inputs(seqs)
        eos = np.full((B,), -1, np.int32)
        budg = np.zeros((B,), np.int32)
        for seq in seqs:
            if seq.eos_id is not None:
                eos[seq.slot] = seq.eos_id
            budg[seq.slot] = budgets[seq.uid]
        self._programs.stage(last=last, pos=pos, table=self._page_table, act=act,
                             temps=temps, sids=sids, eos=eos, budgets=budg)
        warm = k in self._warm_horizons
        self._warm_horizons.add(k)
        t0 = time.perf_counter()
        res = self._dispatch(("multi", k), k)
        # the program always runs k steps (finished rows run masked), so the
        # time per step is wall / k
        per_step = (time.perf_counter() - t0) / k
        if warm:
            self._tpot_ema = (per_step if self._tpot_ema is None
                              else 0.5 * self._tpot_ema + 0.5 * per_step)
        toks, produced = res[:B * k].reshape(B, k), res[B * k:]
        self._dstats["decode_tokens"] += int(produced.sum())
        for seq in seqs:
            rec = out.setdefault(seq.uid, {"tokens": [], "done": False})
            reason = ""
            for j in range(int(produced[seq.slot])):
                tok = int(toks[seq.slot, j])
                seq.tokens.append(tok)
                rec["tokens"].append(tok)
                reason = self._finish_reason_for(seq, tok)
                if reason:
                    break  # the program stopped the row here
            # KV is written for every token consumed; the last one emitted
            # is the pending one, as after a single step
            seq.prefilled = seq.length - 1
            if reason:
                seq.finish_reason = reason
                self._retire(seq)  # frees unused headroom too
            rec["done"] = seq.done
            if seq.done:
                rec["finish_reason"] = seq.finish_reason

    # -- speculative decoding --------------------------------------------------
    def _spec_step(self, seqs: List[SequenceState],
                   out: Dict[int, Dict[str, Any]]) -> List[SequenceState]:
        """One speculative round for greedy sequences: propose, reserve,
        one batched verify, accept the longest matching prefix and the
        bonus token, roll back the pages of rejected drafts.  Returns the
        sequences it did not run (all of them when every proposal is
        empty) for the plain decode program."""
        ps = self.block.page_size
        k = self.spec.k
        W = k + 1
        B = self.block.max_seqs
        drafts: Dict[int, List[int]] = {}
        for seq in seqs:
            d = list(self._proposer.propose(seq.tokens, k))[:k]
            # cap to the model window, the page table and the request's
            # remaining budget
            cap = min(self.max_seq_len - seq.length,
                      len(self._page_table[seq.slot]) * ps - seq.length,
                      seq.max_new_tokens - seq.generated - 1)
            if len(d) > cap:
                d = d[:max(cap, 0)]
            if d:
                # drafts may be rejected: reserve only truly free pages, and
                # preempt nobody for them
                need = (seq.length - 1 + len(d)) // ps + 1
                extra = need - len(seq.pages)
                while extra > 0 and extra > self.allocator.uncached_free_pages:
                    d.pop()
                    need = (seq.length - 1 + len(d)) // ps + 1
                    extra = need - len(seq.pages)
                if extra > 0:
                    fresh = self.allocator.alloc(extra)
                    base = len(seq.pages)
                    seq.pages.extend(fresh)
                    self._page_table[seq.slot, base:base + extra] = fresh
            drafts[seq.uid] = d
            self._dstats["spec_proposed_tokens"] += len(d)
        if not any(drafts.values()):
            # blanks everywhere: plain decode emits the same one token per
            # row at 1/W of the verify's width
            return list(seqs)

        ids = np.zeros((B, W), np.int32)
        pos = np.zeros((B,), np.int32)
        act = np.zeros((B,), np.int32)
        nv = np.ones((B,), np.int32)
        for seq in seqs:
            row = [seq.tokens[-1]] + drafts[seq.uid]
            ids[seq.slot, :len(row)] = row
            pos[seq.slot] = seq.length - 1
            act[seq.slot] = 1
            nv[seq.slot] = len(row)
        self._programs.stage(ids=ids, pos=pos, table=self._page_table, act=act, n_valid=nv)
        greedy = self._dispatch("verify", 0).reshape(B, W)
        self._dstats["spec_verify_calls"] += 1

        rollback = 0
        for seq in seqs:
            accepted, bonus = longest_accepted(drafts[seq.uid], greedy[seq.slot])
            base_len = seq.length
            self._dstats["spec_accepted_tokens"] += len(accepted)
            rec = out.setdefault(seq.uid, {"tokens": [], "done": False})
            for tok in accepted + [bonus]:
                seq.tokens.append(tok)
                rec["tokens"].append(tok)
                self._dstats["decode_tokens"] += 1
                if self._finish_reason_for(seq, tok):
                    break  # accepted tokens past a finish boundary are dropped
            # KV is valid through the accepted region; the bonus token is
            # the pending one, as after a plain step
            seq.prefilled = min(seq.length - 1, base_len + len(accepted))
            self._maybe_finish(seq, seq.tokens[-1])
            rec["done"] = seq.done
            if seq.done:
                rec["finish_reason"] = seq.finish_reason
            else:
                # pages reserved for rejected drafts go back; rejected KV in
                # kept pages is overwritten by the next window first
                needed = (seq.prefilled - 1) // ps + 1
                if needed < len(seq.pages):
                    drop = seq.pages[needed:]
                    self.allocator.free(drop)
                    del seq.pages[needed:]
                    self._page_table[seq.slot, needed:] = self.block.trash_page
                    rollback += len(drop)
        self._dstats["spec_rollback_pages"] += rollback
        return []

    def _decode_inputs(self, seqs: List[SequenceState]):
        """Dense ``[max_seqs]`` host arrays for a decode batch, shared by
        the single-step and multi-step programs."""
        B = self.block.max_seqs
        last = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        act = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        sids = np.zeros((B,), np.int32)
        for seq in seqs:
            last[seq.slot] = seq.tokens[-1]
            pos[seq.slot] = seq.length - 1
            act[seq.slot] = 1
            temps[seq.slot] = max(seq.temperature, 0.0)
            sids[seq.slot] = seq.uid % (1 << 31)  # stable sampling id
        return last, pos, act, temps, sids

    def generate_all(self, requests: List[RaggedRequest],
                     max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Run requests to completion; full generations keyed by uid."""
        uids = [self.put(r) for r in requests]
        got: Dict[int, List[int]] = {u: [] for u in uids}
        for _ in range(max_steps):
            if not self.has_work():
                break
            for uid, rec in self.step().items():
                got[uid].extend(rec["tokens"])
        else:
            logger.warning("generate_all: max_steps reached with work pending")
        return got
