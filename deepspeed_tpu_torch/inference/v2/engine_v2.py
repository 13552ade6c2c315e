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
Mixtral MoE models serve through the same programs.

Automatic prefix caching (``enable_prefix_cache``): retired and preempted
sequences leave their full KV pages in a content-hash index
(``ragged.PrefixCache``), and a new request maps the longest cached
page-aligned prefix into its page table and prefills only the suffix (a
fully cached prompt enters the decode program through a copy-on-write
last page).  Greedy streams equal cache-off's, except under ``kv_quant``,
as in JAX.  ``kv_tier`` (``serving.KVTierConfig``) spills pages evicted
from the cache's LRU to host RAM (and NVMe) and restores them; and
``export_sequence`` / ``import_sequence`` move a decode-ready sequence
between engines as a ``KVPageBundle`` (``ready_uids`` lists the
candidates, ``inflight_uids`` every unfinished uid, and ``drain`` retires
the engine for the serving fleet: admission stops, admitted work runs
out, the queue is handed back).  Every page copy writes the live
pools in place, outside the captured programs, which therefore read them
after a copy on write, an import or a restore.

Serving telemetry (``telemetry/``), as in JAX: the ``deepspeed_tpu_serving_*``
metric family on the process registry (the per-engine ``stats()``,
``decode_stats()`` and ``cache_stats()`` keep their own values; the
registry takes deltas), a request span per request and point events at
admission, preemption, expiry, horizon shrinks, rollbacks and KV moves,
TTFT and TPOT histograms with the ``slo_ttft_s`` / ``slo_tpot_s``
violation counters and their exemplars, the request-trace ledger's
transitions (no-ops unless a ``ReqTraceLedger`` is set), the recompile
sentinel over each step's program parts (``recompile_sentinel``), the
memory ledger's components and phase watermarks (``memory_ledger``), a
``torch.profiler`` step timeline every ``timeline_every_n_steps`` steps
(or on ``force_timeline_capture``), and a flight-recorder dump when a
step raises (the exception propagates).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.convert import params_from_numpy
from ...models.transformer import ParamTree, TransformerConfig
from ...runtime.config_utils import ConfigModel
from ...runtime.precision import cast_tree, cast_tree_copy
from ...telemetry import get_registry
from ...telemetry.compile_sentinel import RecompileSentinel
from ...telemetry.compile_sentinel import expect_recompile as sentinel_expect_recompile
from ...telemetry.flight import dump_on_exception
from ...telemetry.reqtrace import get_reqtrace_ledger, slo_exemplar
from ...telemetry.spans import begin_span, end_span, record_event, span
from ...telemetry.timeline import StepTimeline
from ...telemetry.tracing import PhaseTimer
from ..quantization import quantize_inference_params
from ...utils.logging import logger
from .captured import DecodePrograms
from .model_runner import (host_buffer, paged_copy_page, paged_gather_pages, paged_prefill,
                           paged_prefill_chunk, paged_scatter_pages)
from .ragged import (PRIORITY_NORMAL, BlockAllocator, KVBlockConfig, KVPageBundle,
                     PagedKVCache, PrefixCache, RejectedError, SequenceState)
from .speculative import SpeculativeConfig, build_proposer, longest_accepted

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def _pow2(n: int) -> int:
    """``n`` rounded up to a power of two (at least 1): the JAX engine's
    bucketed row count of a spill drain or restore (``pad_pages_pow2``),
    which names that work in the step's program parts."""
    b = 1
    while b < n:
        b *= 2
    return b


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
    """Every field of the JAX engine's config, by the same name."""

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
    #: automatic prefix caching: new requests map the longest cached
    #: page-aligned prefix and prefill only the suffix
    enable_prefix_cache: bool = False
    #: cap on cached-but-unreferenced pages kept (LRU); 0 = pool-bounded
    prefix_cache_pages: int = 0
    #: tiered KV cache: a ``serving.KVTierConfig`` (or its dict form);
    #: needs ``enable_prefix_cache``
    kv_tier: Any = None
    #: recompile sentinel for the serving loop: attribute CUDA-graph
    #: captures and kernel builds to steps
    recompile_sentinel: bool = True
    sentinel_steady_after: int = 3
    #: step-time attribution: every N engine steps capture one step under
    #: torch.profiler (0 = only on ``force_timeline_capture()``)
    timeline_every_n_steps: int = 0
    #: directory of each capture's merged Chrome trace ("" = none)
    timeline_artifact_dir: str = ""
    #: attach the weights and KV pools to the process memory ledger
    memory_ledger: bool = True
    speculative: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)
    decode_horizon: int = 1
    #: bounded request queue: once this many requests wait, ``put()``
    #: raises RejectedError; <= 0 = unbounded
    max_queue_depth: int = 0
    #: SLO limits (0 = off): first tokens later than ``slo_ttft_s`` and
    #: finished requests whose mean inter-token time exceeds ``slo_tpot_s``
    #: count into ``deepspeed_tpu_serving_slo_{ttft,tpot}_violations_total``
    #: and emit an ``slo_violation`` trace event
    slo_ttft_s: float = 0.0
    slo_tpot_s: float = 0.0

    def validate(self) -> None:
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {sorted(DTYPES)}")
        if isinstance(self.speculative, dict):
            self.speculative = SpeculativeConfig.from_dict(self.speculative)
        if isinstance(self.kv_tier, dict):
            from ...serving.config import KVTierConfig

            self.kv_tier = KVTierConfig.from_dict(self.kv_tier)
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
        # cast first: casting takes every floating leaf, so it must never
        # run after quantization (the scales stay fp32)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = cast_tree(model.init_params(gen, self.device), dtype)
        elif isinstance(params, dict):
            params = params_from_numpy(params, self.cfg, self.device, dtype)
        elif isinstance(params, ParamTree):
            # a caller's tree is served as it is when it already lies on the
            # device in the dtype, else copied: never moved or cast in place
            params = cast_tree_copy(params, dtype, self.device)
        else:
            raise TypeError(f"params must be a ParamTree or a numpy tree, not {type(params)}")
        self.params = params
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
        self.allocator = BlockAllocator(
            block.num_pages, cache_pages=(self.config.prefix_cache_pages
                                          if self.config.enable_prefix_cache else 0))
        self.prefix_cache = (PrefixCache(block.page_size, self.allocator)
                             if self.config.enable_prefix_cache else None)
        # the host (and NVMe) tier captures the prefix cache's LRU
        # evictions; captures wait, their pages pinned, for the next step
        # boundary's drain
        self.kv_tier = None
        self._pending_spills: List[Tuple[int, Any]] = []
        self._pending_spill_keys: set = set()
        tier_cfg = self.config.kv_tier
        if tier_cfg is not None and tier_cfg.enabled:
            if not self.config.enable_prefix_cache:
                raise ValueError("kv_tier.enabled requires enable_prefix_cache: the host "
                                 "tier captures prefix-cache LRU evictions")
            from ...serving.kv_tier import HostKVTier

            self.kv_tier = HostKVTier(tier_cfg)
            self.allocator.spill_hook = self._capture_evicted_page
        self._uid = itertools.count()
        self._admit_counter = itertools.count()
        self._enqueue_counter = itertools.count()
        self._rng = np.random.RandomState(seed)
        self._seed = int(seed)
        self._queue: List[SequenceState] = []
        self._slots: List[Optional[SequenceState]] = [None] * block.max_seqs
        #: set by drain(): the engine is retiring, put() refuses admissions
        self._draining = False
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
        #: runs K; a verify runs none); ``decode_entries``: fully cached
        #: prompts admitted straight into the decode program
        self._stats = {"prefill_calls": 0, "prefill_chunk_calls": 0,
                       "prefill_admitted_tokens": 0, "prefill_computed_tokens": 0,
                       "prefix_hit_tokens": 0, "decode_entries": 0, "prefill_seconds": 0.0,
                       "decode_seconds": 0.0, "decode_device_steps": 0, "preemptions": 0}
        #: decode-phase counters by the JAX engine's names (decode_stats)
        self._dstats = {"decode_model_invocations": 0, "decode_tokens": 0,
                        "decode_host_syncs": 0, "decode_horizon_shrinks": 0,
                        "spec_proposed_tokens": 0, "spec_accepted_tokens": 0,
                        "spec_verify_calls": 0, "spec_rollback_pages": 0,
                        "spec_fallback_requests": 0}
        self._init_serving_metrics()
        # request lifecycle bookkeeping: enqueue/first-token stamps and the
        # open request span, keyed by uid (survives preemption)
        self._req_meta: Dict[int, Dict[str, Any]] = {}
        # the step's program parts for the recompile sentinel: each prefill
        # bucket or chunk shape, the decode-phase programs, page copies
        self._step_parts: set = set()
        #: decode-phase dispatches (plain and multi-step), the timeline's
        #: step clock as in JAX
        self._decode_steps = 0
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
        self._sentinel = None
        if self.config.recompile_sentinel:
            self._sentinel = RecompileSentinel(
                loop="serve", steady_after=self.config.sentinel_steady_after)
            # the programs were just captured (one compile each on CUDA):
            # construction's work, not the first step's
            self._sentinel.expect_recompile("engine_construction")
        # step-time attribution: periodic (timeline_every_n_steps) or
        # on demand (force_timeline_capture); only the captured step pays
        self._timeline = StepTimeline(
            every_n_steps=self.config.timeline_every_n_steps,
            artifact_dir=self.config.timeline_artifact_dir, device=self.device)
        self._wire_memory_ledger()

    def _wire_memory_ledger(self) -> None:
        """Attach the engine's device residents to the process memory
        ledger: the weights, the KV page pool and, informationally (a
        sub-slice of the pool), the bytes parked in the prefix cache's LRU;
        with the host tier, its host RAM.  The providers hold the engine
        only weakly, so a dropped engine is collected with or without
        ``close()``; ``close()`` detaches exactly what this engine
        attached (a newer engine's components stay)."""
        self._ledger_components: List[Tuple[str, Any]] = []
        if not self.config.memory_ledger:
            return
        from ...telemetry.memory import get_memory_ledger

        led = get_memory_ledger()
        led.install_phase_watch()  # prefill/decode peak watermarks
        ref = weakref.ref(self)

        def _attach(name, read, **kw):
            def provider():
                eng = ref()
                return None if eng is None else read(eng)
            led.attach(name, provider, **kw)
            self._ledger_components.append((name, provider))

        _attach("serving_params", lambda e: e.params)
        _attach("kv_pool", lambda e: e._pools)
        _attach("kv_prefix_pinned", lambda e: {"device": e._pinned_page_bytes()},
                informational=True)
        if self.kv_tier is not None:
            # spilled pages are host RAM this engine owns
            _attach("kv_host_tier", lambda e: {"host": e.kv_tier.host_bytes})
        led.update_context(
            kv_num_pages=self.block.num_pages, kv_page_size=self.block.page_size,
            kv_max_seqs=self.block.max_seqs, kv_quant=self.config.kv_quant,
            prefix_cache=self.config.enable_prefix_cache)

    def _pinned_page_bytes(self) -> int:
        """Device bytes held by prefix-cache LRU pages: the pool's per-page
        cost times the parked-page count."""
        from ...telemetry.memory import tree_bytes

        dev, _host = tree_bytes(self._pools)
        return dev * self.allocator.lru_pages // (self.block.num_pages + 1)

    # -- telemetry -----------------------------------------------------------
    def _init_serving_metrics(self) -> None:
        """Register the serving metric family on the process registry
        (get-or-create: engines in one process share the cumulative
        series; ``stats()`` and ``cache_stats()`` keep the per-engine
        view).  Names, help strings, labels and buckets are the JAX
        engine's."""
        reg = get_registry()
        self._m_queue = reg.gauge(
            "deepspeed_tpu_serving_queue_depth",
            "requests waiting for admission")
        self._m_occupancy = reg.gauge(
            "deepspeed_tpu_serving_batch_occupancy",
            "occupied decode slots / max_seqs")
        self._m_prefill_h = reg.histogram(
            "deepspeed_tpu_serving_prefill_seconds",
            "per-sequence prefill program wall time (one chunk or whole "
            "prompt, incl. the prefix-end sample)")
        self._m_decode_h = reg.histogram(
            "deepspeed_tpu_serving_decode_seconds",
            "one batched decode step wall time (dispatch + token fetch)")
        self._m_requests = reg.counter(
            "deepspeed_tpu_serving_requests_total", "requests enqueued")
        self._m_gen_tokens = reg.counter(
            "deepspeed_tpu_serving_tokens_generated_total",
            "tokens produced by the decode program")
        self._m_admitted = reg.counter(
            "deepspeed_tpu_serving_prefill_admitted_tokens_total",
            "prompt tokens admitted for prefill")
        self._m_computed = reg.counter(
            "deepspeed_tpu_serving_prefill_computed_tokens_total",
            "prompt tokens actually computed (admitted minus prefix hits)")
        self._m_hit_tokens = reg.counter(
            "deepspeed_tpu_serving_prefix_hit_tokens_total",
            "prompt tokens served from the prefix cache")
        self._m_cache_hits = reg.counter(
            "deepspeed_tpu_serving_prefix_cache_hits_total",
            "prefix-cache page lookups that matched")
        self._m_cache_misses = reg.counter(
            "deepspeed_tpu_serving_prefix_cache_misses_total",
            "admission walks ending on a missing page")
        self._m_cache_evict = reg.counter(
            "deepspeed_tpu_serving_prefix_cache_evictions_total",
            "cached pages evicted (LRU or cap trim)")
        self._m_cached_pages = reg.gauge(
            "deepspeed_tpu_serving_prefix_cached_pages",
            "pages currently parked in the prefix cache")
        self._m_preemptions = reg.counter(
            "deepspeed_tpu_serving_preemptions_total",
            "sequences evicted to the queue under KV-pool pressure")
        # KV page-pool occupancy: used + free == num_pages; pinned pages
        # (cached-but-unreferenced LRU) are a subset of free
        self._m_kv_used = reg.gauge(
            "deepspeed_tpu_serving_kv_pages_used",
            "KV pool pages referenced by live sequences")
        self._m_kv_free = reg.gauge(
            "deepspeed_tpu_serving_kv_pages_free",
            "allocatable KV pool pages (truly free + cached-unreferenced)")
        self._m_kv_pinned = reg.gauge(
            "deepspeed_tpu_serving_kv_pages_pinned",
            "cached-but-unreferenced pages parked in the prefix-cache LRU")
        self._m_ttft_h = reg.histogram(
            "deepspeed_tpu_serving_ttft_seconds",
            "time to first token: enqueue to first sampled token "
            "(includes queue wait)")
        self._m_tpot_h = reg.histogram(
            "deepspeed_tpu_serving_tpot_seconds",
            "mean time per output token after the first, observed once "
            "per finished request")
        # speculative decoding family (flat zeros with speculation off)
        self._m_invocations = reg.counter(
            "deepspeed_tpu_serving_decode_model_invocations_total",
            "decode-phase model program calls (plain decode steps + "
            "speculative verify calls) — tokens/invocation is the "
            "speculative figure of merit")
        self._m_spec_proposed = reg.counter(
            "deepspeed_tpu_serving_spec_proposed_tokens_total",
            "draft tokens proposed for verification")
        self._m_spec_accepted = reg.counter(
            "deepspeed_tpu_serving_spec_accepted_tokens_total",
            "draft tokens accepted (matched the model's greedy choice)")
        self._m_spec_rollback = reg.counter(
            "deepspeed_tpu_serving_spec_rollback_pages_total",
            "draft-reserved KV pages rolled back after rejection")
        self._m_spec_fallback = reg.counter(
            "deepspeed_tpu_serving_spec_fallback_requests_total",
            "non-greedy requests routed to the plain decode program by "
            "the sampling guard (speculation never changes the "
            "sampling distribution)")
        self._m_spec_tps = reg.histogram(
            "deepspeed_tpu_serving_spec_tokens_per_step",
            "tokens emitted per sequence per verify call (accepted "
            "prefix + the model's correction token; >= 1)")
        self._m_spec_rate = reg.gauge(
            "deepspeed_tpu_serving_spec_acceptance_rate",
            "cumulative accepted / proposed draft tokens")
        self._m_spec_verify_h = reg.histogram(
            "deepspeed_tpu_serving_spec_verify_seconds",
            "one batched speculative verify program wall time")
        # multi-step decode family (decode_horizon > 1)
        self._m_tokens_per_dispatch = reg.histogram(
            "deepspeed_tpu_serving_decode_tokens_per_dispatch",
            "tokens emitted per decode-phase device dispatch (a fused "
            "multi-step scan emits up to horizon x batch per dispatch; "
            "the K=1 loop at most batch)")
        self._m_host_syncs = reg.counter(
            "deepspeed_tpu_serving_decode_host_syncs_total",
            "decode-phase host round-trips (device token pulls): the "
            "fused multi-step scan pays ONE per horizon where the K=1 "
            "loop pays one per token")
        self._m_horizon_shrink = reg.counter(
            "deepspeed_tpu_serving_decode_horizon_shrink_total",
            "multi-step dispatches whose horizon was shrunk below "
            "decode_horizon (KV-pool headroom pressure or short row "
            "budgets) instead of preempting mid-scan")
        # serving-SLO family: deadline expiry, queue wait and the TTFT/TPOT
        # violations live on the engine; the shed half in
        # serving/admission.py
        self._m_deadline = reg.counter(
            "deepspeed_tpu_serving_slo_deadline_exceeded_total",
            "requests expired past their deadline at a step boundary "
            '(finish_reason="deadline")')
        self._m_queue_wait_h = reg.histogram(
            "deepspeed_tpu_serving_slo_queue_wait_seconds",
            "enqueue -> admission wait, observed per admission (a "
            "preempted sequence re-admitting observes again)")
        self._m_ttft_viol = reg.counter(
            "deepspeed_tpu_serving_slo_ttft_violations_total",
            "first tokens arriving later than slo_ttft_s")
        self._m_tpot_viol = reg.counter(
            "deepspeed_tpu_serving_slo_tpot_violations_total",
            "finished requests whose mean inter-token time exceeded "
            "slo_tpot_s")
        # last-published absolutes of the per-engine cache counters: the
        # process-cumulative registry counters receive only deltas
        self._cache_pub = {"hits": 0, "misses": 0, "evictions": 0}

    def _phase(self, name: str, hist, **attrs) -> PhaseTimer:
        """Profiler range + wall-time histogram + trace-ring span for one
        serving phase; ``attrs`` land on the span only."""
        return PhaseTimer(name, sink=lambda _n, dt: hist.observe(dt), **attrs)

    # -- request lifecycle bookkeeping ---------------------------------------
    def _reqtrace(self, seq: SequenceState):
        """The request-trace ledger's entry for ``seq`` (None when the
        engine runs standalone: every reqtrace hook is then a no-op)."""
        if seq is None or seq.trace_id is None:
            return None
        led = get_reqtrace_ledger()
        return None if led is None else led.get(seq.trace_id)

    def _note_tokens(self, seq: SequenceState, n: int = 1,
                     t: Optional[float] = None) -> None:
        """Account ``n`` newly emitted tokens: the first closes the TTFT
        window (enqueue -> first token).  ``t`` is the token's emit time; a
        multi-step dispatch passes per-token times reconstructed from the
        horizon, so TTFT and TPOT never see a K-token burst at one
        instant."""
        m = self._req_meta.get(seq.uid)
        if m is None:
            return
        now = t if t is not None else time.perf_counter()
        if m["t_first"] is None:
            m["t_first"] = now
            ttft = now - m["t0"]
            self._m_ttft_h.observe(ttft)
            tr = self._reqtrace(seq)
            if tr is not None:
                tr.note_first_token(now)
                tr.transition("decode", getattr(self, "trace_owner", "engine"), now)
            if 0 < self.config.slo_ttft_s < ttft:
                self._m_ttft_viol.inc()
                slo_exemplar("deepspeed_tpu_serving_slo_ttft_violations_total",
                             seq.trace_id, uid=seq.uid, ttft_s=round(ttft, 6))
                self._slo_violation("ttft", ttft, self.config.slo_ttft_s,
                                    seq.uid, seq.trace_id)
        m["t_last"] = now
        m["n"] += n

    def _slo_violation(self, kind: str, value: float, limit: float,
                       uid: int, trace_id: Optional[str] = None) -> None:
        """The one call site of the ``slo_violation`` event (TTFT and TPOT)."""
        record_event("slo_violation", cat="serve", kind=kind,
                     value=round(value, 6), limit=limit, uid=uid,
                     **({} if trace_id is None else {"trace_id": trace_id}))

    def _finish_request(self, seq: SequenceState) -> None:
        """Close the request span and observe TPOT (mean inter-token time
        after the first)."""
        m = self._req_meta.pop(seq.uid, None)
        if m is None:
            return
        if m["n"] > 1 and m["t_first"] is not None:
            tpot = (m["t_last"] - m["t_first"]) / (m["n"] - 1)
            self._m_tpot_h.observe(tpot)
            if 0 < self.config.slo_tpot_s < tpot:
                self._m_tpot_viol.inc()
                slo_exemplar("deepspeed_tpu_serving_slo_tpot_violations_total",
                             seq.trace_id, uid=seq.uid, tpot_s=round(tpot, 6))
                self._slo_violation("tpot", tpot, self.config.slo_tpot_s,
                                    seq.uid, seq.trace_id)
        end_span(m["span"], generated=m["n"],
                 total_s=round(time.perf_counter() - m["t0"], 6))
        if seq.trace_id is not None:
            led = get_reqtrace_ledger()
            if led is not None:
                led.finish(seq.trace_id, seq.finish_reason or "complete")

    def _pool_occupancy(self) -> Dict[str, int]:
        """KV pool occupancy, attached to admission and preemption events."""
        a = self.allocator
        return {"pages_used": a.used_pages, "pages_free": a.free_pages,
                "pages_pinned": a.lru_pages}

    def _publish_pool_gauges(self) -> None:
        occ = self._pool_occupancy()
        self._m_kv_used.set(occ["pages_used"])
        self._m_kv_free.set(occ["pages_free"])
        self._m_kv_pinned.set(occ["pages_pinned"])

    def _sync_cache_counters(self) -> None:
        """Forward the allocator's and prefix cache's counter deltas to the
        registry (they stay the per-engine source of ``cache_stats()``)."""
        self._publish_pool_gauges()
        pub = self._cache_pub
        ev = self.allocator.evictions
        if ev > pub["evictions"]:
            self._m_cache_evict.inc(ev - pub["evictions"])
            pub["evictions"] = ev
        if self.prefix_cache is not None:
            h, m = self.prefix_cache.hits, self.prefix_cache.misses
            if h > pub["hits"]:
                self._m_cache_hits.inc(h - pub["hits"])
                pub["hits"] = h
            if m > pub["misses"]:
                self._m_cache_misses.inc(m - pub["misses"])
                pub["misses"] = m
        self._m_cached_pages.set(self.allocator.cached_pages)

    # -- request API ---------------------------------------------------------
    def put(self, request: RaggedRequest, *, record_shed: bool = True) -> int:
        """Queue a request; returns its uid.  A full bounded queue
        (``max_queue_depth``) raises :class:`RejectedError`, counted as a
        shed first (``serving.admission.record_shed``) unless
        ``record_shed=False``: a placer that tries several engines (the
        fleet router) counts at most one shed per request itself.  A
        draining engine refuses every request."""
        if self._draining:
            raise RuntimeError("engine is draining/retired: no new "
                               "admissions (route to another replica)")
        uid = request.uid if request.uid is not None else next(self._uid)
        n = len(request.prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if n >= self.max_seq_len:
            raise ValueError(f"prompt length {n} >= max_seq_len {self.max_seq_len}")
        if (self.config.max_queue_depth > 0
                and len(self._queue) >= self.config.max_queue_depth):
            # deferred: serving imports inference, never the reverse at
            # module scope
            from ...serving.admission import record_shed as _record_shed
            from ...serving.admission import retry_after_hint

            hint = retry_after_hint(len(self._queue))
            if record_shed:
                _record_shed(request.priority, "engine_queue_full", hint,
                             uid=request.uid, trace_id=request.trace_id)
            raise RejectedError("engine_queue_full", retry_after_s=hint,
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
        self._req_meta[uid] = {
            "t0": now, "t_first": None, "t_last": None, "n": 0,
            "span": begin_span("request", cat="serve", uid=uid, prompt_tokens=n,
                               priority=request.priority,
                               max_new_tokens=request.max_new_tokens,
                               **({} if request.trace_id is None
                                  else {"trace_id": request.trace_id,
                                        "replica": getattr(self, "trace_owner",
                                                           "engine")}))}
        self._m_requests.inc()
        self._m_queue.set(len(self._queue))
        return uid

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def inflight_uids(self) -> List[int]:
        """uids of every unfinished request this engine owns: admitted (in
        a slot) first, then queued."""
        return ([s.uid for s in self._slots if s is not None]
                + [s.uid for s in self._queue])

    def ready_uids(self) -> List[int]:
        """uids of admitted sequences that are decode-ready (prefill
        complete, first token sampled): the migration candidates a
        disaggregated router streams from prefill to decode replicas."""
        return [s.uid for s in self._slots
                if s is not None and self._ready_to_decode(s)]

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

    def cache_stats(self) -> Dict[str, float]:
        """Prefix-cache and prefill-work counters by the JAX engine's
        names (cumulative; the cache entries stay 0 with caching off):
        admitted, computed and cache-hit prompt tokens, page hits and
        misses, evictions, pages registered, and ``prefix_hit_rate``.
        Forwards the counters' deltas to the registry first."""
        self._sync_cache_counters()
        s: Dict[str, float] = {k: self._stats[k] for k in (
            "prefill_admitted_tokens", "prefill_computed_tokens", "prefix_hit_tokens")}
        s["cache_hits"] = self.prefix_cache.hits if self.prefix_cache else 0
        s["cache_misses"] = self.prefix_cache.misses if self.prefix_cache else 0
        s["cache_evictions"] = self.allocator.evictions
        s["cached_pages"] = self.allocator.cached_pages
        adm = s["prefill_admitted_tokens"]
        s["prefix_hit_rate"] = (s["prefix_hit_tokens"] / adm) if adm else 0.0
        return s

    def reset_cache_stats(self) -> None:
        """Zero every counter (the cache's and the tier's contents stay).
        The registry's counters stay cumulative; only their delta baseline
        resets with the sources."""
        self._stats = {k: type(v)(0) for k, v in self._stats.items()}
        self._dstats = {k: 0 for k in self._dstats}
        self.allocator.evictions = 0
        if self.prefix_cache is not None:
            self.prefix_cache.hits = self.prefix_cache.misses = 0
        if self.kv_tier is not None:
            t = self.kv_tier
            t.spilled_pages = t.restored_pages = 0
            t.hits = t.misses = 0
            t.host_evictions = t.corrupt_pages = t.dropped_spills = 0
            t.spill_seconds = t.restore_seconds = 0.0
        self._cache_pub = {"hits": 0, "misses": 0, "evictions": 0}

    def publish_metrics(self, monitor, step: int) -> None:
        """The serving counters of :meth:`cache_stats` through a monitor
        writer (``monitor.monitor.MonitorMaster`` or any object with
        ``write_events``), tagged ``serving/<name>``; host counters only,
        nothing is read from the card."""
        monitor.write_events([(f"serving/{k}", float(v), int(step))
                              for k, v in self.cache_stats().items()])

    def tier_stats(self) -> Dict[str, float]:
        """The host tier's counters (``HostKVTier.stats``); {} with the
        tier off."""
        return dict(self.kv_tier.stats()) if self.kv_tier else {}

    def assert_no_leaks(self) -> None:
        """Exact allocator audit against the live sequences: every page's
        refcount equals its live references plus an in-flight spill pin,
        and every unreferenced page is free or parked in the cache's LRU
        (after rollback, preemption, migration or retirement)."""
        self.allocator.assert_no_leaks([s.pages for s in self._slots if s is not None])

    def drain(self, max_steps: int = 10_000) -> Dict[str, Any]:
        """Stop admission and run every admitted sequence to completion.

        Returns ``{"finished": {uid: SequenceState}, "pending":
        [SequenceState, ...]}``: ``finished`` holds the final states (full
        token lists, ``done`` flags) of the sequences that were in flight;
        ``pending`` the queued requests never admitted, returned un-run for
        the caller to re-dispatch.  Afterwards ``put()`` refuses every
        request: clean replica retirement (``close()`` alone would drop
        in-flight work).  The host tier's pending captures are committed."""
        self._draining = True
        pending = list(self._queue)
        self._queue.clear()
        for s in pending:
            m = self._req_meta.pop(s.uid, None)
            if m is not None:
                end_span(m["span"], requeued=True)
        inflight = {s.uid: s for s in self._slots if s is not None}
        steps = 0
        while any(s is not None for s in self._slots) or self._queue:
            if steps >= max_steps:
                logger.warning("engine_v2.drain: max_steps reached with work pending")
                break
            self.step()
            steps += 1
        self._m_queue.set(len(self._queue))
        self._drain_spills()  # retirement commits captures, frees pins
        record_event("engine_drain", cat="serve", finished=len(inflight),
                     requeued=len(pending), steps=steps)
        return {"finished": inflight, "pending": pending}

    def abort_all(self, reason: str = "abort") -> List[int]:
        """Free every queued and admitted request without running it (pages
        released, request spans closed); returns their uids."""
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
        for uid in uids:
            self._spec_fallback_uids.discard(uid)
            m = self._req_meta.pop(uid, None)
            if m is not None:
                end_span(m["span"], aborted=reason, generated=m["n"])
        if uids:
            self._m_queue.set(0)
            self._publish_pool_gauges()
            logger.info(f"serving: aborted {len(uids)} request(s) ({reason})")
        return uids

    def close(self) -> None:
        """Drop the pending spill captures (their pins released, the hook
        detached first so the aborts below capture nothing new), abort what
        is still queued or running, loudly, and detach this engine's
        memory-ledger components (those a newer engine claimed stay).
        Idempotent."""
        if self.kv_tier is not None:
            self.allocator.spill_hook = None
        for page, _key in self._pending_spills:
            self.allocator.release_spill_pin(page)
        self._pending_spills = []
        self._pending_spill_keys = set()
        dropped = self.abort_all(reason="close")
        if dropped:
            logger.warning(
                f"engine_v2.close: aborted {len(dropped)} unfinished "
                f"request(s) (uids {dropped[:8]}{'…' if len(dropped) > 8 else ''})")
        if self._ledger_components:
            from ...telemetry.memory import get_memory_ledger

            led = get_memory_ledger()
            for name, prov in self._ledger_components:
                led.detach(name, provider=prov)
        self._ledger_components = []

    # -- KV-page migration: export, import, release --------------------------
    def _find_slotted(self, uid: int) -> SequenceState:
        seq = next((s for s in self._slots if s is not None and s.uid == uid), None)
        if seq is None:
            raise KeyError(f"uid {uid} is not in a decode slot (queued or unknown "
                           "sequences have no KV pages to export)")
        return seq

    def export_sequence(self, uid: int) -> KVPageBundle:
        """An admitted sequence's KV pages (CPU tensors, the pool's exact
        dtype) and scheduling state as a :class:`KVPageBundle`.  The
        sequence keeps running here: release it only after an import
        elsewhere succeeded."""
        seq = self._find_slotted(uid)
        ps = self.block.page_size
        immutable = seq.prefilled // ps  # pages never written again
        bundle = KVPageBundle(
            uid=seq.uid, tokens=list(seq.tokens), prompt_len=seq.prompt_len,
            max_new_tokens=seq.max_new_tokens, temperature=seq.temperature,
            eos_id=seq.eos_id, prefilled=seq.prefilled, decode_entry=seq.decode_entry,
            page_size=ps, page_keys=list(seq.page_keys[:min(immutable, len(seq.page_keys))]),
            priority=seq.priority, deadline=seq.deadline,
            src_pages=self.allocator.export_meta(seq.pages),
            arrays=paged_gather_pages(self._pools, seq.pages),
            model_sig=(self.cfg.n_layers, self.cfg.kv_heads, self.cfg.head_dim),
            kv_quant=bool(self.config.kv_quant), dtype=self.config.dtype)
        tr = self._reqtrace(seq)
        if tr is not None:
            # the handoff starts here: the ledger's phase turns kv_transfer
            # and the bundle carries the trace id and a clock-free snapshot
            tr.transition("kv_transfer", getattr(self, "trace_owner", "engine"))
            bundle.trace = {"trace_id": seq.trace_id, "snapshot": tr.wire_snapshot(),
                            "hops": []}
        elif seq.trace_id is not None:
            bundle.trace = {"trace_id": seq.trace_id, "snapshot": None, "hops": []}
        record_event("kv_export", cat="serve", uid=uid, pages=len(seq.pages),
                     tokens=len(seq.tokens),
                     **({} if seq.trace_id is None else {"trace_id": seq.trace_id}))
        # work outside the step's programs, announced as the JAX engine
        # announces its op-by-op gather
        sentinel_expect_recompile("kv_export")
        return bundle

    def _check_bundle(self, b: KVPageBundle) -> None:
        sig = (self.cfg.n_layers, self.cfg.kv_heads, self.cfg.head_dim)
        if tuple(b.model_sig) != sig:
            raise ValueError(f"bundle model_sig {tuple(b.model_sig)} != engine {sig}")
        if b.page_size != self.block.page_size:
            raise ValueError(f"bundle page_size {b.page_size} != {self.block.page_size}")
        if bool(b.kv_quant) != bool(self.config.kv_quant):
            raise ValueError("kv_quant mismatch between bundle and engine")
        if str(b.dtype) != str(self.config.dtype):
            # checked here too: an import that adopts every page scatters
            # nothing, and sharing pages across precisions breaks identity
            raise ValueError(f"bundle dtype {b.dtype!r} != engine dtype "
                             f"{self.config.dtype!r}")
        if b.n_pages > self.block.max_pages_per_seq:
            raise ValueError(f"bundle spans {b.n_pages} pages > max_pages_per_seq "
                             f"{self.block.max_pages_per_seq}")
        if len(b.tokens) >= self.max_seq_len:
            raise ValueError(f"bundle length {len(b.tokens)} >= max_seq_len "
                             f"{self.max_seq_len}: nothing left to decode")
        if not ((b.generated > 0 or b.decode_entry) and b.prefilled >= len(b.tokens) - 1):
            raise ValueError("bundle is not decode-ready (mid-prefill handoff is not "
                             "supported: re-dispatch the request instead)")

    def import_sequence(self, bundle: KVPageBundle) -> bool:
        """Adopt a migrated sequence: its pages go into this pool (sharing
        pages registered here under the same content key instead of
        copying them) and it takes a decode slot at once.  False, the
        engine untouched, when no slot or not enough pages are free;
        ``ValueError`` when the bundle does not fit this engine."""
        self._check_bundle(bundle)
        slot = next((i for i, s in enumerate(self._slots) if s is None), None)
        if slot is None:
            return False
        n = bundle.n_pages
        keys = list(bundle.page_keys)
        adopt_keys: List[Any] = [None] * n
        if self.prefix_cache is not None:
            for j, k in enumerate(keys[:n]):
                adopt_keys[j] = k
        try:
            pages, reused = self.allocator.adopt(adopt_keys)
        except MemoryError:
            return False
        fresh = [j for j, r in enumerate(reused) if not r]
        if fresh:
            try:
                idx = torch.tensor(fresh)
                # the fresh pages' slices, gathered into pinned staging
                arrays = {k: torch.index_select(v, 1, idx, out=host_buffer(
                    (v.shape[0], len(fresh)) + tuple(v.shape[2:]), v.dtype, self.device))
                    for k, v in bundle.arrays.items()}
                paged_scatter_pages(self._pools, [pages[j] for j in fresh], arrays)
            except ValueError:
                self.allocator.free(pages)  # a refused import leaks nothing
                raise
            sentinel_expect_recompile("kv_import")
        if self.prefix_cache is not None:
            # publish the freshly written full pages here too (first writer
            # wins); adopted pages are registered already
            for j in fresh:
                if j < len(keys):
                    self.allocator.register(pages[j], keys[j])
        trace_id = bundle.trace.get("trace_id") if bundle.trace is not None else None
        seq = SequenceState(
            uid=bundle.uid, tokens=list(bundle.tokens), prompt_len=bundle.prompt_len,
            max_new_tokens=bundle.max_new_tokens, temperature=bundle.temperature,
            eos_id=bundle.eos_id, slot=slot, pages=pages, prefilled=bundle.prefilled,
            decode_entry=bundle.decode_entry, page_keys=keys, registered_upto=len(keys),
            priority=bundle.priority, deadline=bundle.deadline,
            enqueue_order=next(self._enqueue_counter), trace_id=trace_id)
        seq.admit_order = next(self._admit_counter)
        self._slots[slot] = seq
        self._page_table[slot, :] = self.block.trash_page
        self._page_table[slot, :len(pages)] = pages
        now = time.perf_counter()
        if trace_id is not None:
            led = get_reqtrace_ledger()
            if led is not None:
                tr = led.get(trace_id)
                if tr is None and bundle.trace.get("snapshot") is not None:
                    # cross-process import: re-anchor the sender's ledger
                    # here, wire transit folded into kv_transfer
                    tr = led.adopt(bundle.trace["snapshot"],
                                   transit_s=float(bundle.trace.get("transit_s", 0.0)))
                if tr is not None:
                    tr.transition("decode", getattr(self, "trace_owner", "engine"), now)
        # TTFT belongs to the exporting engine (it sampled the first token);
        # local TPOT accounting restarts at the handoff
        self._req_meta[bundle.uid] = {
            "t0": now, "t_first": now if bundle.generated > 0 else None,
            "t_last": now, "n": bundle.generated,
            "span": begin_span("request_migrated", cat="serve", uid=bundle.uid,
                               tokens=len(bundle.tokens), adopted_pages=sum(reused),
                               **({} if trace_id is None
                                  else {"trace_id": trace_id,
                                        "replica": getattr(self, "trace_owner",
                                                           "engine")}))}
        record_event("kv_import", cat="serve", uid=bundle.uid, slot=slot, pages=n,
                     adopted=sum(reused),
                     **({} if trace_id is None else {"trace_id": trace_id}),
                     **self._pool_occupancy())
        self._publish_pool_gauges()
        return True

    def release_sequence(self, uid: int, reason: str = "migrated") -> None:
        """Drop an admitted sequence without finishing it (its pages are
        freed): the source side of a migration, after the import
        succeeded elsewhere."""
        seq = self._find_slotted(uid)
        self.allocator.free(seq.pages)
        self._page_table[seq.slot, :] = self.block.trash_page
        self._slots[seq.slot] = None
        seq.slot, seq.pages = -1, []
        m = self._req_meta.pop(uid, None)
        if m is not None:
            end_span(m["span"], released=reason, generated=m["n"])
        self._publish_pool_gauges()
        logger.info(f"serving: released uid={uid} ({reason})")

    # -- tiered KV cache: spill to host RAM and restore ------------------------
    def _capture_evicted_page(self, page: int, key: Any) -> bool:
        """``BlockAllocator.spill_hook``: queue an evicted prefix page for
        the host tier (bounded by ``spill_inflight``); the allocator pins
        it until :meth:`_drain_spills` has copied it out."""
        tier = self.kv_tier
        if tier is None or key is None:
            return False
        if len(self._pending_spills) >= tier.config.spill_inflight:
            tier.note_capture_dropped()
            return False
        if tier.has(key) or key in self._pending_spill_keys:
            # the same chain key is the same bytes: held or queued already
            return False
        self._pending_spills.append((page, key))
        self._pending_spill_keys.add(key)
        return True

    def _drain_spills(self) -> None:
        """Copy the pending captures to the host in one batched gather into
        pinned memory (at a step boundary, no program in flight), stamp
        each page's CRC32, insert into the host LRU and release the pins."""
        if not self._pending_spills:
            return
        from ...serving.kv_tier import batch_page_crcs, page_slices

        pend, self._pending_spills = self._pending_spills, []
        self._pending_spill_keys = set()
        t0 = time.perf_counter()
        # the JAX engine's parts for this work (one gather program per
        # power-of-two row count there), announced as it announces them
        self._step_parts.add(("kv_spill", _pow2(len(pend))))
        sentinel_expect_recompile("kv_tier_spill")
        arrays = paged_gather_pages(self._pools, [p for p, _ in pend])
        crcs = batch_page_crcs(arrays)
        for j, (page, key) in enumerate(pend):
            self.kv_tier.insert(key, page_slices(arrays, j), crcs[j])
            self.allocator.release_spill_pin(page)
        self.kv_tier.note_spill(len(pend), time.perf_counter() - t0)

    def flush_spills(self) -> None:
        """Commit the pending spills now (the engine otherwise drains them
        at the next step boundary)."""
        self._drain_spills()

    def _current_match(self, seq: SequenceState):
        """Memoized device prefix match of a queued sequence: walked again
        only when the registry changed, resumed from the memo's end when
        only registrations happened."""
        if seq.match_gen != self.allocator.generation:
            resume = (seq.cached_match
                      if seq.match_evict_gen == self.allocator.evict_generation else None)
            seq.cached_match = self.prefix_cache.match(seq.tokens, resume=resume)
            seq.match_gen = self.allocator.generation
            seq.match_evict_gen = self.allocator.evict_generation
        return seq.cached_match

    def _tier_restore(self, tokens: List[int], shared: List[int], keys: List[Any],
                      park: bool = False) -> Tuple[List[int], List[Any]]:
        """Extend a device prefix match with host-tier pages: walk the
        chain keys on into the tier, allocate pages, scatter the restored
        KV into them (one pinned staging buffer, one copy per leaf) and
        register them, from then on device hits.  Returns new ``(shared,
        keys)``; restored pages arrive referenced, as the claimed matches
        do.  ``park`` (the prefetch): the references are dropped
        at once, the pages left registered at the LRU's MRU end, spending
        only truly free pages within the LRU cap."""
        tier = self.kv_tier
        ps = self.block.page_size
        n_full = len(tokens) // ps
        if tier is None or len(shared) >= n_full:
            return shared, keys
        host_keys = self.prefix_cache.host_extend(tokens, keys, tier)
        # a miss (admissions only: the prefetch re-walks the queue head
        # every step): the walk needed pages the tier does not hold
        missed = len(shared) + len(host_keys) < n_full
        if not host_keys:
            if missed and not park:
                tier.note_miss()
            return shared, keys
        if not park:
            # an admission that cannot fit whatever it restores would only
            # churn restore -> block -> park -> trim every step
            n_total = -(-len(tokens) // ps)
            if n_total - len(shared) + 1 > self.allocator.free_pages:
                return shared, keys
        cap = self.allocator.free_pages
        if park:
            cap = min(self.allocator.uncached_free_pages,
                      (self.allocator.cache_cap - self.allocator.lru_pages
                       if self.allocator.cache_cap > 0 else cap))
        if cap <= 0:
            return shared, keys
        entries = []
        for k in host_keys[:cap]:
            e = tier.get(k)  # CRC-verified; a corrupt page ends the chain
            if e is None:
                break
            entries.append(e)
        if len(entries) < min(len(host_keys), cap):
            missed = True
        if missed and not park:
            tier.note_miss()
        if not entries:
            return shared, keys
        host_keys = host_keys[:len(entries)]
        t0 = time.perf_counter()
        fresh = self.allocator.alloc(len(entries))
        self._step_parts.add(("kv_restore", _pow2(len(fresh))))
        sentinel_expect_recompile("kv_tier_restore")
        arrays = {}
        for name, first in entries[0].items():
            shape = (first.shape[0], len(entries)) + tuple(first.shape[2:])
            arrays[name] = torch.cat([e[name] for e in entries], dim=1,
                                     out=host_buffer(shape, first.dtype, self.device))
        paged_scatter_pages(self._pools, fresh, arrays)
        for p, k in zip(fresh, host_keys):
            self.allocator.register(p, k)
        tier.note_restore(len(entries), time.perf_counter() - t0)
        if park:  # parked, registered: the next admission maps them
            self.allocator.free(fresh)
        return shared + fresh, keys + host_keys

    def _prefetch_restores(self) -> None:
        """Restore the host-held prefixes of the queue's head requests
        into the pool (parked in the LRU) ahead of their admission: once
        per step, after the step's programs have returned."""
        tier = self.kv_tier
        if tier is None or not self._queue or tier.config.prefetch_requests <= 0:
            return
        heads = sorted(self._queue, key=lambda s: (s.priority, s.enqueue_order))
        for seq in heads[:tier.config.prefetch_requests]:
            shared, keys = self._current_match(seq)
            self._tier_restore(seq.tokens, shared, keys, park=True)

    def _register_pages(self, seq: SequenceState) -> None:
        """Offer every fully written, not yet registered page of ``seq``
        to the prefix-cache registry (first writer wins).  Called after
        each program that writes KV, before a retire can free the pages:
        a registered page freed later parks in the LRU, content intact."""
        if self.prefix_cache is None:
            return
        full = seq.prefilled // self.block.page_size
        if full <= seq.registered_upto:
            return
        seq.page_keys = self.prefix_cache.page_keys(seq.tokens, full, seq.page_keys)
        for j in range(seq.registered_upto, full):
            self.allocator.register(seq.pages[j], seq.page_keys[j])
        seq.registered_upto = full

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
        when pages free up (with the cache on, mostly a lookup of the
        pages it registered)."""
        self.allocator.free(seq.pages)
        self._page_table[seq.slot, :] = self.block.trash_page
        self._slots[seq.slot] = None
        seq.slot, seq.pages, seq.prefilled = -1, [], 0
        seq.page_keys, seq.registered_upto, seq.decode_entry = [], 0, False
        seq.cached_match, seq.match_gen, seq.match_evict_gen = None, -1, -1
        seq.queued_at = time.perf_counter()
        self._queue.insert(0, seq)
        self._stats["preemptions"] += 1
        self._m_preemptions.inc()
        tr = self._reqtrace(seq)
        if tr is not None:
            # back to queue_wait; the re-run prefill ledgers as recompute
            tr.note_preempt(getattr(self, "trace_owner", "engine"), seq.queued_at)
        occ = self._pool_occupancy()
        record_event("preempt", cat="serve", uid=seq.uid, prefix_tokens=seq.length,
                     **({} if seq.trace_id is None else {"trace_id": seq.trace_id}),
                     **occ)
        logger.info(
            f"serving: preempted uid={seq.uid} (prefix {seq.length} tokens) "
            f"under KV-pool pressure: {occ['pages_used']} pages used, "
            f"{occ['pages_free']} free ({occ['pages_pinned']} of them "
            f"prefix-cache pinned) of {self.block.num_pages}")

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
            shared: List[int] = []
            keys: List[Any] = []
            if self.prefix_cache is not None:
                shared, keys = self._current_match(seq)
                # claim the matched pages (+1 ref) before any allocation:
                # the restore's alloc and this admission's own must never
                # evict a page this sequence is about to map
                for p in shared:
                    self.allocator.share(p)
                # host-tier pages past the device hit come back restored,
                # registered and referenced, as the claims above
                shared, keys = self._tier_restore(seq.tokens, shared, keys)
            n_total = -(-seq.length // ps)
            m = len(shared)
            # a fully cached (page-aligned) prompt: its last cached page is
            # replaced by a private copy the decode program writes into
            full_hit = m > 0 and m * ps >= seq.length
            need_new = n_total - m + (1 if full_hit else 0)
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
                if shared:
                    # blocked: the claims go back (parked, registered) and
                    # the next attempt maps them as plain device hits
                    self.allocator.free(shared)
                break  # head-of-line blocking
            self._queue.remove(seq)
            seq.cached_match, seq.match_gen, seq.match_evict_gen = None, -1, -1
            if seq.queued_at > 0.0:
                self._m_queue_wait_h.observe(time.perf_counter() - seq.queued_at)
            fresh = self.allocator.alloc(need_new)
            if full_hit:
                src, dst = shared[-1], fresh[-1]
                self._step_parts.add("copy_page")
                # the copy is queued before any program reads the page
                paged_copy_page(self._pools, src, dst)
                self.allocator.free([src])  # drop our ref on the original
                seq.pages = shared[:-1] + [dst]
                seq.prefilled = seq.length - 1
                seq.decode_entry = True
                self._stats["decode_entries"] += 1
            else:
                seq.pages = shared + fresh
                seq.prefilled = m * ps
            seq.page_keys = keys
            # matched pages are registered already; the copy stays private
            seq.registered_upto = n_total if full_hit else m
            if self.prefix_cache is not None:
                self.prefix_cache.count(m, seq.length // ps)
            self._stats["prefill_admitted_tokens"] += seq.length
            self._stats["prefix_hit_tokens"] += seq.prefilled
            self._stats["prefill_computed_tokens"] += seq.length - seq.prefilled
            self._m_admitted.inc(seq.length)
            self._m_hit_tokens.inc(seq.prefilled)
            self._m_computed.inc(seq.length - seq.prefilled)
            seq.slot = i
            seq.admit_order = next(self._admit_counter)
            self._page_table[i, :] = self.block.trash_page
            self._page_table[i, :len(seq.pages)] = seq.pages
            tr = self._reqtrace(seq)
            if tr is not None:
                # queue_wait closes here; "prefill" turns "recompute" after
                # a preemption or a re-dispatch
                tr.transition("prefill", getattr(self, "trace_owner", "engine"))
            record_event("admit", cat="serve", uid=seq.uid, slot=i, cache_hit_pages=m,
                         new_pages=len(fresh), full_hit=full_hit,
                         **({} if seq.trace_id is None else {"trace_id": seq.trace_id}),
                         **self._pool_occupancy())
            admitted.append(seq)
            self._slots[i] = seq
        self._publish_pool_gauges()
        return admitted

    def _emit_sampled(self, seq: SequenceState, logits: torch.Tensor,
                      out: Dict[int, Dict[str, Any]]) -> None:
        """Sample off prefix-end logits, append, record, maybe retire."""
        # dstpu-lint: allow[host-sync] a prefill's sampled token: the host scheduler appends
        # it and decides retirement, one copy of one row of logits a finished prefill (the
        # JAX engine pulls the same)
        tok = self._sample(seq, logits.float().cpu().numpy())
        seq.tokens.append(tok)
        self._note_tokens(seq)
        out[seq.uid] = {"tokens": [tok], "done": False}
        self._maybe_finish(seq, tok)
        if seq.done:
            out[seq.uid]["done"] = True
            out[seq.uid]["finish_reason"] = seq.finish_reason

    @staticmethod
    def _ready_to_decode(seq: SequenceState) -> bool:
        """KV written for tokens[0:length-1] and a token sampled off the
        prefix end: mid-chunked-prefill sequences do not decode.  A fully
        cached prompt (``decode_entry``) decodes at once: its first decode
        step writes the final prompt token's KV into its copied page and
        samples the first token."""
        return ((seq.generated > 0 or seq.decode_entry)
                and seq.prefilled >= seq.length - 1)

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
        self._spec_fallback_uids.discard(seq.uid)
        self._finish_request(seq)

    def _expire(self, seq: SequenceState, out: Dict[int, Dict[str, Any]]) -> None:
        """Retire one past-deadline sequence (queued or admitted) with
        ``finish_reason="deadline"``: its pages free at once, its request
        span closes, and the expiry counts as an SLO miss."""
        seq.finish_reason = "deadline"
        self._m_deadline.inc()
        slo_exemplar("deepspeed_tpu_serving_slo_deadline_exceeded_total",
                     seq.trace_id, uid=seq.uid, generated=seq.generated)
        record_event("deadline_expired", cat="serve", uid=seq.uid,
                     generated=seq.generated, priority=seq.priority,
                     **({} if seq.trace_id is None else {"trace_id": seq.trace_id}))
        if seq.slot >= 0:
            self._retire(seq)
        else:
            self.allocator.free(seq.pages)
            seq.pages, seq.done = [], True
            self._spec_fallback_uids.discard(seq.uid)
            self._finish_request(seq)
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
        self._step_parts.add(("prefill_chunk", C, int(prev.shape[0])))
        logits, self._pools = paged_prefill_chunk(
            self.cfg, self.params, self._pools, self._tensor(ids).long(),
            self._tensor(rows), self._tensor(np.ascontiguousarray(prev)), start, c_n)
        self._stats["prefill_chunk_calls"] += 1
        seq.prefilled = start + c_n
        self._register_pages(seq)
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
        self._step_parts.add(("prefill", bucket))
        with self._phase("prefill", self._m_prefill_h, uid=seq.uid, tokens=n,
                         bucket=bucket):
            logits, self._pools = paged_prefill(
                self.cfg, self.params, self._pools, self._tensor(ids).long(),
                self._tensor(rows), n)
            self._stats["prefill_calls"] += 1
            seq.prefilled = n
            self._register_pages(seq)
            self._emit_sampled(seq, logits, out)

    # -- the engine step -----------------------------------------------------
    def step(self) -> Dict[int, Dict[str, Any]]:
        """Admit + prefill new sequences, decode one token for running ones.

        Returns {uid: {"tokens": [newly generated], "done": bool}};
        finished records also carry ``"finish_reason"``
        ("length"/"eos"/"max_seq_len"/"deadline").  Past-deadline requests
        expire first, at the step boundary, before admission.

        A step that raises dumps the flight recorder (when one is installed,
        or on a memory exhaustion) and the exception propagates; a step's
        program parts go to the recompile sentinel; every
        ``timeline_every_n_steps`` decode steps (or once after
        ``force_timeline_capture``) the step runs under the profiler."""
        self._step_parts = set()
        try:
            if self._timeline.should_capture(self._decode_steps):
                with self._timeline.capture(self._decode_steps):
                    out = self._step_impl()
            else:
                out = self._step_impl()
            # the host tier's prefetch for the queue head, after the step's
            # programs have returned
            self._prefetch_restores()
        except Exception as e:
            dump_on_exception("engine_v2.step", e)
            raise
        if self._step_parts and self._sentinel is not None:
            self._sentinel.observe_step(frozenset(self._step_parts),
                                        step=self._decode_steps)
        return out

    def force_timeline_capture(self) -> None:
        """Capture the NEXT ``step()`` under the profiler, whatever the
        cadence."""
        self._timeline.force_next()

    def timeline_record(self) -> Optional[Dict[str, Any]]:
        """The last completed step-time record, or None."""
        return self._timeline.last_record()

    def _step_impl(self) -> Dict[int, Dict[str, Any]]:
        out: Dict[int, Dict[str, Any]] = {}
        ps = self.block.page_size
        # step boundary: last step's captured evictions go to the host tier
        self._drain_spills()
        self._expire_deadlines(out)
        admitted = self._admit()
        self._m_queue.set(len(self._queue))
        self._m_occupancy.set(sum(1 for s in self._slots if s is not None)
                              / max(1, self.block.max_seqs))
        t0 = time.perf_counter()
        if self._chunk:
            # one chunk per pending-prefill sequence per step (a cached
            # prefix's first chunk starts at its end); decode for ready
            # sequences runs below in the same step
            pending = [s for s in self._slots
                       if s is not None and not self._ready_to_decode(s)]
            for seq in pending:
                start = seq.prefilled  # page-aligned: chunk % ps == 0
                c_n = min(self._chunk, seq.length - start)
                with self._phase("prefill", self._m_prefill_h, uid=seq.uid,
                                 start=start, tokens=c_n):
                    logits = self._run_prefill_chunk(seq, start, c_n, self._chunk)
                    if seq.prefilled >= seq.length:
                        self._emit_sampled(seq, logits, out)
        else:
            for seq in admitted:
                if seq.decode_entry:
                    continue  # fully cached: enters through the decode program
                if seq.prefilled:
                    # cached prefix: the suffix through the start-offset
                    # program, bucketed like a whole prompt
                    n_suf = seq.length - seq.prefilled
                    with self._phase("prefill", self._m_prefill_h, uid=seq.uid,
                                     start=seq.prefilled, tokens=n_suf):
                        logits = self._run_prefill_chunk(seq, seq.prefilled, n_suf,
                                                         self._bucket(n_suf))
                        self._emit_sampled(seq, logits, out)
                    continue
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
                    self._m_spec_fallback.inc()
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
        self._sync_cache_counters()
        return out

    def _dispatch(self, key, k: int, phase: str, hist, **attrs) -> np.ndarray:
        """Run a decode-phase program over the staged inputs inside its
        telemetry ``phase``: one model invocation, one host read; ``k``
        decode bodies run."""
        t0 = time.perf_counter()
        with self._phase(phase, hist, **attrs):
            res = self._programs.run(key)
        self._stats["decode_seconds"] += time.perf_counter() - t0
        self._stats["decode_device_steps"] += k
        self._dstats["decode_model_invocations"] += 1
        self._dstats["decode_host_syncs"] += 1
        self._m_invocations.inc()
        self._m_host_syncs.inc()
        return res

    def _decode_step(self, seqs: List[SequenceState], out: Dict[int, Dict[str, Any]]) -> None:
        """One token for each of ``seqs`` through the decode program."""
        last, pos, act, temps, sids = self._decode_inputs(seqs)
        self._programs.stage(last=last, pos=pos, table=self._page_table, act=act,
                             temps=temps, sids=sids)
        self._decode_steps += 1
        self._step_parts.add("decode")
        tokens = self._dispatch("decode", 1, "decode", self._m_decode_h, batch=len(seqs))
        self._dstats["decode_tokens"] += len(seqs)
        self._m_gen_tokens.inc(len(seqs))
        self._m_tokens_per_dispatch.observe(len(seqs))
        for seq in seqs:
            tok = int(tokens[seq.slot])
            seq.tokens.append(tok)
            self._note_tokens(seq)
            seq.prefilled = seq.length - 1  # the step wrote the consumed token's KV
            if seq.prefilled % self.block.page_size == 0:
                self._register_pages(seq)  # the write completed a page
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
            self._m_horizon_shrink.inc()
            record_event("horizon_shrink", cat="serve", horizon=k,
                         configured=self._horizon, **self._pool_occupancy())
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
        self._decode_steps += 1
        self._step_parts.add(("multi_decode", k))
        warm = k in self._warm_horizons
        self._warm_horizons.add(k)
        t0 = time.perf_counter()
        res = self._dispatch(("multi", k), k, "multi_decode", self._m_decode_h,
                             batch=len(seqs), horizon=k)
        # the program always runs k steps (finished rows run masked), so the
        # time per step is wall / k
        per_step = (time.perf_counter() - t0) / k
        if warm:
            self._tpot_ema = (per_step if self._tpot_ema is None
                              else 0.5 * self._tpot_ema + 0.5 * per_step)
        toks, produced = res[:B * k].reshape(B, k), res[B * k:]
        total = int(produced.sum())
        self._dstats["decode_tokens"] += total
        self._m_gen_tokens.inc(total)
        self._m_tokens_per_dispatch.observe(total)
        for seq in seqs:
            rec = out.setdefault(seq.uid, {"tokens": [], "done": False})
            reason = ""
            for j in range(int(produced[seq.slot])):
                tok = int(toks[seq.slot, j])
                seq.tokens.append(tok)
                rec["tokens"].append(tok)
                # token j landed ~(j + 1) device steps into the dispatch
                self._note_tokens(seq, t=t0 + (j + 1) * per_step)
                reason = self._finish_reason_for(seq, tok)
                if reason:
                    break  # the program stopped the row here
            # KV is written for every token consumed; the last one emitted
            # is the pending one, as after a single step
            seq.prefilled = seq.length - 1
            self._register_pages(seq)
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
        with span("spec_propose", cat="serve", seqs=len(seqs)):
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
                    # drafts may be rejected: reserve only truly free pages,
                    # and preempt nobody for them
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
                self._m_spec_proposed.inc(len(d))
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
        self._step_parts.add(("verify", W))
        greedy = self._dispatch("verify", 0, "spec_verify", self._m_spec_verify_h,
                                batch=len(seqs), width=W).reshape(B, W)
        self._dstats["spec_verify_calls"] += 1

        rollback = 0
        for seq in seqs:
            accepted, bonus = longest_accepted(drafts[seq.uid], greedy[seq.slot])
            base_len = seq.length
            self._dstats["spec_accepted_tokens"] += len(accepted)
            self._m_spec_accepted.inc(len(accepted))
            rec = out.setdefault(seq.uid, {"tokens": [], "done": False})
            emitted = 0
            for tok in accepted + [bonus]:
                seq.tokens.append(tok)
                rec["tokens"].append(tok)
                emitted += 1
                self._note_tokens(seq)
                if self._finish_reason_for(seq, tok):
                    break  # accepted tokens past a finish boundary are dropped
            self._dstats["decode_tokens"] += emitted
            self._m_gen_tokens.inc(emitted)
            self._m_spec_tps.observe(emitted)
            # KV is valid through the accepted region; the bonus token is
            # the pending one, as after a plain step
            seq.prefilled = min(seq.length - 1, base_len + len(accepted))
            self._register_pages(seq)
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
        if rollback:
            self._dstats["spec_rollback_pages"] += rollback
            self._m_spec_rollback.inc(rollback)
            record_event("spec_rollback", cat="serve", pages=rollback, seqs=len(seqs))
        prop = self._dstats["spec_proposed_tokens"]
        if prop:
            self._m_spec_rate.set(self._dstats["spec_accepted_tokens"] / prop)
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
