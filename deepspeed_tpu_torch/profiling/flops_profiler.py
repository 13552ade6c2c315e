"""FLOPs profiler (``deepspeed_tpu/profiling/flops_profiler.py``).

The JAX package asks XLA's cost analysis for the FLOPs of the compiled
micro-step, lowered apart from the step that runs.  PyTorch has no
compiled program to ask, so the port prices one micro-step by running it
apart too (a forward and backward on the profiled step's first
micro-batch, its gradients dropped; the step itself runs as it would
unprofiled, bit for bit).  Apart, because ``FlopCounterMode`` runs every
op it has no FLOP formula for through that op's decomposition
(``aten.silu_backward`` of the SwiGLU MLP among them), which rounds
otherwise: around the step's own micro-steps it would change the step's
gradients.  It counts in two parts:

* what PyTorch dispatches, with ``torch.utils.flop_counter.FlopCounterMode``
  (matrix products, convolutions and PyTorch's own attention: 2 FLOPs a
  multiply-add; elementwise work counts 0);
* what each hand-written kernel reports.  ``FlopCounterMode`` cannot see a
  kernel launched through ``ctypes``, so each wrapper that runs matrix
  products calls :func:`report_kernel_flops` with the operation count of
  its bound in ``PERF.md`` §6, from its shapes (no host sync):

  - flash A, A', A'' and evoformer E, E', E'': ``4 D``, ``6 D`` and ``8 D``
    a computed (query, key) pair (``flash_attention.FLOPS_PER_PAIR``).  A
    causal kernel counts only the pairs at or below the diagonal, where
    the plain version, and so ``FlopCounterMode`` on the CPU, prices the
    whole score matrix.  The backward kernels each recompute S and dP,
    so A' + A'' (and E' + E'') count ``4 D`` a pair more than the plain
    backward;
  - block-sparse S: ``4 D`` a pair of the layout's visible blocks, a
    diagonal block counting half under causal;
  - grouped G, G', G'': ``2 P H F``, every row of ``x`` (the padding and
    the blocks past ``n_used`` too: the count lives on the card);
  - weight-quantized W: ``2 M K N``.

  Paged decode B runs in serving only, which the profiler does not price,
  and reports none; Adam C and the int8 (de)quantizers do no products.

On the CPU the wrappers take their plain versions, which ``FlopCounterMode``
counts, and no kernel reports.  ``per_module_breakdown`` prices each part
of a transformer on ``meta`` tensors (no memory, no launch) with the plain
attention, as the JAX package lowers each part on the CPU.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..utils.logging import logger

#: the open kernel-FLOP accumulators (one per active count)
_KERNEL_COUNTS: List[Dict[str, float]] = []


def report_kernel_flops(name: str, flops) -> None:
    """Called by a kernel's wrapper at each launch: adds ``flops`` (a
    number, or a function giving it, called only while a count is open)
    under ``name`` to every open :func:`count_flops`."""
    if not _KERNEL_COUNTS:
        return
    n = float(flops() if callable(flops) else flops)
    for acc in _KERNEL_COUNTS:
        acc[name] = acc.get(name, 0.0) + n


def attention_pairs(B: int, NH: int, Sq: int, Sk: int, causal: bool, q_offset: int = 0,
                    valid_k: Optional[int] = None) -> int:
    """(query, key) pairs an attention kernel computes: query i sits at
    ``q_offset + i``, keys at or past ``valid_k`` are masked, and a causal
    query sees the keys at or before its position."""
    vk = Sk if valid_k is None else int(valid_k)
    if not causal:
        return B * NH * Sq * vk
    a = q_offset + 1  # keys the first query sees
    n1 = min(max(vk - a + 1, 0), Sq)  # rows that see fewer than vk keys
    seen = n1 * a + n1 * (n1 - 1) // 2 + (Sq - n1) * vk
    return B * NH * seen


class FlopCount:
    """The result of one :func:`count_flops`: ``torch`` (FlopCounterMode's
    total), ``kernels`` ({wrapper: FLOPs}) and ``total``."""

    def __init__(self):
        self.torch = 0.0
        self.kernels: Dict[str, float] = {}

    @property
    def kernel_total(self) -> float:
        return float(sum(self.kernels.values()))

    @property
    def total(self) -> float:
        return float(self.torch) + self.kernel_total

    def as_dict(self) -> dict:
        return {"torch_flops": float(self.torch), "kernel_flops": dict(self.kernels),
                "kernel_total": self.kernel_total, "total": self.total}


@contextlib.contextmanager
def count_flops():
    """Count the FLOPs of the work inside: FlopCounterMode's part and the
    kernels' reported part, in the yielded :class:`FlopCount`."""
    out = FlopCount()
    acc: Dict[str, float] = {}
    mode = FlopCounterMode(display=False)
    _KERNEL_COUNTS.append(acc)
    try:
        with mode:
            yield out
    finally:
        _KERNEL_COUNTS.remove(acc)
        out.torch = float(mode.get_total_flops())
        out.kernels = acc


def count_params(params: Any) -> int:
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return 0


def _meta(tree):
    """A ``ParamTree``'s structure on ``meta`` tensors (shapes and dtypes
    only)."""
    return tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"))


def per_module_breakdown(cfg, params, batch_size: int = 1, seq_len: Optional[int] = None,
                         measure: bool = False) -> list:
    """Per-module cost rows ``{module, params, flops, macs, bytes, pct}`` of
    a transformer-family model: the embedding, each layer's attention and
    MLP, the final norm and the LM head.  FLOPs are FlopCounterMode's count
    of each part run on ``meta`` tensors (the plain attention, the KV heads
    repeated, as the JAX package prices it on the CPU); ``bytes`` are the
    part's weights and its input and output activations, each moved once.
    Every layer has the same shapes, so one layer's rows are priced once
    and repeated.  ``measure`` is accepted for the JAX signature; meta
    tensors carry no time, so no latency column is added."""
    from ..models import transformer as T

    del measure
    seq = int(seq_len or cfg.max_seq_len)
    p = _meta(params)
    cdtype = p.embed.tok.dtype
    ids = torch.zeros((batch_size, seq), dtype=torch.int64, device="meta")
    x = torch.empty((batch_size, seq, cfg.hidden_size), dtype=cdtype, device="meta")
    positions = torch.arange(seq, device="meta").expand(batch_size, seq)
    layer0 = p.layers[0]
    act_bytes = x.numel() * x.element_size()

    def embed_fn():
        out = p.embed.tok[ids]
        if cfg.position == "learned":
            out = out + p.embed.pos[:seq][None]
        return out

    def attn_fn():
        q, k, v = T.attn_qkv(cfg, layer0, x, positions)
        rep = cfg.n_heads // cfg.kv_heads
        a = T.xla_attention(q, T._repeat_kv(k, rep), T._repeat_kv(v, rep), cfg.causal)
        out = a.reshape(batch_size, seq, cfg.n_heads * cfg.head_dim) @ layer0.attn.wo
        return out + layer0.attn.bo if cfg.use_bias else out

    def mlp_fn():
        return T.mlp_block(cfg, layer0, x)[0]

    def norm_fn():
        if "final_norm" not in p:  # post-norm models end inside the block
            return x
        return T._norm(x, p.final_norm.scale, p.final_norm.get("bias"), cfg.norm,
                       cfg.norm_eps)

    def head_fn():
        return T.logits_fn(cfg, p, x)

    attn_params = count_params(layer0.attn)
    layer_params = count_params(layer0)

    def nbytes(t):
        return count_params(t) * cdtype.itemsize if t is not None else 0

    logits_bytes = batch_size * seq * cfg.vocab_size * cdtype.itemsize
    parts = {
        "embed": (embed_fn, count_params(p.embed), nbytes(p.embed) + act_bytes),
        "attn": (attn_fn, attn_params, nbytes(layer0.attn) + 2 * act_bytes),
        "mlp": (mlp_fn, layer_params - attn_params,
                nbytes(layer0) - nbytes(layer0.attn) + 2 * act_bytes),
        "final_norm": (norm_fn, count_params(p.get("final_norm")),
                       nbytes(p.get("final_norm")) + 2 * act_bytes),
        "lm_head": (head_fn, 0 if cfg.tie_embeddings else count_params(p.get("lm_head")),
                    (nbytes(p.embed.tok) if cfg.tie_embeddings else nbytes(p.get("lm_head")))
                    + act_bytes + logits_bytes),
    }
    base = {}
    with torch.no_grad():
        for name, (fn, n_params, n_bytes) in parts.items():
            mode = FlopCounterMode(display=False)
            with mode:
                fn()
            flops = float(mode.get_total_flops())
            base[name] = {"module": name, "params": int(n_params), "flops": flops,
                          "macs": flops / 2.0, "bytes": float(n_bytes)}
    rows = [base["embed"]]
    for i in range(cfg.n_layers):
        rows.append(dict(base["attn"], module=f"layers.{i}.attn"))
        rows.append(dict(base["mlp"], module=f"layers.{i}.mlp"))
    rows.append(base["final_norm"])
    rows.append(base["lm_head"])
    total = sum(r["flops"] for r in rows) or 1.0
    for r in rows:
        r["pct"] = 100.0 * r["flops"] / total
    return rows


def format_module_table(rows: list) -> str:
    """The breakdown as the reference prints its per-module table: name,
    params, MACs, bytes, share of the FLOPs."""
    hdr = f"{'module':<20} {'params':>12} {'MACs':>14} {'bytes':>12} {'%flops':>7}"
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(f"{r['module']:<20} {r['params']:>12,} {r['macs']:>14,.0f} "
                     f"{r['bytes']:>12,.0f} {r['pct']:>6.1f}%"
                     + (f" {r['latency_ms']:.2f}ms" if "latency_ms" in r else ""))
    return "\n".join(lines)


#: the gauges a profile lands on the telemetry registry (the JAX names)
PROFILE_GAUGES = {
    "deepspeed_tpu_profile_params": "parameter count from the flops profiler",
    "deepspeed_tpu_profile_flops_per_micro_step":
        "FLOPs of one micro-step: FlopCounterMode's count plus the kernels' reported FLOPs",
    "deepspeed_tpu_profile_achieved_tflops": "achieved TFLOPS over the profiled step",
}


class FlopsProfiler:
    """The engine's plugin (the reference's start/stop/print): the train
    step that starts at ``profile_step`` is profiled.  :meth:`stop_profile_
    maybe` waits for the card once to time the step, then prices one
    micro-step (forward and backward; the optimizer is outside, as the JAX
    package prices its ``_micro_step``) on the step's first micro-batch."""

    def __init__(self, engine, config):
        # a proxy: the engine holds its profiler, and a strong reference
        # back would keep a closed engine's tensors alive until the
        # cycle collector runs
        self.engine = weakref.proxy(engine)
        self.config = config
        self.profile_step = config.profile_step
        self._active = False
        self._t0 = 0.0
        self._last_batch = None
        self._stacked = True
        self.count: Optional[FlopCount] = None
        self.micro_steps = 0
        self.flops = 0.0
        self.duration = 0.0
        self.last_profile: Optional[dict] = None

    @property
    def active(self) -> bool:
        return self._active

    def start_profile_maybe(self, global_step: int, batch: Any = None,
                            stacked: bool = True) -> None:
        """``global_step`` is the engine's count before the step; the step
        that starts at ``profile_step`` is profiled (the JAX package's
        cadence).  ``batch``: the step's batch, gas-stacked unless
        ``stacked`` is False (one micro-batch of ``forward``)."""
        if batch is not None:
            self._last_batch, self._stacked = batch, stacked
        if global_step == self.profile_step and not self._active:
            self._active = True
            self._t0 = time.perf_counter()

    def stop_profile_maybe(self, global_step: int) -> None:
        if self._active and global_step >= self.profile_step:
            dev = getattr(self.engine, "device", None)
            if dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.duration = time.perf_counter() - self._t0
            self._active = False
            self.micro_steps = int(getattr(self.engine.config, "gradient_accumulation_steps",
                                           1) or 1)
            self.count = self.price_micro_step()
            self.print_profile()

    def price_micro_step(self) -> Optional[FlopCount]:
        """The FLOPs of one micro-step on the last batch's first micro-batch,
        run apart from the training step (its gradients dropped, no state
        touched)."""
        if self._last_batch is None:
            return None
        from ..runtime.dataloader import to_device
        from ..runtime.engine import _index

        eng = self.engine
        micro = _index(self._last_batch, 0) if self._stacked else self._last_batch
        with count_flops() as c:
            grads = eng._micro_grads(to_device(micro, eng.device))
        del grads
        return c

    def get_total_flops(self) -> float:
        """FLOPs of one micro-step of the profiled step (0 before one ran)."""
        if self.count is None:
            return 0.0
        self.flops = self.count.total
        return self.flops

    def get_total_params(self) -> int:
        return count_params(self.engine.state.params)

    def print_profile(self) -> None:
        params = self.get_total_params()
        flops = self.get_total_flops()
        tput = flops * self.micro_steps / self.duration if self.duration > 0 else 0.0
        parts = self.count.as_dict() if self.count is not None else {}
        self.last_profile = {
            "step": self.profile_step, "params": params, "flops_per_micro_step": flops,
            "torch_flops_per_micro_step": parts.get("torch_flops", 0.0),
            "kernel_flops_per_micro_step": parts.get("kernel_flops", {}),
            "micro_steps": self.micro_steps, "step_seconds": self.duration,
            "achieved_tflops": tput / 1e12}
        torch_part = self.last_profile["torch_flops_per_micro_step"]
        logger.info(f"flops profiler: params={params / 1e6:.2f}M "
                    f"flops/micro-step={flops / 1e9:.2f}G (torch {torch_part / 1e9:.2f}G, "
                    f"kernels {(flops - torch_part) / 1e9:.2f}G) "
                    f"step_time={self.duration * 1e3:.1f}ms "
                    f"achieved={tput / 1e12:.2f} TFLOPS")
        self._publish(params, flops, tput)
        if getattr(self.config, "module_depth", -1) != 0:
            self.print_model_profile()

    def _publish(self, params: int, flops: float, tput: float) -> None:
        """The one-shot profile on the telemetry registry too (the log line
        scrolls away; the gauges last to the next export)."""
        from ..telemetry.registry import get_registry

        reg = get_registry()
        vals = (params, flops, tput / 1e12)
        for (name, help_), v in zip(PROFILE_GAUGES.items(), vals):
            reg.gauge(name, help_).set(v)

    def print_model_profile(self) -> None:
        """The per-module breakdown, when the model carries a transformer
        config."""
        cfg = getattr(self.engine.model, "config", None)
        if cfg is None or not hasattr(cfg, "n_layers"):
            return
        seq, bs = None, 1
        leaf = self._last_batch
        if isinstance(leaf, (list, tuple)):
            leaf = leaf[0]
        if isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        if hasattr(leaf, "shape") and len(leaf.shape) >= 2:
            seq, bs = int(leaf.shape[-1]), int(leaf.shape[-2])
        try:
            rows = per_module_breakdown(cfg, self.engine._compute, batch_size=bs, seq_len=seq)
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
            logger.warning(f"per-module profile failed: {e}")
            return
        self.last_profile["modules"] = rows
        logger.info("per-module profile:\n" + format_module_table(rows))
