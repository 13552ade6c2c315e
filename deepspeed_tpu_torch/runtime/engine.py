"""The training engine — the single-device subset of ``deepspeed_tpu/
runtime/engine.py``.

The engine owns a :class:`TrainState`: the fp32 master parameters, the
optimizer state, a gradient-accumulation buffer in ``grad_accum_dtype``,
the fp16 loss-scale state and the step counters.  One optimizer step:

  * the compute-dtype copy of the master (``_compute_params``) is refreshed
    once per step (params only change at the boundary) and is what autograd
    differentiates: the backward runs through bf16 (or fp16) leaves and the
    gradients are cast to ``grad_accum_dtype`` afterwards, as the JAX
    engine differentiates its cast copy (``engine.py:896-997``);
  * fp16 scales the loss in fp32 before the backward;
  * at the boundary the gradients are divided by ``gas`` (times the loss
    scale), their global norm is taken before clipping, and the optimizer
    updates the master — through kernel C in place when the optimizer is
    the fused one (``direct_update``), else by adding the updates;
  * an fp16 step whose gradients overflow leaves params and moments
    untouched, still updates the loss scale, and counts as skipped; the
    schedule is indexed by the steps actually taken.

``train_batch`` returns the loss as a device tensor.  A bf16 or fp32 step
makes no host sync: the learning rate, the step count, the norm and the
loss scale stay on the device.  An fp16 step syncs once, on its overflow
verdict, to decide whether the optimizer runs.

Offload (``zero_optimization``; the JAX engine's ``offload_optimizer`` /
``zenflow`` / ``offload_param`` paths):

  * ``offload_optimizer`` (``cpu`` or ``nvme``), ``zenflow``, or
    ``super_offload``: the fp32 master and the moments live in host RAM
    (``zero/offload.py``, ``superoffload/``, ``zenflow/``).  The card holds
    only the compute-dtype leaves autograd differentiates — they are
    ``TrainState.params`` — with no fp32 master and an empty
    ``opt_state``; at initialisation each leaf's fp32 copy moves to the host
    and its device copy is freed, one leaf at a time.  The boundary takes
    the global norm of the gradients on the card (each leaf's fp32 sum of
    squares, summed in float64, as ``scale_and_clip`` sums), then streams
    them through ``zero/boundary.py``: fp32 gradients down in bounded
    buckets, the host update as each bucket lands, compute-dtype params
    back into the live leaves, the next forward ordered after the last
    copy.  The learning rate and the norm cost one host sync each.
    fp16's overflow verdict is taken over the device copy of the
    gradients (the host copy is streamed and never whole); an overflowing
    step touches no host state.
  * ``offload_param`` alone: the fp32 master lives in (pinned) host memory
    and the moments stay on the card.  At the boundary each leaf streams
    up into a device buffer, takes the optimizer there (kernel C for the
    fused one, in place), refreshes its compute copy and streams back.
    With ``offload_optimizer`` also set it is subsumed, as in the JAX
    engine.

No path moves the master back to the card when host memory is short: an
allocation that fails raises.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``, the JAX engine's
signatures) go through ``checkpoint/saving.py``: the consolidated layout
under the verified commit of ``resilience/commit.py``, streamed one leaf
(or layer slice) at a time from and into the live buffers, wherever they
live.  A load is followed by the step's own refresh of the compute copy,
so the next step is the unbroken run's.  Data: ``training_data`` (or
:meth:`deepspeed_io`) builds a :class:`DeepSpeedDataLoader`, and
``train_batch()`` with no batch draws ``gas`` micro-batches from it.

Telemetry (the ``telemetry`` block, off by default): a
``telemetry.Telemetry`` bundle fed by every step — spans, the stall
watchdog, goodput, the recompile sentinel, the memory ledger, the
``deepspeed_tpu_train_*`` gauges and counters, MFU, the step timeline and,
with ``telemetry.numerics``, the numerics observatory.  The JAX engine
computes the numerics stats inside every fused step and pulls them at the
``steps_per_print`` boundary; this engine computes them only on the step
that ends at a boundary (off-boundary steps add no launch and no host
sync), keeps them on the device and copies them once, where the host
also fences the device so the window's wall time is real.  MFU is
``flops_per_token`` of the model's config times the window's tokens; a
model without ``n_layers`` leaves the gauge unset (there is no compiler
cost analysis to fall back on).  Resilience (the ``resilience`` block):
a preemption watcher whose request is honoured at the next step boundary
by an emergency save and ``PreemptionInterrupt`` (exit code 75), and
auto-resume from the newest verified tag at construction.

Monitors (``tensorboard``, ``wandb``, ``comet``, ``csv_monitor``:
``monitor.MonitorMaster``): each step writes ``Train/Samples/train_loss``
and ``Train/Samples/lr``, which costs one host sync (the loss and the
step count in one copy) and only with a writer on; at each
``steps_per_print`` boundary the telemetry registry's snapshot goes
through the writers too.  ``flops_profiler``: the step that starts at
``profile_step`` is timed (one fence) and one micro-step is priced apart
(``profiling.flops_profiler``).
"""

from __future__ import annotations

import dataclasses
import os
import time
import weakref
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device
from ..models.convert import adopt_params
from ..models.transformer import ParamTree
from ..telemetry.flight import dump_on_exception
from ..telemetry.numerics import fold_leaf_stats, leaf_index, leaf_stats
from ..telemetry.spans import record_event, span
from ..telemetry.tracing import _noop
from ..utils.logging import logger
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER,
                           SynchronizedWallClockTimer, ThroughputTimer)
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader, RepeatingLoader, to_device
from .zero.boundary import OffloadBoundary
from .zero.offload import clip_coefficient
from .lr_schedules import LRSchedulerShim, get_schedule
from .module import ModelSpec, as_model_spec
from .optimizers import build_optimizer
from .precision import (LossScaleState, cast_tree, check_overflow, clip_by_global_norm,
                        global_grad_norm, loss_scale_summary, update_loss_scale)

_ACC_DTYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """All mutable training state."""

    step: torch.Tensor  # optimizer steps taken (int32, on the device)
    micro_step: int  # micro-steps accumulated since the last boundary
    #: the fp32 master (on the host under offload_param); under
    #: offload_optimizer the compute-dtype leaves on the card
    params: ParamTree
    opt_state: Any  # () under offload_optimizer
    grad_acc: Optional[List[torch.Tensor]]  # grad_accum_dtype; None while empty
    loss_scale: Optional[LossScaleState]
    skipped_steps: torch.Tensor  # int32, on the device
    global_grad_norm: torch.Tensor  # fp32, from the last boundary


def _index(batch: Any, i: int) -> Any:
    """Micro-batch ``i`` of a batch whose leaves carry a leading gas dim."""
    if isinstance(batch, dict):
        return {k: _index(v, i) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_index(v, i) for v in batch)
    return batch[i]


def _batch_leaves(batch: Any):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _batch_leaves(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _batch_leaves(v)
    elif batch is not None:
        yield batch


def _is_int(leaf: Any) -> bool:
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return not dt.is_floating_point and not dt.is_complex and dt != torch.bool
    return dt is not None and np.issubdtype(dt, np.integer)


def _shape_signature(batch: Any) -> Tuple:
    """The batch's (shape, dtype) per leaf: the recompile sentinel's
    signature part for a training step (host metadata only)."""
    return tuple((tuple(getattr(l, "shape", ())), str(getattr(l, "dtype", type(l).__name__)))
                 for l in _batch_leaves(batch))


def stack_microbatches(micro_batches: List[Any]) -> Any:
    """Stack micro-batches on a new leading (gas) dim, leaf by leaf."""
    first = micro_batches[0]
    if isinstance(first, dict):
        return {k: stack_microbatches([m[k] for m in micro_batches]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_microbatches([m[i] for m in micro_batches])
                           for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(micro_batches)
    return torch.stack([torch.as_tensor(m) for m in micro_batches])


class DeepSpeedTPUEngine:
    def __init__(self, model: Any, config: Any, model_parameters: Any = None,
                 lr_scheduler: Any = None, client_optimizer: Any = None,
                 device: DeviceLike = None, seed: Optional[int] = None,
                 training_data: Any = None):
        self.device = resolve_device(device)
        self.config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        self.config.resolve_batch_size(1)
        self.model: ModelSpec = as_model_spec(model)
        self.compute_dtype = self.config.compute_dtype
        self.grad_accum_dtype = _ACC_DTYPES[self.config.gradient_accumulation_dtype]
        self.fp16_enabled = self.config.fp16.enabled

        if lr_scheduler is not None and not callable(lr_scheduler):
            raise TypeError("lr_scheduler must be a callable step -> lr schedule; "
                            f"got {type(lr_scheduler)}")
        base = float(self.config.optimizer.params.get("lr", 1e-3))
        self.lr_schedule = lr_scheduler if lr_scheduler is not None else get_schedule(
            self.config.scheduler.type, self.config.scheduler.params, base)
        self._client_optimizer = client_optimizer is not None
        if client_optimizer is not None:
            if not (callable(getattr(client_optimizer, "init", None))
                    and callable(getattr(client_optimizer, "update", None))):
                raise TypeError("optimizer must be a GradientTransformation (init, update) "
                                f"over lists of tensors; got {type(client_optimizer)}")
            self.optimizer = client_optimizer
        else:
            self.optimizer, _ = build_optimizer(
                self.config.optimizer.type, self.config.optimizer.params, self.lr_schedule)
        self.lr_scheduler = LRSchedulerShim(self.lr_schedule)

        # observability
        self.telemetry = None
        if self.config.telemetry.enabled:
            from ..telemetry import Telemetry

            self.telemetry = Telemetry(self.config.telemetry, loop="train", device=self.device)
            self._init_train_metrics()
            if self.telemetry.sentinel is not None:
                # compiles before this engine existed (kernel builds, other
                # engines' captures) are not its first step's
                self.telemetry.sentinel.expect_recompile("engine_construction")
        # timer sink: every phase timer stop() lands in the phase
        # histogram, making the registry the single sink for step metrics
        self.timers = SynchronizedWallClockTimer(
            sink=(self._observe_phase if self.telemetry is not None else None))
        self.tput_timer = ThroughputTimer(batch_size=self.config.train_batch_size or 1,
                                          steps_per_output=self.config.steps_per_print)
        c = self.config
        self.monitor = None
        if c.tensorboard.enabled or c.csv_monitor.enabled or c.wandb.enabled or c.comet.enabled:
            from ..monitor.monitor import MonitorMaster

            self.monitor = MonitorMaster(c)
        self.flops_profiler = None
        if c.flops_profiler.enabled:
            from ..profiling.flops_profiler import FlopsProfiler

            self.flops_profiler = FlopsProfiler(self, c.flops_profiler)
        self._training_data = training_data
        self.training_dataloader = (self.deepspeed_io(training_data)
                                    if training_data is not None else None)
        self._train_iter: Optional[RepeatingLoader] = None
        self._train_iter_src = None

        self.global_steps = 0
        self.micro_steps = 0
        self._cached_loss = None
        # True while forward() has written the accumulation buffer without
        # reaching a step() boundary (train_batch then drops it)
        self._acc_dirty = False
        zc = self.config.zero_config
        self.offload_optimizer = self._host_optimizer()
        self._param_offload = zc.offload_param.enabled and self.offload_optimizer is None
        if zc.offload_param.enabled and self.offload_optimizer is not None:
            logger.warning("offload_param: the optimizer-offload path already keeps the fp32 "
                           "master in host RAM; offload_param is subsumed")
        pin = zc.offload_optimizer.pin_memory if self.offload_optimizer is not None else \
            zc.offload_param.pin_memory
        self._pin = pin and self.device.type == "cuda"
        self._parked = False
        self._stage: Optional[torch.Tensor] = None

        # numerics observatory (telemetry/numerics.py): the stats of the
        # step that ends at a steps_per_print boundary, on the device until
        # that boundary pulls them.  Off under optimizer offload (the
        # boundary update runs on the host; the sentinel still watches the
        # host scalars there).  Activation stats need a model config that
        # carries the flag (the transformer core's).
        self._numerics = self.telemetry.numerics if self.telemetry is not None else None
        self._numerics_fused = self._numerics is not None and self.offload_optimizer is None
        mc = getattr(self.model, "config", None)
        self._numerics_act = (self._numerics_fused
                              and bool(self.config.telemetry.numerics.activation_stats)
                              and mc is not None and hasattr(mc, "numerics_act_stats"))
        self._last_numerics = None

        self.state = self._init_state(model_parameters,
                                      self.config.seed if seed is None else seed)
        named = list(self._compute.named_parameters())
        self._compute_leaves = [p for _, p in named]
        #: each leaf's (JAX path, layer): the numerics boundary's folding
        self._leaf_index = leaf_index([n for n, _ in named])
        self._compute_fresh = True
        self._boundary = (OffloadBoundary(self._compute_leaves, self._pin)
                          if self.offload_optimizer is not None else None)
        self._wire_memory_ledger()
        logger.info(f"DeepSpeedTPUEngine (torch) initialized: device={self.device} "
                    f"zero_stage={self.config.zero_config.stage} dtype={self.compute_dtype} "
                    f"micro_bs={self.config.train_micro_batch_size_per_gpu} "
                    f"gas={self.config.gradient_accumulation_steps} "
                    f"offload_optimizer={self.offload_optimizer is not None} "
                    f"offload_param={self._param_offload}")
        # resilience: preemption watcher + startup auto-resume from the
        # latest VERIFIED checkpoint.  Last in init: the resume loads into
        # the fully-built engine.
        self.resilience = None
        rcfg = self.config.resilience
        if rcfg.enabled:
            from ..resilience import ResilienceManager

            gp = self.telemetry.goodput if self.telemetry is not None else None
            if gp is not None and not self.config.telemetry.goodput.run_file and rcfg.save_dir:
                # union-of-attempts ledger rides the checkpoint dir by
                # default: every attempt of a resilient run finds the
                # same file, so productive steps survive preemptions
                gp.attach_run_file(os.path.join(rcfg.save_dir, "goodput_run.json"))
            self.resilience = ResilienceManager(rcfg)
            self.resilience.maybe_auto_resume(self)

    def _host_optimizer(self):
        """The host optimizer the config selects (JAX engine.py:168-215), or
        None."""
        zc = self.config.zero_config
        off, zf = zc.offload_optimizer, zc.zenflow
        if not (off.enabled or zf.enabled):
            return None
        if self.fp16_enabled and (zf.enabled or off.super_offload):
            raise NotImplementedError("fp16 loss scaling is supported with plain "
                                      "offload_optimizer but not with zenflow/super_offload; "
                                      "use bf16 there")
        opt_cfg = {"type": self.config.optimizer.type, "params": self.config.optimizer.params}
        clip = self.config.gradient_clipping
        nvme = off.resolved_nvme_path if off.device == "nvme" else None
        if zf.enabled:
            from .zenflow.zenflow import ZenFlowOptimizer

            if nvme:
                raise NotImplementedError("zenflow keeps optimizer state in host RAM; it does "
                                          "not spill to NVMe — drop offload_optimizer.device="
                                          "'nvme' or disable zenflow")
            if off.super_offload:
                logger.warning("zenflow enabled: super_offload / cpu_worker_count are ignored")
            return ZenFlowOptimizer(None, opt_cfg, zenflow_config=zf, grad_clip=clip)
        if off.super_offload:
            from .superoffload.superoffload import SuperOffloadOptimizer

            return SuperOffloadOptimizer(None, opt_cfg, grad_clip=clip, nvme_path=nvme,
                                         cpu_worker_count=off.cpu_worker_count)
        from .zero.offload import HostOffloadedOptimizer

        return HostOffloadedOptimizer(None, opt_cfg, grad_clip=clip, nvme_path=nvme)

    # ------------------------------------------------------------------ init
    def _init_state(self, model_parameters: Any, seed: int) -> TrainState:
        cfg = self.model.config
        if model_parameters is not None:
            params = adopt_params(model_parameters, cfg, self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = cast_tree(self.model.init_params(gen, self.device), torch.float32)
        for p in params.parameters():
            p.requires_grad_(False)
        leaves = [p for _, p in params.named_parameters()]
        dev = self.device
        host = self.offload_optimizer
        with torch.no_grad():
            if host is not None:
                # the master to host RAM leaf by leaf, each device copy freed
                # as its compute copy replaces it
                for i, p in enumerate(leaves):
                    host.adopt_master(i, p)
                    p.data = p.data.to(self.compute_dtype)
                    p.requires_grad_(p.is_floating_point())
                self._compute, self._master, opt_state = params, [], ()
            else:
                # the compute-dtype copy autograd differentiates, refreshed
                # from the master once per optimizer step (in fp32 the
                # master's own storage, unless the master moves to the host)
                self._compute = params.map(lambda t: t.to(self.compute_dtype),
                                           requires_grad=True)
                opt_state = self.optimizer.init(leaves)
                if self._param_offload:
                    for p in leaves:
                        h = torch.empty(p.shape, dtype=p.dtype, pin_memory=self._pin)
                        h.copy_(p)
                        p.data = h
                self._master = leaves
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            micro_step=0,
            params=params,
            opt_state=opt_state,
            grad_acc=None,
            loss_scale=(LossScaleState.create(self.config.fp16, dev)
                        if self.fp16_enabled else None),
            skipped_steps=torch.zeros((), dtype=torch.int32, device=dev),
            global_grad_norm=torch.zeros((), dtype=torch.float32, device=dev))

    # ------------------------------------------------------------- the step
    def _compute_params(self) -> ParamTree:
        """The compute-dtype copy of the master, refreshed in place when the
        master moved since the last refresh."""
        if not self._compute_fresh:
            with torch.no_grad():
                for c, m in zip(self._compute_leaves, self._master):
                    c.copy_(m)
            self._compute_fresh = True
        return self._compute

    def _model_loss(self, params: ParamTree, batch: Any, act_stats: bool = False):
        """model.loss_fn, with the model config's ``numerics_act_stats``
        set for the call when ``act_stats`` (then ``(loss, [L, 3] act)``,
        or ``(loss, None)`` from a loss that takes no activation stats)."""
        if not act_stats:
            return self.model.loss_fn(params, batch, None)
        mc = self.model.config
        old = mc.numerics_act_stats
        mc.numerics_act_stats = True
        try:
            out = self.model.loss_fn(params, batch, None)
        finally:
            mc.numerics_act_stats = old
        return out if isinstance(out, tuple) else (out, None)

    def _micro_grads(self, batch: Any, want_overflow: bool = False, act_stats: bool = False):
        """One micro-batch: (grads in grad_accum_dtype, loss, the fp16
        overflow verdict over the post-cast grads when ``want_overflow``,
        the [L, 3] activation-health rows when ``act_stats``)."""
        params = self._compute_params()
        out = self._model_loss(params, batch, act_stats)
        loss, act = out if act_stats else (out, None)
        scaled = loss.float() * self.state.loss_scale.cur_scale if self.fp16_enabled else loss
        grads = torch.autograd.grad(scaled, self._compute_leaves, allow_unused=True)
        grads = [torch.zeros(c.shape, dtype=self.grad_accum_dtype, device=c.device)
                 if g is None else g.to(self.grad_accum_dtype)
                 for g, c in zip(grads, self._compute_leaves)]
        bad = check_overflow(grads) if self.fp16_enabled and want_overflow else None
        return grads, loss.detach().float(), bad, act

    def _accumulate(self, grads: List[torch.Tensor]) -> None:
        if self.state.grad_acc is None:
            self.state.grad_acc = grads
        else:
            for acc, g in zip(self.state.grad_acc, grads):
                acc.add_(g)
        self.state.micro_step += 1

    def _apply_step(self, grads_src: Optional[List[torch.Tensor]] = None,
                    overflow: Optional[torch.Tensor] = None) -> None:
        """Boundary update from ``grads_src`` (gas = 1: the micro-step's
        grads, straight through) or the accumulation buffer.  ``overflow``:
        the fp16 verdict already taken over ``grads_src``."""
        st = self.state
        src = st.grad_acc if grads_src is None else grads_src
        if src is None:
            raise RuntimeError("step(): no gradients accumulated since the last step")
        if self.offload_optimizer is not None:
            self._apply_step_offload(src, overflow)
            return
        gas = self.config.gradient_accumulation_steps or 1
        # fp32 copies of non-fp32 grads; fp32 grads are this step's own
        # buffers (autograd outputs or the accumulator) and are scaled in place
        grads = [g.float() for g in src]
        if self.fp16_enabled:
            # dstpu-lint: allow[host-sync] gas is a Python int: no device value is read
            denom = float(gas) * st.loss_scale.cur_scale
            for g in grads:
                g.div_(denom)
        else:
            for g in grads:
                # dstpu-lint: allow[host-sync] gas is a Python int: no device value is read
                g.div_(float(gas))
        norm = global_grad_norm(grads)
        clip = self.config.gradient_clipping
        if clip > 0:
            grads = clip_by_global_norm(grads, norm, clip)
        skipped = 0
        if self.fp16_enabled:
            if overflow is None:
                overflow = check_overflow(grads)
            # the one host sync of an fp16 step: whether the optimizer runs
            skipped = int(bool(overflow))
            st.loss_scale = update_loss_scale(st.loss_scale, overflow, self.config.fp16)
        if not skipped:
            if self._param_offload:
                self._update_streamed(grads)
            else:
                self._update(grads)
            st.step = st.step + 1
            # an fp32 compute copy shares the master's storage, and the
            # streamed update refreshes the compute copy itself: never stale
            self._compute_fresh = self.compute_dtype == torch.float32 or self._param_offload
        st.skipped_steps = st.skipped_steps + skipped
        st.global_grad_norm = norm
        st.grad_acc = None
        st.micro_step = 0

    def _update(self, grads: List[torch.Tensor]) -> None:
        direct = getattr(self.optimizer, "direct_update", None)
        if direct is not None:
            direct(grads, self.state.opt_state, self._master)  # kernel C, in place
            return
        updates, self.state.opt_state = self.optimizer.update(grads, self.state.opt_state,
                                                              self._master)
        with torch.no_grad():
            for p, u in zip(self._master, updates):
                p.add_(u.to(p.dtype))

    def _update_streamed(self, grads: List[torch.Tensor]) -> None:
        """offload_param's boundary: each host master leaf up into a device
        buffer, the optimizer there (kernel C in place for the fused one),
        its compute copy refreshed, the leaf back down.  Every copy and
        update runs on the caller's stream, in order, so one buffer the
        size of the largest leaf serves every leaf."""
        opt, state = self.optimizer, self.state.opt_state
        direct = getattr(opt, "direct_update", None)
        if self._stage is None:
            cap = max(m.numel() for m in self._master)
            self._stage = torch.empty(cap, dtype=torch.float32, device=self.device)
        step = state["step"]
        with torch.no_grad():
            for i, (g, host, c) in enumerate(zip(grads, self._master, self._compute_leaves)):
                p = self._stage[:host.numel()].view(host.shape)
                p.copy_(host, non_blocking=True)
                sub = {k: ([v[i]] if isinstance(v, list) else v) for k, v in state.items()}
                sub["step"] = step
                if direct is not None:
                    direct([g], sub, [p])
                else:
                    (u,), sub = opt.update([g], sub, [p])
                    p.add_(u.to(p.dtype))
                    for k, v in sub.items():
                        if isinstance(state.get(k), list):
                            state[k][i] = v[0]
                c.copy_(p)
                host.copy_(p, non_blocking=True)
            state["step"] = sub["step"]

    def _apply_step_offload(self, src: List[torch.Tensor],
                            overflow: Optional[torch.Tensor]) -> None:
        """The host optimizer's boundary (JAX engine.py:1529-1610): norm and
        clip factor on the card, then the streamed update."""
        st = self.state
        gas = self.config.gradient_accumulation_steps or 1
        # dstpu-lint: allow[host-sync] the host optimizer's boundary: the host update needs
        # the schedule's lr at the step actually taken, read once a boundary
        lr = float(self.lr_schedule(int(st.step)))
        # dstpu-lint: allow[host-sync] gas is a Python int: no device value is read
        denom = float(gas)
        if self.fp16_enabled:
            if overflow is None:
                overflow = check_overflow(src)
            # dstpu-lint: allow[host-sync] fp16 under offload: the host divides by the loss
            # scale, read once a boundary (the overflow flag is read beside it)
            denom = float(gas) * float(st.loss_scale.cur_scale)
            st.loss_scale = update_loss_scale(st.loss_scale, overflow, self.config.fp16)
            if bool(overflow):  # skipped before any host state is touched
                st.skipped_steps = st.skipped_steps + 1
                st.global_grad_norm = torch.zeros((), dtype=torch.float32, device=self.device)
                st.grad_acc, st.micro_step = None, 0
                return
        denom_t = torch.tensor(denom, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            sq = torch.stack([torch.dot(v, v) for v in
                              (g.reshape(-1).float() / denom_t for g in src)])
            norm = float(sq.double().sum().sqrt())
        self._boundary.run(src, denom, clip_coefficient(norm, self.config.gradient_clipping),
                           self.offload_optimizer, lr)
        st.step = st.step + 1
        st.global_grad_norm = torch.tensor(norm, dtype=torch.float32, device=self.device)
        st.grad_acc, st.micro_step = None, 0

    def _train_batch(self, batches: Any, numerics: bool = False) -> torch.Tensor:
        """One optimizer step over the gas micro-batches.  ``numerics``:
        this step ends at a reporting boundary with the observatory on —
        its stats tree is left in ``_last_numerics`` (on the device)."""
        gas = self.config.gradient_accumulation_steps or 1
        act_on = numerics and self._numerics_act
        if gas == 1:
            grads, loss, bad, act = self._micro_grads(_index(batches, 0),
                                                      want_overflow=self.fp16_enabled,
                                                      act_stats=act_on)
            # the raw (loss-scaled) grads' stats, before the update unscales them
            pre = leaf_stats(grads) if numerics else None
            self._apply_step(grads_src=grads, overflow=bad)
            if numerics:
                self._last_numerics = self._numerics_tree(pre, loss, act)
            return loss
        losses, acts = [], []
        for i in range(gas):
            grads, loss, _, act = self._micro_grads(_index(batches, i), act_stats=act_on)
            self._accumulate(grads)
            del grads  # free this micro-step's grads before the next backward
            losses.append(loss)
            if act is not None:
                acts.append(act)
        pre = leaf_stats(self.state.grad_acc) if numerics else None
        self._apply_step()
        loss = torch.stack(losses).mean()
        if numerics:
            act = None
            if acts:
                # fold the per-micro-step rows the way each column means:
                # norms average, max-abs maxes, nonfinite counts sum
                a = torch.stack(acts)  # [gas, L, 3]
                act = torch.stack([a[..., 0].mean(dim=0), a[..., 1].amax(dim=0),
                                   a[..., 2].sum(dim=0)], dim=-1)
            self._last_numerics = self._numerics_tree(pre, loss, act)
        return loss

    def _numerics_tree(self, pre: dict, loss: torch.Tensor, act: Any) -> dict:
        """The step's numerics stats (the JAX engine's fused-step output),
        on the device: ``pre`` the gradients' per-tensor stats taken before
        the update, whose magnitudes the boundary scales by ``inv_scale =
        1/(gas * loss_scale)`` (the post-update scale, as JAX's tree reads
        it) to report TRUE values; the rest reads the post-update state.
        ``_numerics_boundary`` folds it into JAX's tree."""
        st = self.state
        gas = self.config.gradient_accumulation_steps or 1
        # dstpu-lint: allow[host-sync] gas is a Python int: no device value is read
        inv = torch.tensor(1.0 / float(gas), dtype=torch.float32, device=self.device)
        if self.fp16_enabled:
            inv = inv / st.loss_scale.cur_scale
        stats = {"step": st.step, "loss": loss, "grad_norm": st.global_grad_norm,
                 "skipped_steps": st.skipped_steps, "inv_scale": inv, "grad": pre,
                 "param": leaf_stats(self._master), "opt": leaf_stats(self._opt_tensors())}
        if st.loss_scale is not None:
            stats["loss_scale"] = loss_scale_summary(st.loss_scale)
        if act is not None:
            stats["act_layers"] = act
        return stats

    def _fold_numerics(self, host: dict) -> dict:
        """A pulled stats tree in the JAX engine's shape (``grad``,
        ``param``, ``grad_leaf_nonfinite``, ``grad_layers``,
        ``param_layers``, ``opt_nonfinite``)."""
        g = fold_leaf_stats(host.pop("grad"), self._leaf_index, scale=float(host.pop("inv_scale")))
        p = fold_leaf_stats(host.pop("param"), self._leaf_index)
        host.update(grad=g["whole"], grad_leaf_nonfinite=g["leaf"], param=p["whole"],
                    opt_nonfinite=int(host.pop("opt")["nonfinite"].sum()))
        if g["layers"] is not None:
            host["grad_layers"] = g["layers"]
        if p["layers"] is not None:
            host["param_layers"] = p["layers"]
        return host

    def _opt_tensors(self) -> List[torch.Tensor]:
        opt = self.state.opt_state
        out: List[torch.Tensor] = []

        def walk(node):
            if isinstance(node, torch.Tensor):
                out.append(node)
            elif isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)

        walk(opt)
        return out

    # ------------------------------------------------------------ public API
    def train_batch(self, batch: Any = None, data_iter: Optional[Iterator] = None
                    ) -> torch.Tensor:
        """One full optimizer step.  ``batch`` leaves carry a leading dim of
        ``gradient_accumulation_steps`` (:func:`stack_microbatches`), or
        ``data_iter`` yields the gas micro-batches, or (neither given) the
        training dataloader does, wrapping round at its end.  Returns the
        mean loss as a device tensor."""
        self._check_live()
        gas = self.config.gradient_accumulation_steps or 1
        if batch is None:
            if data_iter is not None:
                micro = [next(data_iter) for _ in range(gas)]
            elif self.training_dataloader is not None:
                micro = [self._next_training_batch() for _ in range(gas)]
            else:
                raise ValueError("train_batch needs a batch or a data iterator")
            batch = stack_microbatches(micro)
        if self.flops_profiler is not None:
            self.flops_profiler.start_profile_maybe(self.global_steps, batch)
        self.tput_timer.start()
        skipped_before = self._skipped_steps_snapshot()
        if self._acc_dirty:
            # abandoned forward() micro-steps: drop their accumulation
            self.state.grad_acc = None
            self.state.micro_step = 0
            self.micro_steps -= self.micro_steps % gas
            self._acc_dirty = False
        tm = self.telemetry
        spp = self.config.steps_per_print
        t0 = time.perf_counter()
        trace = tm.step_trace(self.global_steps) if tm is not None else _noop()
        # step-time attribution: only the captured step pays the profiler
        # start/stop and the parse; its wall is self-inflicted overhead, so
        # it feeds neither the watchdog's median nor goodput's stall bucket
        tl = tm.timeline if tm is not None else None
        capturing = tl is not None and tl.should_capture(self.global_steps)
        self._timeline_captured = capturing
        cap = tl.capture(self.global_steps, sync=self._device_fence) if capturing else _noop()
        numerics = self._numerics_fused and (self.global_steps + 1) % spp == 0
        try:
            with cap, trace, span("train_batch", cat="train", step=self.global_steps):
                loss = self._train_batch(to_device(batch, self.device), numerics=numerics)
                self.global_steps += 1
                self.micro_steps += gas
                self._sanity_check_maybe(loss, skipped_before)
                # launches are async: with telemetry on, drain the device
                # at reporting boundaries so the throughput window
                # [boundary, boundary] measures real wall time
                if (tm is not None and self.global_steps % spp == 0) or \
                        self.config.wall_clock_breakdown:
                    self._device_fence()
        except Exception as e:
            # black box first, then propagate: the flight dump is the
            # only record of what the process was doing when it died
            dump_on_exception("engine.train_batch", e)
            raise
        self.tput_timer.stop()
        if tm is not None and tm.sentinel is not None:
            tm.sentinel.observe_step([("train_batch", _shape_signature(batch))],
                                     step=self.global_steps)
        if self.flops_profiler is not None:
            self.flops_profiler.stop_profile_maybe(self.global_steps)
        if tm is not None:
            self._report_telemetry(loss, batch, time.perf_counter() - t0)
        self._report(loss)
        if self.resilience is not None:
            # pending preemption notice -> emergency save + resumable exit,
            # honoured HERE (a consistent step boundary), never mid-step
            # (raises PreemptionInterrupt, a SystemExit)
            self.resilience.at_step_boundary(self)
        return loss

    def _next_training_batch(self) -> Any:
        # one live iterator, re-made when the loader object was swapped
        if self._train_iter_src is not self.training_dataloader:
            self._train_iter = RepeatingLoader(self.training_dataloader)
            self._train_iter_src = self.training_dataloader
        try:
            return next(self._train_iter)
        except StopIteration:
            raise ValueError("training dataloader is empty (fewer samples than one "
                             "micro-batch with drop_last?)") from None

    def deepspeed_io(self, dataset: Any, batch_size: Optional[int] = None,
                     collate_fn: Any = None, num_local_io_workers: Any = None,
                     data_sampler: Any = None) -> DeepSpeedDataLoader:
        """The dataloader over ``dataset`` (the JAX engine's
        ``deepspeed_io``): micro-batches of ``batch_size`` (default the
        config's) on this engine's device, shuffled by the config's seed.
        ``num_local_io_workers`` and ``data_sampler`` are taken for the
        reference's signature and unused, as in the JAX engine."""
        return DeepSpeedDataLoader(
            dataset, batch_size=batch_size or self.config.train_micro_batch_size_per_gpu,
            device=self.device, collate_fn=collate_fn, seed=self.config.seed)

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        partitioned: Optional[bool] = None) -> str:
        """Save the training state as tag ``tag`` (default
        ``global_step<N>``) in the consolidated layout; returns its path.
        ``partitioned=True`` (per-rank shard files) raises: one rank.
        With the ``resilience`` block on, ``keep_n`` bounds the committed
        tags and the write is retried ``io_retries`` times; the numerics
        sentinel's state rides ``client_state["numerics"]``."""
        from ..checkpoint import saving

        if partitioned:
            saving.refuse_partitioned("save_checkpoint(partitioned=True)")
        tag = tag or f"global_step{self.global_steps}"
        rcfg = self.config.resilience
        keep_n = rcfg.keep_n if rcfg.enabled else None
        if self._numerics is not None:
            # the sentinel's rolling window survives resume (a loss spike
            # right after restart is judged against the pre-restart
            # median); setdefault — a caller-provided slot wins
            client_state = dict(client_state or {})
            client_state.setdefault("numerics", self._numerics.state_dict())

        def _save():
            return saving.save_checkpoint(self, save_dir, tag=tag,
                                          client_state=client_state or {}, keep_n=keep_n)

        t0 = time.perf_counter()
        try:
            with span("checkpoint_save", cat="ckpt", tag=tag, partitioned=False):
                if rcfg.enabled and rcfg.io_retries:
                    from ..resilience.commit import io_retry

                    # a failed and retried save restages from scratch (the
                    # commit protocol resets tmp.<tag>), so retry is safe
                    return io_retry(_save, retries=rcfg.io_retries,
                                    base_delay_s=rcfg.io_retry_base_s,
                                    what=f"checkpoint save '{tag}'")
                return _save()
        finally:
            gp = self.telemetry.goodput if self.telemetry is not None else None
            if gp is not None:
                gp.observe_phase("checkpoint_save", time.perf_counter() - t0)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True) -> Tuple[Optional[str], dict]:
        """Verified load: the tag is resolved through the commit protocol
        (checksums checked; a corrupt newest tag is counted and skipped for
        the previous good one; an explicit corrupt tag raises
        ``CorruptCheckpointError``; a tag without a manifest loads
        unverified).  Returns (path, client_state), or (None, {}).  A tag
        that carries a numerics incident is named in a warning; the
        numerics sentinel's state comes back from ``client_state``."""
        from ..checkpoint import saving
        from ..resilience.commit import resolve_tag

        resolved, report = resolve_tag(load_dir, tag)
        if resolved is None:
            logger.warning(f"no loadable checkpoint in {load_dir}; nothing loaded")
            return None, {}
        inc = (report.get("meta") or {}).get("numerics_incident")
        if inc:
            # resume-time triage: this tag was the first save after the
            # anomaly sentinel fired — say WHAT fired and WHERE
            first = (inc.get("anomalies") or [{}])[0]
            layer = first.get("first_nonfinite_layer")
            leaf = first.get("first_nonfinite_leaf") or first.get("first_diverging_leaf")
            logger.warning(f"resuming from '{resolved}' which carries a numerics incident: "
                           f"kinds={inc.get('kinds')} step={inc.get('step')} "
                           f"first_nonfinite_layer={layer} leaf={leaf}")
        t0 = time.perf_counter()
        try:
            with span("checkpoint_load", cat="ckpt", tag=resolved):
                ret = saving.load_checkpoint(self, load_dir, tag=resolved,
                                             load_optimizer_states=load_optimizer_states,
                                             load_lr_scheduler_states=load_lr_scheduler_states,
                                             verified=report["verified"])
                if self._numerics is not None:
                    self._numerics.load_state_dict((ret[1] or {}).get("numerics"))
                return ret
        finally:
            gp = self.telemetry.goodput if self.telemetry is not None else None
            if gp is not None:
                # auto-resume wraps this in override("restart"): a
                # preemption-recovery load is restart badput
                gp.observe_phase("checkpoint_load", time.perf_counter() - t0)

    def forward(self, batch: Any) -> torch.Tensor:
        """DeepSpeed-compatible micro-step: loss AND gradients in one pass
        (accumulated); ``backward`` then only counts the micro-step."""
        self._check_live()
        if self.flops_profiler is not None:
            self.flops_profiler.start_profile_maybe(self.global_steps, batch, stacked=False)
        self.timers(FORWARD_GLOBAL_TIMER).start()
        with span("forward", cat="train", micro_step=self.micro_steps):
            grads, loss, _, _ = self._micro_grads(to_device(batch, self.device))
            self._accumulate(grads)
        self._acc_dirty = True
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        self._cached_loss = loss
        return loss

    __call__ = forward

    def backward(self, loss: Any = None) -> Any:
        """The gradients were taken in ``forward``; this counts the
        micro-step (a point event, not a span: a duration here would read
        as "backward is free")."""
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        record_event("backward", cat="train", micro_step=self.micro_steps,
                     fused_into="forward")
        self.micro_steps += 1
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss if loss is not None else self._cached_loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % (self.config.gradient_accumulation_steps or 1) == 0

    def step(self) -> None:
        """The optimizer at the gas boundary."""
        self._check_live()
        self.timers(STEP_GLOBAL_TIMER).start()
        if self.is_gradient_accumulation_boundary():
            skipped_before = self._skipped_steps_snapshot()
            try:
                with span("optimizer_step", cat="train", step=self.global_steps):
                    self._apply_step()
            except Exception as e:
                dump_on_exception("engine.step", e)
                raise
            self._acc_dirty = False
            self.global_steps += 1
            self._sanity_check_maybe(self._cached_loss, skipped_before)
            self.lr_scheduler.step()
            if self.config.wall_clock_breakdown:
                self._device_fence()
            if self.telemetry is not None:
                self._report_telemetry(self._cached_loss, None)
            self._report(self._cached_loss)
            if self.resilience is not None:
                self.resilience.at_step_boundary(self)
        self.timers(STEP_GLOBAL_TIMER).stop()
        if self.flops_profiler is not None:
            self.flops_profiler.stop_profile_maybe(self.global_steps)

    def eval_batch(self, batch: Any) -> Any:
        """The model's ``apply_fn`` (else its loss) on the compute copy."""
        self._check_live()
        batch = to_device(batch, self.device)
        t0 = time.perf_counter()
        with span("eval_batch", cat="eval"), torch.no_grad():
            p = self._compute_params()
            if self.model.apply_fn is not None:
                out = self.model.apply_fn(p, batch)
            else:
                out = self.model.loss_fn(p, batch, None)
        gp = self.telemetry.goodput if self.telemetry is not None else None
        if gp is not None:
            # eval wall time is badput in the goodput ledger (launch time
            # only on the card — an honest lower bound)
            gp.observe_phase("eval", time.perf_counter() - t0)
        return out

    # ---------------------------------------------------------- accessors
    def get_lr(self) -> List[float]:
        # dstpu-lint: allow[host-sync] a public accessor; on the step path only at a
        # steps_per_print boundary (_report_telemetry), after the device fence
        return [float(self.lr_schedule(int(self.state.step)))]

    def get_global_grad_norm(self) -> float:
        return float(self.state.global_grad_norm)

    def loss_scale(self) -> float:
        if self.state.loss_scale is None:
            return 1.0
        # dstpu-lint: allow[host-sync] a public accessor; on the step path only at a
        # steps_per_print boundary (_report_telemetry), after the device fence
        return float(self.state.loss_scale.cur_scale)

    @property
    def skipped_steps(self) -> int:
        return int(self.state.skipped_steps)

    def get_params(self, dtype: Optional[torch.dtype] = None) -> ParamTree:
        """The fp32 master (a cast copy when ``dtype`` is given);
        ``models.convert.params_to_numpy`` turns it into the JAX layout.
        Under offload it lies in host memory: the host optimizer's arrays
        (shared, not copied) or offload_param's pinned leaves."""
        if self.offload_optimizer is not None:
            p = self.offload_optimizer.master_as_tree(self._compute)
        else:
            if self._param_offload and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the last leaves' copies down
            p = self.state.params
        return p.map(lambda t: t.to(dtype)) if dtype is not None else p

    # ------------------------------------------------------ sanity checks
    #: consecutive non-finite losses tolerated while the DYNAMIC fp16 loss
    #: scaler is skipping steps: enough for a full backoff from 2^32 to the
    #: floor; persistent NaN divergence skips forever and must still abort
    _SANITY_MAX_SKIP_RUN = 50

    def _skipped_steps_snapshot(self) -> Optional[int]:
        """Pre-step skip count when the fp16 overflow tolerance applies
        (dynamic scaling only — a static scale never recovers, so a
        non-finite loss there is immediately fatal); None = no tolerance."""
        if (self.config.sanity_checks and self.fp16_enabled
                # dstpu-lint: allow[host-sync] the config's loss_scale is a Python float;
                # the skipped-steps read is the opt-in sanity_checks guard's one sync a step
                # under a dynamic fp16 scale, as in the JAX engine
                and float(self.config.fp16.loss_scale) == 0.0):
            # dstpu-lint: allow[host-sync] sanity_checks under a dynamic fp16 scale only:
            # the guard's skipped-steps read
            return int(self.state.skipped_steps)
        return None

    def _sanity_check_maybe(self, loss: Any, skipped_before: Optional[int] = None) -> None:
        """Reference is_sanity_checks_enabled: fail FAST on a non-finite
        loss instead of training on garbage; the host sync it costs is why
        this is opt-in.  An fp16 overflow step the dynamic loss scaler
        skipped is tolerated, but only for ``_SANITY_MAX_SKIP_RUN``
        consecutive non-finite losses."""
        if not self.config.sanity_checks or loss is None:
            return
        # dstpu-lint: allow[host-sync] sanity_checks is the opt-in non-finite guard: one
        # sync a step by design, as in the JAX engine
        lv = float(loss)
        if np.isfinite(lv):
            self._sanity_skip_run = 0
            return
        # dstpu-lint: allow[host-sync] sanity_checks only, after its loss read: the overflow
        # skip it tolerates
        if skipped_before is not None and int(self.state.skipped_steps) > skipped_before:
            self._sanity_skip_run = getattr(self, "_sanity_skip_run", 0) + 1
            if self._sanity_skip_run <= self._SANITY_MAX_SKIP_RUN:
                return  # overflow handled by the loss scaler
        raise FloatingPointError(
            f"sanity_checks: non-finite loss {lv} at step "
            f"{self.global_steps} (grad norm "
            # dstpu-lint: allow[host-sync] the error message of a dead job: the sync
            # enriches the post-mortem
            f"{float(self.state.global_grad_norm):.3g}, "
            f"consecutive tolerated skips "
            f"{getattr(self, '_sanity_skip_run', 0)})")

    # ------------------------------------------------------- observability
    def _device_fence(self) -> None:
        """Wait for the launched work (the card's queue; nothing on the
        CPU): at a reporting boundary, and closing a timeline capture's
        window after the traced step's device work has retired."""
        if self.device.type == "cuda":
            # dstpu-lint: allow[host-sync] the device fence: called only at a
            # steps_per_print boundary with telemetry on, with wall_clock_breakdown, around
            # a timeline capture and by stop_profiler_trace, never on a plain step
            torch.cuda.synchronize(self.device)

    def capture_timeline(self, batch: Any = None, data_iter: Optional[Iterator] = None):
        """Force a step-time attribution capture around ONE train_batch
        and return ``(loss, record)``.  ``record`` is None when telemetry
        or the timeline is disabled."""
        tl = self.telemetry.timeline if self.telemetry is not None else None
        if tl is None:
            return self.train_batch(batch=batch, data_iter=data_iter), None
        tl.force_next()
        loss = self.train_batch(batch=batch, data_iter=data_iter)
        return loss, tl.last_record()

    def timeline_record(self) -> Optional[dict]:
        """Last completed step-time attribution record, or None."""
        tl = self.telemetry.timeline if self.telemetry is not None else None
        return tl.last_record() if tl is not None else None

    def goodput_summary(self) -> Optional[dict]:
        """Current goodput/badput ledger summary, or None."""
        gp = self.telemetry.goodput if self.telemetry is not None else None
        return gp.summary() if gp is not None else None

    def _init_train_metrics(self) -> None:
        """Register the training metric family on the telemetry registry
        (get-or-create: many engines per process share the series)."""
        reg = self.telemetry.registry
        self._m_phase = reg.histogram(
            "deepspeed_tpu_train_phase_seconds",
            "host wall time per training phase (fwd/bwd/step/train_batch)",
            labelnames=("phase",))
        self._m_loss = reg.gauge("deepspeed_tpu_train_loss",
                                 "last reported training loss")
        self._m_lr = reg.gauge("deepspeed_tpu_train_lr",
                               "current learning rate")
        self._m_grad_norm = reg.gauge("deepspeed_tpu_train_grad_norm",
                                      "global gradient norm at the last boundary")
        self._m_loss_scale = reg.gauge("deepspeed_tpu_train_loss_scale",
                                       "fp16 dynamic loss scale (1 when off)")
        self._m_samples_ps = reg.gauge(
            "deepspeed_tpu_train_samples_per_second",
            "throughput over the last reporting window")
        self._m_tokens_ps = reg.gauge(
            "deepspeed_tpu_train_tokens_per_second",
            "token throughput over the last reporting window "
            "(0 when the batch carries no [B, T] integer ids)")
        self._m_mfu = reg.gauge(
            "deepspeed_tpu_train_mfu",
            "model FLOPs utilization vs per-generation peak "
            "(telemetry/mfu.py table)")
        self._m_overlap_frac = reg.gauge(
            "deepspeed_tpu_train_overlapped_fraction",
            "bytes-weighted share of the step's gradient exchange issued "
            "inside the backward loop (overlap-scheduled) vs the "
            "post-backward tail (telemetry/overlap.py)")
        self._m_exposed = reg.counter(
            "deepspeed_tpu_train_exposed_collective_seconds_estimated",
            "cumulative ESTIMATED seconds of exposed (non-overlapped) "
            "gradient collectives: wire bytes x bus factor over the "
            "nominal per-generation interconnect bandwidth (a model — "
            "the MEASURED counterpart is "
            "deepspeed_tpu_timeline_exposed_collective_seconds)")
        # deprecated alias: the pre-rename series keeps moving so
        # existing dashboards don't flatline; a warn-once fires at the
        # first increment (see _report_telemetry)
        self._m_exposed_deprecated = reg.counter(
            "deepspeed_tpu_train_exposed_collective_seconds",
            "DEPRECATED alias of "
            "deepspeed_tpu_train_exposed_collective_seconds_estimated "
            "(renamed to make the byte-model nature explicit)")
        self._m_pipe_bubble = reg.gauge(
            "deepspeed_tpu_train_pipe_bubble_fraction",
            "structural share of pipe-schedule ticks that are warm-up/"
            "drain bubbles, (P-1)/(M+P-1); 0 when no pipe schedule runs "
            "(docs/PIPELINE.md)")
        self._m_comp_residual = reg.gauge(
            "deepspeed_tpu_comm_compression_residual_bytes",
            "bytes of compressed-collective error-feedback residual "
            "state carried in TrainState.comm_errors (per-bucket; "
            "docs/COMM.md 'Compressed overlap')")
        self._m_comp_residual_norm = reg.gauge(
            "deepspeed_tpu_comm_compression_residual_norm",
            "L2 norm of the compressed-collective error-feedback "
            "residual state per comm_errors slot (in-graph, pulled at "
            "the reporting boundary; a norm growing without bound means "
            "error feedback is diverging, not compensating)",
            labelnames=("slot",))
        self._m_steps = reg.counter("deepspeed_tpu_train_steps_total",
                                    "optimizer steps taken")
        self._m_skipped = reg.counter(
            "deepspeed_tpu_train_skipped_steps_total",
            "fp16 overflow steps skipped by the loss scaler")
        self._win_time = 0.0
        self._win_steps = 0
        self._win_tokens = 0
        self._skipped_pub = 0
        self._flops_per_step: Optional[float] = None
        #: the last reporting window's MFU inputs (flops, seconds, steps,
        #: tokens), None before the first boundary
        self._mfu_window: Optional[dict] = None

    def _observe_phase(self, name: str, dt: float) -> None:
        self._m_phase.observe(dt, phase=name)

    def _wire_memory_ledger(self) -> None:
        """Attach the training state to the process memory ledger
        (telemetry/memory.py) so device bytes are attributable by name:
        ``master_params`` (the fp32 master), ``optimizer_state``, ``grads``
        (the accumulation buffer, empty between steps), ``train_scalars``
        and, where the compute copy is its own allocation (bf16/fp16 on
        the card, or the leaves under offload_optimizer), ``params``;
        host-offloaded masters and moments report as host bytes.  The
        providers hold the engine only weakly (a dropped engine is
        collected with or without ``close()``), wiring first clears every
        training component name (a stale sibling's slot must not sum into
        the attribution), and ``close()`` detaches exactly what this
        engine attached."""
        self._ledger_components: List[Tuple[str, Any]] = []
        if self.telemetry is None or self.telemetry.ledger is None:
            return
        led = self.telemetry.ledger
        for name in ("params", "master_params", "optimizer_state", "grads", "train_scalars"):
            led.detach(name)
        ref = weakref.ref(self)

        def _attach(name, read):
            def provider():
                eng = ref()
                return None if eng is None or eng.state is None else read(eng)
            led.attach(name, provider)
            self._ledger_components.append((name, provider))

        led.update_context(
            zero_stage=self.config.zero_config.stage,
            offload_optimizer=self.offload_optimizer is not None,
            offload_param=self.config.zero_config.offload_param.enabled,
            compute_dtype=str(self.compute_dtype).replace("torch.", ""),
            gas=self.config.gradient_accumulation_steps or 1,
            micro_batch=self.config.train_micro_batch_size_per_gpu)
        if self.offload_optimizer is not None:
            _attach("params", lambda e: e.state.params)
            _attach("master_params", lambda e: {"host": e.offload_optimizer.master_bytes()})
            _attach("optimizer_state", lambda e: {"host": e.offload_optimizer.moment_bytes()})
        else:
            if self.compute_dtype != torch.float32 or self._param_offload:
                _attach("params", lambda e: e._compute)
            _attach("master_params", lambda e: e.state.params)
            _attach("optimizer_state", lambda e: e.state.opt_state)
        _attach("grads", lambda e: e.state.grad_acc)

        def scalars(e):
            st = e.state
            ls = list(vars(st.loss_scale).values()) if st.loss_scale is not None else []
            return [st.step, st.skipped_steps, st.global_grad_norm] + ls

        _attach("train_scalars", scalars)

    @staticmethod
    def _batch_tokens(batch: Any) -> int:
        """Token count of one (gas-stacked) batch: the size of the first
        integer leaf of rank >= 2 ([gas, B, T] ids); 0 when the model is
        not token-based."""
        for leaf in _batch_leaves(batch):
            if len(getattr(leaf, "shape", ())) >= 2 and _is_int(leaf):
                return int(np.prod(tuple(leaf.shape)))
        return 0

    def _model_flops_per_step(self, batch: Any) -> float:
        """FLOPs one optimizer step spends on the MODEL, cached after the
        first call: the analytic ``6N + attn`` cost
        (``models.transformer.flops_per_token``) times the batch's tokens.
        A model without ``n_layers`` gives 0 (the MFU gauge stays unset:
        the JAX engine falls back to XLA's cost analysis, which has no
        counterpart here)."""
        if self._flops_per_step is not None:
            return self._flops_per_step
        mc = getattr(self.model, "config", None)
        toks = self._batch_tokens(batch)
        if mc is None or not hasattr(mc, "n_layers") or not toks:
            return 0.0
        from ..models.transformer import flops_per_token

        leaf = next(l for l in _batch_leaves(batch)
                    if len(getattr(l, "shape", ())) >= 2 and _is_int(l))
        self._flops_per_step = flops_per_token(mc, int(leaf.shape[-1])) * toks
        return self._flops_per_step

    def _report_telemetry(self, loss: Any, batch: Any, step_dt: Optional[float] = None) -> None:
        """Per-step registry updates + boundary-cadence export.

        Cheap host-side observations (phase time, watchdog, goodput) land
        every step; anything that needs a device value (loss, grad norm,
        the numerics stats) or an export write waits for the
        steps_per_print boundary, where train_batch has already drained
        the device — no extra syncs on the hot path.  ``step_dt=None``
        marks the incremental forward/backward/step path: phase times
        arrived through the timer sink already, so only the boundary
        publication runs."""
        tm = self.telemetry
        self._m_steps.inc()
        if step_dt is not None:
            self._m_phase.observe(step_dt, phase="train_batch")
            captured = getattr(self, "_timeline_captured", False)
            self._timeline_captured = False
            # a timeline-captured step's wall includes profiler overhead:
            # keep it out of the watchdog median and never rate it a stall
            stalled = False if captured else tm.observe_step_time(step_dt, self.global_steps)
            if tm.goodput is not None:
                # run-level goodput: classify this step's wall (compile
                # carve-out, stall badput, cross-attempt recompute ->
                # restart); overflow-skip steps stay productive
                tm.goodput.observe_step(step_dt, step=self.global_steps, stalled=stalled)
            self._win_time += step_dt
            self._win_steps += 1
            self._win_tokens += self._batch_tokens(batch)
        if self.global_steps % self.config.steps_per_print != 0:
            return
        if loss is not None:
            # dstpu-lint: allow[host-sync] after the steps_per_print gate: boundary cadence,
            # the queue already drained by the device fence
            self._m_loss.set(float(loss))
        self._m_lr.set(self.get_lr()[0])
        # dstpu-lint: allow[host-sync] after the steps_per_print gate: boundary cadence, the
        # queue already drained by the device fence
        self._m_grad_norm.set(float(self.state.global_grad_norm))
        self._m_loss_scale.set(self.loss_scale())
        if tm.ledger is not None:
            tm.ledger.publish()
        # dstpu-lint: allow[host-sync] after the steps_per_print gate: boundary cadence, the
        # queue already drained by the device fence
        skipped = int(self.state.skipped_steps)
        if skipped > self._skipped_pub:
            self._m_skipped.inc(skipped - self._skipped_pub)
            self._skipped_pub = skipped
        report = self.overlap_report()
        if report is not None:
            self._m_overlap_frac.set(report.overlapped_fraction)
        # no error-feedback residual state on one rank
        self._m_comp_residual.set(0)
        self._numerics_boundary(loss)
        self._mfu_window = None
        if self._win_time > 0:
            bs = self.config.train_batch_size or 1
            self._m_samples_ps.set(self._win_steps * bs / self._win_time)
            self._m_tokens_ps.set(self._win_tokens / self._win_time)
            from ..telemetry.mfu import mfu as _mfu

            # batch=None marks a boundary reached through step(): reuse
            # the cached flops if a train_batch derived them
            flops = (self._model_flops_per_step(batch) if batch is not None
                     else (self._flops_per_step or 0.0))
            if flops > 0:
                self._mfu_window = {"flops": flops * self._win_steps,
                                    "seconds": self._win_time, "steps": self._win_steps,
                                    "tokens": self._win_tokens}
                self._m_mfu.set(_mfu(flops * self._win_steps, self._win_time,
                                     n_chips=1, device=self.device))
        self._win_time, self._win_steps, self._win_tokens = 0.0, 0, 0
        if self.monitor is not None:
            self.monitor.write_registry(tm.registry, self.global_steps)
        tm.export(self.global_steps)

    def _numerics_boundary(self, loss: Any) -> None:
        """Numerics-observatory boundary (called from _report_telemetry
        INSIDE the steps_per_print gate): pull the boundary step's stats
        tree in one device-to-host copy, shape it into the sentinel's
        report, and run the sentinel.  Without a stats tree (offload,
        forward/backward/step) the sentinel watches the host scalars."""
        nm = self._numerics
        if nm is None:
            return
        from ..telemetry.numerics import pull_to_host, shape_boundary_report

        report: dict = {"step": self.global_steps}
        stats, self._last_numerics = self._last_numerics, None
        if stats is not None:
            report.update(shape_boundary_report(self._fold_numerics(pull_to_host(stats))))
        else:
            # dstpu-lint: allow[host-sync] the numerics boundary (steps_per_print cadence)
            # without a stats tree: the host scalars the sentinel watches
            report["loss"] = None if loss is None else float(loss)
            # dstpu-lint: allow[host-sync] the numerics boundary (steps_per_print cadence)
            # without a stats tree: the host scalars the sentinel watches
            report["grad_norm"] = float(self.state.global_grad_norm)
            # dstpu-lint: allow[host-sync] the numerics boundary (steps_per_print cadence)
            # without a stats tree: the host scalars the sentinel watches
            report["skipped_steps"] = int(self.state.skipped_steps)
            if self.state.loss_scale is not None:
                report["loss_scale"] = self.loss_scale()
        cfg = nm.config
        every = int(getattr(cfg, "divergence_every", 1) or 0)
        if (bool(getattr(cfg, "divergence_audit", True)) and every > 0
                and nm.boundaries % every == 0):
            div = self.divergence_audit()
            if div is not None:
                report["divergence"] = div
        nm.observe_boundary(report)

    def divergence_audit(self) -> Optional[dict]:
        """Cross-data-rank divergence audit: bit-exact checksums of the
        master params (``telemetry.numerics.leaf_checksums``) compared
        across the data axis by ``compare_rank_checksums``.  None when
        structurally inapplicable — always on one rank, as the JAX
        engine's at a data axis of 1."""
        return None

    def numerics_report(self) -> Optional[dict]:
        """Numerics observatory summary: the sentinel's rolling-window
        summary plus a fresh divergence-audit verdict.  None when the
        observatory is off."""
        if self._numerics is None:
            return None
        out = dict(self._numerics.summary())
        out["divergence"] = self.divergence_audit()
        return out

    def overlap_report(self):
        """Current exposure split of the gradient exchange
        (``telemetry/overlap.py``): None on one rank, where there is no
        exchange."""
        from ..telemetry.overlap import structural_report
        from ..telemetry.mfu import device_kind

        return structural_report(None, world=1, device_kind=device_kind(self.device),
                                 gas=self.config.gradient_accumulation_steps or 1)

    def close(self) -> None:
        """Flush and release observability sinks (telemetry exporters,
        the process defaults this engine installed, the preemption
        watcher's signal handlers, this engine's memory-ledger
        components).  Idempotent."""
        if self.telemetry is not None:
            self.telemetry.export(self.global_steps, force=True)
            self.telemetry.close()
        if self.monitor is not None:
            self.monitor.close()
        if self.resilience is not None:
            # restore the previous signal handlers — a later engine (or
            # the embedding process) owns SIGTERM/SIGINT again
            self.resilience.close()
        # release our ledger slots AFTER the final export (so it still
        # shows them); slots a newer engine claimed stay
        if getattr(self, "_ledger_components", None):
            from ..telemetry.memory import get_memory_ledger

            led = get_memory_ledger()
            for name, prov in self._ledger_components:
                led.detach(name, provider=prov)
            self._ledger_components = []

    def _report(self, loss: Any) -> None:
        cfg = self.config
        if self.monitor is not None and self.monitor.enabled and loss is not None:
            # the monitor's one host sync a step: the loss and the step the
            # schedule reads, in one copy
            # dstpu-lint: allow[host-sync] the monitor's one host sync a step (only with a
            # monitor writer on): the loss and the step in one copy
            host = torch.stack([loss.detach().float().reshape(()),
                                self.state.step.float()]).tolist()
            step = self.global_steps
            self.monitor.write_events([
                ("Train/Samples/train_loss", host[0], step),
                ("Train/Samples/lr", float(self.lr_schedule(int(host[1]))), step)])
        if cfg.wall_clock_breakdown and self.global_steps % cfg.steps_per_print == 0:
            self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER])

    # ------------------------------------------------------ state offload
    def _check_live(self) -> None:
        if self._parked:
            raise RuntimeError("the engine's state is parked in host memory "
                               "(offload_states); call reload_states() first")

    def _state_tensors(self) -> List[Any]:
        """(holder, key) of every tensor of the training state: the leaves
        of the master and compute trees, and the optimizer's and the
        accumulation buffer's lists."""
        out: List[Any] = []
        seen = set()
        for tree in (self.state.params, self._compute):  # one tree under offload_optimizer
            for p in tree.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    out.append((p, None))
        lists = [v for v in (self.state.opt_state or {}).values() if isinstance(v, list)] \
            if isinstance(self.state.opt_state, dict) else []
        if self.state.grad_acc is not None:
            lists.append(self.state.grad_acc)
        out += [(lst, k) for lst in lists for k in range(len(lst))]
        return out

    def _move_state(self, entries: List[Any], device: torch.device, pin: bool) -> None:
        moved = {}  # one copy per storage: an fp32 compute copy shares the master's
        with torch.no_grad():
            for holder, k in entries:
                t = holder.data if k is None else holder[k]
                key = (t.data_ptr(), t.dtype, tuple(t.shape))
                if key not in moved:
                    if device.type == "cpu":
                        moved[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                        moved[key].copy_(t)
                    else:
                        moved[key] = t.to(device)
                if k is None:
                    holder.data = moved[key]
                else:
                    holder[k] = moved[key]

    def offload_states(self, include: Any = None, device: str = "cpu", pin_memory: bool = True,
                       non_blocking: bool = False) -> None:
        """Park the whole training state in host memory and free the card
        (the reference's ``engine.offload_states``, used between RLHF
        phases); training calls raise until :meth:`reload_states`.  Under
        offload_optimizer the host optimizer's state is in host RAM already;
        the card's compute leaves move."""
        if self._parked:
            return
        self._parked_entries = []
        if self.device.type != "cpu":
            torch.cuda.synchronize(self.device)
            self._parked_entries = [(h, k) for h, k in self._state_tensors()
                                    if (h.data if k is None else h[k]).device.type
                                    == self.device.type]
            self._move_state(self._parked_entries, torch.device("cpu"), pin_memory)
            torch.cuda.empty_cache()
        self._parked = True
        logger.info("offload_states: training state moved to host memory")

    def reload_states(self, non_blocking: bool = False) -> None:
        """Undo :meth:`offload_states`."""
        if not self._parked:
            return
        self._move_state(self._parked_entries, self.device, False)
        self._parked_entries = []
        self._parked = False
        logger.info("reload_states: training state restored to the device")

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def zero_optimization_stage(self) -> int:
        return self.config.zero_config.stage

    def set_train_batch_size(self, train_batch_size: int) -> None:
        """Change the batch by changing only gradient accumulation (the
        micro-batch stays); the next ``train_batch`` takes batches with the
        new leading gas dim."""
        micro = self.config.train_micro_batch_size_per_gpu
        if train_batch_size % micro != 0:
            raise ValueError(f"train_batch_size {train_batch_size} not divisible by "
                             f"micro_batch*dp = {micro}")
        self.config.gradient_accumulation_steps = train_batch_size // micro
        self.config.train_batch_size = train_batch_size
        self._batch_size_changed()

    def set_train_micro_batch_size(self, micro_batch_size: int) -> None:
        """Change the micro-batch, keeping gas; the batch follows, and the
        training dataloader (when the engine made one) draws micro-batches
        of the new size."""
        self.config.train_micro_batch_size_per_gpu = int(micro_batch_size)
        self.config.train_batch_size = (int(micro_batch_size)
                                        * (self.config.gradient_accumulation_steps or 1))
        if self._training_data is not None:
            self.training_dataloader = self.deepspeed_io(self._training_data)
        self._batch_size_changed()

    def _batch_size_changed(self) -> None:
        """Everything that counts per step reads the new sizes: throughput,
        MFU's FLOPs per step, the memory ledger's hints (the FLOPs profiler
        and the loaders read the config at each step)."""
        self.tput_timer.batch_size = max(1, self.config.train_batch_size)
        self._flops_per_step = None
        if self.telemetry is not None and self.telemetry.ledger is not None:
            self.telemetry.ledger.update_context(
                gas=self.config.gradient_accumulation_steps,
                micro_batch=self.config.train_micro_batch_size_per_gpu)

    def no_sync(self):
        """The reference's ``no_sync`` context: micro-steps inside it skip
        the cross-rank gradient reduction.  One rank reduces nothing, so it
        changes no step; under ZeRO >= 2 it is refused, as in the JAX
        engine (partitioned gradients need every reduce-scatter)."""
        import contextlib

        if self.config.zero_config.stage >= 2:
            raise AssertionError(
                "no_sync is not compatible with ZeRO stage >= 2: gradients "
                "are partitioned and every micro-step's reduce-scatter is "
                "load-bearing (reference engine.no_sync assert)")
        return contextlib.nullcontext()

    def stack_microbatches(self, micro_batches: List[Any]) -> Any:
        """Stack micro-batches on a new leading (gas) dim, leaf by leaf."""
        return stack_microbatches(micro_batches)

    def start_profiler_trace(self, log_dir: str) -> None:
        """Start a ``torch.profiler`` capture of this engine's device (the
        process's one profiler session, shared with ``telemetry/
        tracing.py`` and the step timeline); raises while another runs."""
        from ..telemetry.tracing import start_trace

        if not start_trace(log_dir, self.device):
            raise RuntimeError("start_profiler_trace: a torch.profiler session is "
                               "already running")

    def stop_profiler_trace(self) -> str:
        """Wait for the launched work, stop the capture and write its Chrome
        trace under the start's ``log_dir``; returns the file's path."""
        from ..telemetry.tracing import stop_trace

        self._device_fence()
        path = stop_trace()
        if path is None:
            raise RuntimeError("stop_profiler_trace: no trace was started")
        return path
