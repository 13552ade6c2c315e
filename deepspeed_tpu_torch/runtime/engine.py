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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device
from ..models.convert import adopt_params
from ..models.transformer import ParamTree
from ..utils.logging import logger
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader, RepeatingLoader, to_device
from .zero.boundary import OffloadBoundary
from .zero.offload import clip_coefficient
from .lr_schedules import LRSchedulerShim, get_schedule
from .module import ModelSpec, as_model_spec
from .optimizers import build_optimizer
from .precision import (LossScaleState, cast_tree, check_overflow, clip_by_global_norm,
                        global_grad_norm, update_loss_scale)

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
        self.state = self._init_state(model_parameters,
                                      self.config.seed if seed is None else seed)
        self._compute_leaves = [p for _, p in self._compute.named_parameters()]
        self._compute_fresh = True
        self._boundary = (OffloadBoundary(self._compute_leaves, self._pin)
                          if self.offload_optimizer is not None else None)
        logger.info(f"DeepSpeedTPUEngine (torch) initialized: device={self.device} "
                    f"zero_stage={self.config.zero_config.stage} dtype={self.compute_dtype} "
                    f"micro_bs={self.config.train_micro_batch_size_per_gpu} "
                    f"gas={self.config.gradient_accumulation_steps} "
                    f"offload_optimizer={self.offload_optimizer is not None} "
                    f"offload_param={self._param_offload}")

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

    def _micro_grads(self, batch: Any, want_overflow: bool = False):
        """One micro-batch: (grads in grad_accum_dtype, loss, the fp16
        overflow verdict over the post-cast grads when ``want_overflow``)."""
        params = self._compute_params()
        loss = self.model.loss_fn(params, batch, None)
        scaled = loss.float() * self.state.loss_scale.cur_scale if self.fp16_enabled else loss
        grads = torch.autograd.grad(scaled, self._compute_leaves, allow_unused=True)
        grads = [torch.zeros(c.shape, dtype=self.grad_accum_dtype, device=c.device)
                 if g is None else g.to(self.grad_accum_dtype)
                 for g, c in zip(grads, self._compute_leaves)]
        bad = check_overflow(grads) if self.fp16_enabled and want_overflow else None
        return grads, loss.detach().float(), bad

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
            denom = float(gas) * st.loss_scale.cur_scale
            for g in grads:
                g.div_(denom)
        else:
            for g in grads:
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
        lr = float(self.lr_schedule(int(st.step)))
        denom = float(gas)
        if self.fp16_enabled:
            if overflow is None:
                overflow = check_overflow(src)
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

    def _train_batch(self, batches: Any) -> torch.Tensor:
        gas = self.config.gradient_accumulation_steps or 1
        if gas == 1:
            grads, loss, bad = self._micro_grads(_index(batches, 0),
                                                 want_overflow=self.fp16_enabled)
            self._apply_step(grads_src=grads, overflow=bad)
            return loss
        losses = []
        for i in range(gas):
            grads, loss, _ = self._micro_grads(_index(batches, i))
            self._accumulate(grads)
            del grads  # free this micro-step's grads before the next backward
            losses.append(loss)
        self._apply_step()
        return torch.stack(losses).mean()

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
        if self._acc_dirty:
            # abandoned forward() micro-steps: drop their accumulation
            self.state.grad_acc = None
            self.state.micro_step = 0
            self.micro_steps -= self.micro_steps % gas
            self._acc_dirty = False
        loss = self._train_batch(to_device(batch, self.device))
        self.global_steps += 1
        self.micro_steps += gas
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
        ``partitioned=True`` (per-rank shard files) raises: one rank."""
        from ..checkpoint import saving

        if partitioned:
            saving.refuse_partitioned("save_checkpoint(partitioned=True)")
        return saving.save_checkpoint(self, save_dir, tag=tag, client_state=client_state)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True) -> Tuple[Optional[str], dict]:
        """Verified load: the tag is resolved through the commit protocol
        (checksums checked; a corrupt newest tag is counted and skipped for
        the previous good one; an explicit corrupt tag raises
        ``CorruptCheckpointError``; a tag without a manifest loads
        unverified).  Returns (path, client_state), or (None, {})."""
        from ..checkpoint import saving
        from ..resilience.commit import resolve_tag

        resolved, report = resolve_tag(load_dir, tag)
        if resolved is None:
            logger.warning(f"no loadable checkpoint in {load_dir}; nothing loaded")
            return None, {}
        return saving.load_checkpoint(self, load_dir, tag=resolved,
                                      load_optimizer_states=load_optimizer_states,
                                      load_lr_scheduler_states=load_lr_scheduler_states,
                                      verified=report["verified"])

    def forward(self, batch: Any) -> torch.Tensor:
        """DeepSpeed-compatible micro-step: loss AND gradients in one pass
        (accumulated); ``backward`` then only counts the micro-step."""
        self._check_live()
        grads, loss, _ = self._micro_grads(to_device(batch, self.device))
        self._accumulate(grads)
        self._acc_dirty = True
        self._cached_loss = loss
        return loss

    __call__ = forward

    def backward(self, loss: Any = None) -> Any:
        self.micro_steps += 1
        return loss if loss is not None else self._cached_loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % (self.config.gradient_accumulation_steps or 1) == 0

    def step(self) -> None:
        """The optimizer at the gas boundary."""
        self._check_live()
        if self.is_gradient_accumulation_boundary():
            self._apply_step()
            self._acc_dirty = False
            self.global_steps += 1
            self.lr_scheduler.step()

    def eval_batch(self, batch: Any) -> Any:
        """The model's ``apply_fn`` (else its loss) on the compute copy."""
        self._check_live()
        batch = to_device(batch, self.device)
        with torch.no_grad():
            p = self._compute_params()
            if self.model.apply_fn is not None:
                return self.model.apply_fn(p, batch)
            return self.model.loss_fn(p, batch, None)

    # ---------------------------------------------------------- accessors
    def get_lr(self) -> List[float]:
        return [float(self.lr_schedule(int(self.state.step)))]

    def get_global_grad_norm(self) -> float:
        return float(self.state.global_grad_norm)

    def loss_scale(self) -> float:
        if self.state.loss_scale is None:
            return 1.0
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
