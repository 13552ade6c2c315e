"""DeepSpeed-compatible JSON configuration — the single-device training
subset of ``deepspeed_tpu/runtime/config.py``.

Ported: the batch-size triangle (train_batch_size = micro_batch *
grad_accum * dp_world_size), the ``fp16``, ``bf16``, ``optimizer`` and
``scheduler`` blocks, ``zero_optimization.stage`` (0-3: on one rank
partitioning is the identity, so every stage is the math of stage 0),
``zero_optimization.offload_optimizer`` / ``offload_param`` / ``zenflow``
(host-RAM or NVMe optimizer state, pinned-host masters, ZenFlow;
``runtime/engine.py``), ``hybrid_engine``, ``gradient_clipping``,
``data_types.grad_accum_dtype``, ``seed``, ``steps_per_print``, the
``checkpoint`` block (which checkpoint engine ``make_checkpoint_engine``
builds) with the ``aio`` block (the fast engine's threads and block size),
and the ``activation_checkpointing`` block, which configures
``runtime/activation_checkpointing/checkpointing.py`` when present.

A block that turns on something the port does not have yet raises
``NotImplementedError`` naming the ROADMAP item that brings it; a block
that is present but off is accepted.  Unknown keys inside the ported
blocks warn and are ignored, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional

from .config_utils import AUTO, ConfigModel

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

#: ROADMAP items named by the NotImplementedError of each unported block
ROADMAP_ZERO = "ROADMAP Queue 1 #8 'ZeRO 1/2/3 across ranks'"
ROADMAP_PIPE = "ROADMAP Queue 1 #12 'Pipeline'"
ROADMAP_TELEMETRY = "ROADMAP Queue 1 #16 'Training telemetry and resilience'"
ROADMAP_COMM = "ROADMAP Queue 1 #9 'Communication and ZeRO++'"
ROADMAP_REST = "ROADMAP Queue 1 #17 'Remaining modules'"
ROADMAP_SERVING = "ROADMAP Queue 1 #15 'Serving fleet'"

#: top-level blocks whose "enabled" flag turns on an unported feature
_ENABLED_BLOCKS = {
    "telemetry": ROADMAP_TELEMETRY,
    "resilience": ROADMAP_TELEMETRY,
    "tensorboard": ROADMAP_REST,
    "wandb": ROADMAP_REST,
    "comet": ROADMAP_REST,
    "csv_monitor": ROADMAP_REST,
    "flops_profiler": ROADMAP_REST,
    "comms_logger": ROADMAP_COMM,
    "gradient_compression": ROADMAP_COMM,
    "elasticity": ROADMAP_REST,
}
#: top-level flags that are off unless true
_TRUE_FLAGS = {"sanity_checks": ROADMAP_TELEMETRY, "wall_clock_breakdown": ROADMAP_TELEMETRY,
               "prescale_gradients": ROADMAP_COMM, "memory_breakdown": ROADMAP_TELEMETRY}
#: zero_optimization keys that switch on a mechanism beyond stage 0/1
_ZERO_ON = ("zero_quantized_weights", "zero_quantized_gradients",
            "zero_hierarchical_grad_reduce", "overlap_grad_reduce", "zero3_param_prefetch",
            "grad_reduce_error_feedback")


@dataclasses.dataclass
class FP16Config(ConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class BF16Config(ConfigModel):
    enabled: bool = False
    #: an fp32 master copy of the params for the optimizer (always kept)
    master_weights: bool = True


@dataclasses.dataclass
class OffloadConfig(ConfigModel):
    """``offload_param`` / ``offload_optimizer`` (the JAX config's fields).
    ``nvme_path`` empty means ``dstpu_nvme`` under the process's temporary
    directory."""

    device: str = "none"  # none | cpu | nvme
    nvme_path: str = ""
    pin_memory: bool = True
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    ratio: float = 1.0
    max_in_cpu: int = 1_000_000_000
    #: SuperOffload: the host update fanned out over CPU workers
    super_offload: bool = False
    cpu_worker_count: int = 4

    @property
    def enabled(self) -> bool:
        return self.device not in ("none", None)

    @property
    def resolved_nvme_path(self) -> str:
        return self.nvme_path or os.path.join(tempfile.gettempdir(), "dstpu_nvme")

    def validate(self) -> None:
        if self.device not in ("none", None, "cpu", "nvme"):
            raise ValueError(f"offload device must be none, cpu or nvme, got {self.device!r}")
        if self.super_offload and not self.enabled:
            raise ValueError("super_offload requires offload_optimizer.device='cpu' (or "
                             "'nvme'); got device='none'")


@dataclasses.dataclass
class ZenFlowConfig(ConfigModel):
    """``zero_optimization.zenflow`` (the JAX config's fields)."""

    enabled: bool = False
    topk_ratio: float = 0.1  # fraction of columns on the immediate fast path
    update_interval: int = 4  # the deferred host pass's cadence (boundaries)
    full_warm_up_rounds: int = 0  # full synchronous updates first
    overlap_step: bool = True  # run the deferred pass in a background thread

    def validate(self) -> None:
        if not (0.0 < self.topk_ratio <= 1.0):
            raise ValueError(f"topk_ratio must be in (0, 1], got {self.topk_ratio}")
        if self.update_interval < 1:
            raise ValueError("update_interval must be >= 1")


@dataclasses.dataclass
class ZeroConfig(ConfigModel):
    """``zero_optimization``: the stage and the offload blocks.  One rank
    holds everything, so stages 1-3 partition nothing and run stage 0's
    math."""

    stage: int = 0
    offload_param: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    offload_optimizer: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    zenflow: ZenFlowConfig = dataclasses.field(default_factory=ZenFlowConfig)

    def validate(self) -> None:
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage must be 0-3, got {self.stage}")


@dataclasses.dataclass
class OptimizerConfig(ConfigModel):
    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ActivationCheckpointingConfig(ConfigModel):
    """The JAX config's block, field for field; ``policy`` is a remat
    policy name of ``checkpointing.POLICY_MAP``."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "nothing_saveable"


@dataclasses.dataclass
class HybridEngineConfig(ConfigModel):
    """``hybrid_engine``: training and generation on one copy of the
    weights (the JAX config's fields)."""

    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8


@dataclasses.dataclass
class AIOConfig(ConfigModel):
    """``aio`` (the JAX config's fields): the fast checkpoint engine's and
    the NVMe spill's async-I/O settings."""

    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True
    use_gds: bool = False


@dataclasses.dataclass
class CheckpointConfig(ConfigModel):
    """``checkpoint`` (the JAX config's fields).  ``load_universal``
    (resharding a checkpoint across ranks) raises: the partitioned layout
    comes with ZeRO across ranks."""

    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    async_save: bool = False
    writer: str = ""  # "" | nebula | datastates (async engine flavors)

    def validate(self) -> None:
        if self.load_universal:
            raise NotImplementedError(f"checkpoint.load_universal: the universal and "
                                      f"partitioned layouts are not ported yet ({ROADMAP_ZERO})")


@dataclasses.dataclass
class SchedulerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _refuse_unported(config: Dict[str, Any]) -> None:
    """Raise for any block that enables something not ported yet."""
    for key, item in _ENABLED_BLOCKS.items():
        block = config.get(key)
        if isinstance(block, dict) and block.get("enabled"):
            raise NotImplementedError(f"'{key}' is not ported yet ({item})")
    for key, item in _TRUE_FLAGS.items():
        if config.get(key):
            raise NotImplementedError(f"'{key}' is not ported yet ({item})")
    zero = config.get("zero_optimization") or {}
    for key in _ZERO_ON:
        if zero.get(key):
            raise NotImplementedError(
                f"zero_optimization.{key} is not ported yet ({ROADMAP_COMM})")
    mics = zero.get("mics_shard_size", -1)
    if mics not in (-1, None, 0, 1):
        raise NotImplementedError(f"zero_optimization.mics_shard_size is not ported yet "
                                  f"({ROADMAP_ZERO})")
    mesh = config.get("mesh") or {}
    for axis, size in mesh.items():
        if axis != "axis_order" and size not in (-1, 1):
            raise NotImplementedError(
                f"mesh axis {axis}={size}: the port trains on one device ({ROADMAP_ZERO})")
    if (config.get("pipeline") or {}).get("hop_compression") not in (None, False):
        raise NotImplementedError(f"pipeline is not ported yet ({ROADMAP_PIPE})")
    if config.get("serving"):
        raise NotImplementedError(f"the serving block is not ported yet ({ROADMAP_SERVING})")
    if (config.get("communication_data_type") is not None
            or float(config.get("gradient_predivide_factor", 1.0)) != 1.0):
        raise NotImplementedError(f"gradient communication settings are not ported yet "
                                  f"({ROADMAP_COMM})")


@dataclasses.dataclass
class DeepSpeedConfig:
    """Parsed top-level config (a dict or a JSON path)."""

    raw: Dict[str, Any]
    train_batch_size: Optional[int]
    train_micro_batch_size_per_gpu: Optional[int]
    gradient_accumulation_steps: Optional[int]
    steps_per_print: int
    gradient_clipping: float
    seed: int
    fp16: FP16Config
    bf16: BF16Config
    zero_config: ZeroConfig
    hybrid_engine: HybridEngineConfig
    optimizer: OptimizerConfig
    scheduler: SchedulerConfig
    activation_checkpointing: ActivationCheckpointingConfig
    gradient_accumulation_dtype: str
    aio: AIOConfig
    checkpoint: CheckpointConfig

    def __init__(self, config: Any, dp_world_size: Optional[int] = None):
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        if config is None:
            config = {}
        if not isinstance(config, dict):
            raise TypeError(f"config must be a dict or json path, got {type(config)}")
        self.raw = config
        _refuse_unported(config)

        g = config.get
        self.train_batch_size = _maybe_int(g(TRAIN_BATCH_SIZE))
        self.train_micro_batch_size_per_gpu = _maybe_int(g(TRAIN_MICRO_BATCH_SIZE_PER_GPU))
        self.gradient_accumulation_steps = _maybe_int(g(GRADIENT_ACCUMULATION_STEPS))
        self.steps_per_print = max(1, int(g("steps_per_print", 10) or 1))
        self.gradient_clipping = float(g("gradient_clipping", 0.0))
        self.seed = int(g("seed", 1234))
        self.gradient_accumulation_dtype = (g("data_types") or {}).get(
            "grad_accum_dtype", "fp32") or "fp32"
        if self.gradient_accumulation_dtype not in ("fp32", "fp16", "bf16"):
            raise ValueError(f"data_types.grad_accum_dtype must be fp32, fp16 or bf16, got "
                             f"{self.gradient_accumulation_dtype!r}")

        self.fp16 = FP16Config.from_dict(g("fp16"))
        self.bf16 = BF16Config.from_dict(g("bf16") or g("bfloat16"))
        zero = g("zero_optimization") or {}
        self.zero_config = ZeroConfig.from_dict(
            {f.name: zero[f.name] for f in dataclasses.fields(ZeroConfig) if f.name in zero})
        self.hybrid_engine = HybridEngineConfig.from_dict(g("hybrid_engine"))
        self.optimizer = OptimizerConfig.from_dict(g("optimizer"))
        self.scheduler = SchedulerConfig.from_dict(g("scheduler"))
        self.aio = AIOConfig.from_dict(g("aio"))
        self.checkpoint = CheckpointConfig.from_dict(g("checkpoint"))
        self.activation_checkpointing = ActivationCheckpointingConfig.from_dict(
            g("activation_checkpointing"))
        if g("activation_checkpointing") is not None:
            from .activation_checkpointing import checkpointing

            checkpointing.configure(deepspeed_config=self)

        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        if dp_world_size is not None:
            self.resolve_batch_size(dp_world_size)

    # -- batch-size triangle ------------------------------------------------
    def resolve_batch_size(self, dp_world_size: int) -> None:
        """train_batch = micro_batch * grad_accum * dp_world_size: any two
        determine the third; one alone takes the others as 1 or derived;
        none gives micro 1, gas 1."""
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if all(v is not None for v in (tb, mb, gas)):
            if tb != mb * gas * dp_world_size:
                raise ValueError(
                    f"Batch-size inconsistency: train_batch_size={tb} != "
                    f"micro({mb}) * gas({gas}) * dp({dp_world_size})")
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp_world_size)
            if gas * mb * dp_world_size != tb:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by micro*dp = {mb * dp_world_size}")
        elif tb is not None and gas is not None:
            mb = tb // (gas * dp_world_size)
            if mb * gas * dp_world_size != tb:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by gas*dp = {gas * dp_world_size}")
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            mb = tb // dp_world_size
            gas = 1
            if mb * dp_world_size != tb:
                raise ValueError(f"train_batch_size {tb} not divisible by dp {dp_world_size}")
        else:
            mb, gas = 1, 1
            tb = mb * gas * dp_world_size
        self.train_batch_size, self.train_micro_batch_size_per_gpu = tb, mb
        self.gradient_accumulation_steps = gas

    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def compute_dtype(self):
        import torch

        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32


def _maybe_int(v: Any) -> Optional[int]:
    if v is None or v == AUTO:
        return None
    return int(v)
