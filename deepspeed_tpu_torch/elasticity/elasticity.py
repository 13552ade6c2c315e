"""Elastic training configuration (``deepspeed_tpu/elasticity/elasticity.py``).

``compute_elastic_config`` picks the global batch size, at most
``max_train_batch_size``, that the most world sizes in ``[min_gpus,
max_gpus]`` can split into whole micro-batches, so a job restarted at
another scale keeps its hyperparameters; with a world size it also gives
that world's micro batch and gradient-accumulation steps, which
``deepspeed_tpu_torch.initialize`` applies.  ``ensure_immutable_elastic_
config`` refuses an elastic block that changed across restarts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..runtime.config_utils import ConfigModel


@dataclasses.dataclass
class ElasticityConfig(ConfigModel):
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = dataclasses.field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    prefer_larger_batch: bool = True
    ignore_non_elastic_batch_info: bool = False
    version: float = 0.2


def _candidate_batches(base_list: List[int], max_acc_step: int = 4) -> List[int]:
    return sorted({mb * acc for mb in base_list for acc in range(1, max_acc_step + 1)})


def get_compatible_gpus(micro_batches: List[int], max_train_batch_size: int,
                        min_gpus: int, max_gpus: int) -> Tuple[int, List[int]]:
    """The train batch (at most the maximum) that the most world sizes
    divide into a whole number of some micro batch, and those sizes; ties
    go to the larger batch."""
    best_batch, best_gpus = 0, []
    for batch in _candidate_batches(micro_batches):
        if batch > max_train_batch_size:
            continue
        valid = [g for g in range(min_gpus, min(max_gpus, batch) + 1)
                 if batch % g == 0 and any((batch // g) % mb == 0 for mb in micro_batches)]
        if (len(valid), batch) > (len(best_gpus), best_batch):
            best_batch, best_gpus = batch, valid
    return best_batch, best_gpus


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "",
                           world_size: int = 0) -> Tuple[int, List[int], Dict]:
    """``(final_batch_size, valid_gpus, info)``; with ``world_size`` the
    info also holds ``micro_batch_per_gpu`` (the largest configured micro
    batch that divides the per-process share) and
    ``gradient_accumulation_steps``."""
    ecfg = ElasticityConfig.from_dict(ds_config.get("elasticity", {}))
    if not ecfg.enabled:
        raise ValueError("elasticity not enabled in config")
    batch, gpus = get_compatible_gpus(ecfg.micro_batch_sizes, ecfg.max_train_batch_size,
                                      ecfg.min_gpus, ecfg.max_gpus)
    if batch == 0:
        raise ValueError("no compatible elastic batch size found")
    info: Dict = {"final_batch_size": batch, "valid_gpus": gpus}
    if world_size:
        if world_size not in gpus:
            raise ValueError(f"world size {world_size} not in valid gpus {gpus}")
        per = batch // world_size
        mb = max(m for m in ecfg.micro_batch_sizes if per % m == 0)
        info["micro_batch_per_gpu"] = mb
        info["gradient_accumulation_steps"] = per // mb
    return batch, gpus, info


def ensure_immutable_elastic_config(runtime_config: Dict, saved_config: Dict) -> None:
    """Raise if the elastic block differs from the one a run was saved
    with: the global batch would no longer be the same across restarts."""
    a = ElasticityConfig.from_dict(runtime_config.get("elasticity", {}))
    b = ElasticityConfig.from_dict(saved_config.get("elasticity", {}))
    if a.to_dict() != b.to_dict():
        raise ValueError("elastic config changed across restarts; this breaks "
                         "batch-size consistency guarantees")


def apply_elastic_config(ds_config, world_size: int) -> Dict:
    """Set a parsed ``DeepSpeedConfig``'s batch sizes from its elastic
    block for ``world_size`` processes (``initialize``'s step, the JAX
    package's ``deepspeed_tpu/__init__.py:81-104``): refused when the
    config also sets a batch size, unless ``ignore_non_elastic_batch_info``.
    Returns the info of :func:`compute_elastic_config`."""
    ecfg = (ds_config.raw or {}).get("elasticity", {})
    explicit = any(v is not None for v in (ds_config.train_batch_size,
                                           ds_config.train_micro_batch_size_per_gpu,
                                           ds_config.gradient_accumulation_steps))
    if explicit and not ecfg.get("ignore_non_elastic_batch_info"):
        raise ValueError(
            "elasticity is enabled but batch sizes are set explicitly; "
            "remove them or set elasticity.ignore_non_elastic_batch_info "
            "(reference elasticity v0.1/0.2 contract)")
    batch, _, info = compute_elastic_config(ds_config.raw, world_size=world_size)
    ds_config.train_batch_size = batch
    ds_config.train_micro_batch_size_per_gpu = info["micro_batch_per_gpu"]
    ds_config.gradient_accumulation_steps = info["gradient_accumulation_steps"]
    return info
