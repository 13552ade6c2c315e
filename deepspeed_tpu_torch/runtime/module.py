"""Model contract (the port's counterpart of ``deepspeed_tpu/runtime/
module.py``).

A :class:`ModelSpec` carries what the engines need, as plain functions:

  * ``init_params(generator, device) -> params`` — random parameters drawn
    from an explicit ``torch.Generator`` on an explicit device;
  * ``loss_fn(params, batch, rng) -> scalar loss`` — the training step body
    (``rng`` is unused by the ported models: dropout is 0);
  * ``apply_fn(params, batch) -> outputs`` — the eval forward, optional;
  * ``flops_per_sample`` — for MFU, optional;
  * ``config`` — the model configuration, when there is one.

The JAX contract's partition rules shard over a mesh; the port trains on
one device, so it has none yet.  The flax adapters have no counterpart.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..accelerator import DeviceLike, resolve_device


class ModelSpec:
    def __init__(self, config: Any,
                 init_params: Callable[[torch.Generator, torch.device], Any],
                 loss_fn: Optional[Callable[[Any, Any, Any], Any]] = None,
                 apply_fn: Optional[Callable[[Any, Any], Any]] = None,
                 flops_per_sample: Optional[float] = None):
        self.config = config
        self._init_params = init_params
        self.loss_fn = loss_fn
        self.apply_fn = apply_fn
        self.flops_per_sample = flops_per_sample

    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> Any:
        """Random parameters drawn from ``generator``, which must live on
        ``device`` (a CUDA generator for CUDA parameters).  ``device``
        None means ``cuda``, as everywhere in the port."""
        return self._init_params(generator, resolve_device(device))


def as_model_spec(model: Any) -> ModelSpec:
    """A ModelSpec, or an object with ``init_params`` and ``loss_fn``
    adapted onto one.  Training needs the loss: a spec without one raises."""
    if isinstance(model, ModelSpec):
        spec = model
    elif hasattr(model, "init_params") and hasattr(model, "loss_fn"):
        spec = ModelSpec(getattr(model, "config", None), model.init_params, model.loss_fn,
                         getattr(model, "apply_fn", None),
                         getattr(model, "flops_per_sample", None))
    else:
        raise TypeError(f"Cannot adapt {type(model)} to ModelSpec")
    if spec.loss_fn is None:
        raise ValueError("the model has no loss_fn: training needs "
                         "loss_fn(params, batch, rng) -> scalar")
    return spec
