"""Activation checkpointing — the port's counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``.

The same module-level API (``configure``, ``get_policy``, ``checkpoint``,
``checkpoint_wrapper``, ``is_configured``) and the same ``POLICY_MAP``
names, over ``torch.utils.checkpoint`` with ``use_reentrant=False``:

* ``nothing_saveable``, and every name that maps to ``None``: the whole
  block is recomputed in the backward;
* ``everything_saveable``: nothing is recomputed (the function runs as is);
* ``dots_saveable`` / ``checkpoint_dots``: the outputs of the matmuls are
  kept and the rest is recomputed, through torch's selective checkpoint;
  ``dots_with_no_batch_dims_saveable`` keeps only the 2-D ones.

What counts as a "dot": the matmuls PyTorch dispatches as ``aten.mm`` /
``aten.addmm`` (and, with batch dims, ``aten.bmm`` / ``aten.baddbmm``):
every projection, the router, the LM head and the capacity path's
einsums.  The port's hand-written kernels (flash attention A, the grouped
matmul G) run through ``ctypes`` inside autograd Functions, which a
selective-checkpoint policy cannot see: they are recomputed, as JAX's dots
policies recompute its Pallas calls on the TPU (a ``pallas_call`` is not a
``dot_general``).

The recompute runs the same deterministic kernels on the same inputs, so
losses and gradients with checkpointing are bit-equal to those without.
``torch.utils.checkpoint`` restores only the global RNG state; a
``torch.Generator`` passed to the checkpointed function itself (noisy
gating's ``generator=``) is held too: the recompute draws from the state
the forward started from, and the generator is left as it was before the
recompute.

``cpu_checkpointing`` (whatever the policy) and the ``offload_dots``
policy move the block's residuals to host memory, as the JAX module's
``save_and_offload_only_these_names`` policy offloads them to pinned host:
the block runs under ``torch.autograd.graph.save_on_cpu(pin_memory=True)``,
so every tensor its backward saves (the matmul outputs among them) is
copied to pinned host memory in the forward and back in the backward, and
nothing is recomputed.  The backward reads the very values the forward
saved, so losses and gradients stay bit-equal to those without.
``partition_activations`` shards the saved residuals over model-parallel
ranks, which one device does not have: accepted, nothing to do.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, FrozenSet, Optional

import torch

from ...utils.logging import logger

_CONFIG = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "policy": "nothing_saveable",
    "number_checkpoints": None,
    "profile": False,
}

POLICY_MAP = {
    # DeepSpeed-ish names -> the JAX package's jax.checkpoint_policies names
    "nothing_saveable": "nothing_saveable",
    "everything_saveable": "everything_saveable",
    "dots_saveable": "dots_saveable",
    "checkpoint_dots": "dots_saveable",
    "dots_with_no_batch_dims_saveable": "dots_with_no_batch_dims_saveable",
    "save_anything_except_these_names": None,
    "offload_dots": "save_and_offload_only_these_names",
}

_aten = torch.ops.aten


@dataclasses.dataclass(frozen=True)
class Policy:
    """A remat policy: its JAX name and the aten ops whose outputs it keeps
    (empty: recompute everything; None: keep everything), and whether the
    kept residuals live in pinned host memory (``offload``).  Called as a
    selective-checkpoint policy function."""

    name: str
    saves: Optional[FrozenSet[Any]]
    offload: bool = False

    def __call__(self, ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy

        if self.saves is not None and op.overloadpacket in self.saves:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {p.name: p for p in (
    Policy("nothing_saveable", frozenset()),
    Policy("everything_saveable", None),
    Policy("dots_saveable", frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm})),
    Policy("dots_with_no_batch_dims_saveable", frozenset({_aten.mm, _aten.addmm})),
    Policy("save_and_offload_only_these_names", None, offload=True),
)}


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              policy: Optional[str] = None) -> None:
    """Reference-compatible configure (checkpointing.py:892)."""
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing", None)
        if ac is not None:
            _CONFIG["partition_activations"] = ac.partition_activations
            _CONFIG["cpu_checkpointing"] = ac.cpu_checkpointing
            _CONFIG["policy"] = ac.policy
            _CONFIG["number_checkpoints"] = ac.number_checkpoints
            _CONFIG["profile"] = ac.profile
    if partition_activations is not None:
        _CONFIG["partition_activations"] = partition_activations
    if checkpoint_in_cpu is not None:
        _CONFIG["cpu_checkpointing"] = checkpoint_in_cpu
    if num_checkpoints is not None:
        _CONFIG["number_checkpoints"] = num_checkpoints
    if policy is not None:
        _CONFIG["policy"] = policy


def get_policy(name: Optional[str] = None) -> Optional[Policy]:
    """The :class:`Policy` for ``name`` (default: the configured one), or
    None (recompute the whole block) where the JAX module's is None.  With
    ``cpu_checkpointing`` configured, the offloading policy whatever the
    name, as the JAX module returns."""
    name = name or _CONFIG["policy"]
    mapped = POLICY_MAP.get(name, name)
    pol = None if mapped is None else _POLICIES.get(mapped)
    if mapped is not None and pol is None:
        logger.warning(f"unknown remat policy '{name}'; saving nothing")
    if _CONFIG["cpu_checkpointing"]:
        return _POLICIES["save_and_offload_only_these_names"]
    return pol


def _hold_generators(function: Callable, args, kwargs) -> Callable:
    """``function``, run so that its recompute draws what its forward drew
    from every ``torch.Generator`` among ``args`` / ``kwargs``, and leaves
    each generator where it was before the recompute."""
    gens = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Generator)]
    if not gens:
        return function
    start = [g.get_state() for g in gens]
    calls = []

    @functools.wraps(function)
    def run(*a, **k):
        if not calls:  # the forward
            calls.append(1)
            return function(*a, **k)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            return function(*a, **k)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return run


def _run(function: Callable, pol: Optional[Policy], args, kwargs) -> Any:
    if pol is not None and pol.offload:  # every residual to pinned host memory
        with torch.autograd.graph.save_on_cpu(pin_memory=True):
            return function(*args, **kwargs)
    if pol is not None and pol.saves is None:  # everything saveable
        return function(*args, **kwargs)
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    function = _hold_generators(function, args, kwargs)
    if pol is None or not pol.saves:
        return torch_checkpoint(function, *args, use_reentrant=False, **kwargs)
    return torch_checkpoint(function, *args, use_reentrant=False,
                            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                         pol), **kwargs)


def checkpoint(function: Callable, *args, **kwargs) -> Any:
    """Reference-compatible functional API: ``function(*args, **kwargs)``
    under the configured policy (CheckpointFunction.apply equivalent)."""
    return _run(function, get_policy(), args, kwargs)


def checkpoint_wrapper(function: Callable, policy: Optional[str] = None) -> Callable:
    """``function`` under ``policy`` (default: the configured one)."""
    pol = get_policy(policy)

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return _run(function, pol, args, kwargs)

    return wrapped


def is_configured() -> bool:
    return True
