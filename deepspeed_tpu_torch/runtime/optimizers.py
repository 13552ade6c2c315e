"""Optimizer factory — the adam family of ``deepspeed_tpu/runtime/
optimizers.py``.

An optimizer here is a :class:`GradientTransformation`, the optax
contract over lists of tensors (one entry per parameter leaf):
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, the updates being added to the params.  The fused-kernel optimizer
adds ``direct_update(grads, state, params)``, which writes the new params
and moments in place through kernel C (``ops/fused_adam.py``) and is what
the engine calls.

The learning rate is ``schedule(state["step"])`` at the 0-based count of
applied updates, a 0-d tensor on the params' device; the bias correction
is 1-based, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.fused_adam import fused_adam_update

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "deepspeedcpuadam"
ADAM_FAMILY = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM)

#: the optimizers of the JAX package not ported yet, and where they wait
ROADMAP_OPTIMIZERS = "ROADMAP Queue 1 #2a 'Other optimizers'"
NOT_PORTED = ("lamb", "lion", "fusedlion", "deepspeedcpulion", "adagrad", "sgd", "muon",
              "onebitadam", "zerooneadam", "onebitlamb")


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class DirectTransformation(NamedTuple):
    """(init, update) plus ``direct_update(grads, state, params) -> None``,
    which updates params and moments in place through the kernel (the JAX
    version returns new params; here the optimizer owns the buffers)."""

    init: Callable
    update: Callable
    direct_update: Callable


def _adam_args(params: Dict[str, Any]) -> Dict[str, float]:
    betas = params.get("betas", (0.9, 0.999))
    return dict(b1=float(betas[0]), b2=float(betas[1]), eps=float(params.get("eps", 1e-8)))


def _mu_dtype(params: Dict[str, Any]) -> Optional[torch.dtype]:
    """Optional first-moment storage dtype ("bf16"); None = fp32."""
    name = str(params.get("mu_dtype", "")).lower()
    if not name:
        return None
    table = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "fp32": torch.float32, "float32": torch.float32}
    if name not in table:
        raise ValueError(f"optimizer params mu_dtype {name!r} not supported "
                         f"(use one of {sorted(table)})")
    return table[name]


def build_optimizer(name: Optional[str], params: Dict[str, Any],
                    schedule: Callable) -> Tuple[Any, float]:
    """Returns (transformation, base_lr).  AdamW decay is decoupled (torch
    AdamW); Adam adds L2 decay to the gradient."""
    name = (name or ADAMW_OPTIMIZER).lower()
    params = dict(params or {})
    base_lr = float(params.get("lr", 1e-3))
    wd = float(params.get("weight_decay", 0.0))
    if name in NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet ({ROADMAP_OPTIMIZERS}); "
                                  f"the adam family is: {list(ADAM_FAMILY)}")
    if name not in ADAM_FAMILY:
        raise ValueError(f"Unknown optimizer '{name}'")
    a = _adam_args(params)
    # plain "adamw" forces decoupled decay; the others read adam_w_mode
    # (reference FusedAdam defaults it to True)
    adam_w_mode = True if name == ADAMW_OPTIMIZER else bool(params.get("adam_w_mode", True))
    mu = _mu_dtype(params)
    if params.get("fused_kernel"):
        return fused_adam(schedule, a["b1"], a["b2"], a["eps"], wd, adam_w_mode,
                          mu_dtype=mu), base_lr
    return adam(schedule, a["b1"], a["b2"], a["eps"], wd, adam_w_mode, mu_dtype=mu), base_lr


def _init(params: Sequence[torch.Tensor], mu_dtype: Optional[torch.dtype]) -> Dict[str, Any]:
    device = params[0].device if params else None
    return {"m": [torch.zeros(p.shape, dtype=mu_dtype or torch.float32, device=p.device)
                  for p in params],
            "v": [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params],
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adam(schedule: Callable, b1: float, b2: float, eps: float, wd: float,
         adam_w_mode: bool = True, mu_dtype: Optional[torch.dtype] = None
         ) -> GradientTransformation:
    """Adam/AdamW as plain torch ops, the update of optax's ``adamw`` (or
    ``add_decayed_weights`` then ``adam``): moments in fp32 (the first one
    stored in ``mu_dtype``), ``m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)``,
    decoupled decay added to the update, scaled by ``-lr``."""

    def init(params):
        return _init(params, mu_dtype)

    def update(grads, state, params):
        lr = schedule(state["step"])
        count = state["step"] + 1
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), count.float())
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), count.float())
        updates: List[torch.Tensor] = []
        new_m, new_v = [], []
        for g, m, v, p in zip(grads, state["m"], state["v"], params):
            if wd and not adam_w_mode:
                g = g + wd * p
            # optax's b1 * m on a bf16 moment: JAX's weak typing rounds the
            # Python b1 to bf16, and XLA keeps the product in fp32
            b1_m = float(torch.tensor(b1, dtype=m.dtype))
            mf = (1 - b1) * g + b1_m * m.float()
            vf = (1 - b2) * g ** 2 + b2 * v
            u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
            if wd and adam_w_mode:
                u = u + wd * p
            updates.append(-lr * u)
            new_m.append(mf.to(mu_dtype or torch.float32))
            new_v.append(vf)
        return updates, {"m": new_m, "v": new_v, "step": count.to(torch.int32)}

    return GradientTransformation(init, update)


def fused_adam(schedule: Callable, b1: float, b2: float, eps: float, wd: float,
               adam_w_mode: bool = True, mu_dtype: Optional[torch.dtype] = None
               ) -> DirectTransformation:
    """AdamW/Adam as one kernel C launch per leaf (the JAX
    ``pallas_fused_adam``): p, m and v read once and written once.  The
    schedule's lr and the 1-based step ride in a two-float device tensor."""

    def init(params):
        return _init(params, mu_dtype)

    def direct_update(grads, state, params):
        lr = schedule(state["step"])
        step = state["step"] + 1
        scalars = torch.stack([step.to(torch.float32), lr.to(torch.float32)])
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            fused_adam_update(p, g.float().contiguous(), m, v, scalars, beta1=b1, beta2=b2,
                              eps=eps, weight_decay=wd, adam_w_mode=adam_w_mode)
        state["step"] = step

    def update(grads, state, params):
        # optax contract for generic callers: the step as a delta, on copies
        new_p = [p.detach().clone() for p in params]
        new_state = {"m": [m.clone() for m in state["m"]],
                     "v": [v.clone() for v in state["v"]], "step": state["step"]}
        direct_update(grads, new_state, new_p)
        return [a - b for a, b in zip(new_p, params)], new_state

    return DirectTransformation(init, update, direct_update)
