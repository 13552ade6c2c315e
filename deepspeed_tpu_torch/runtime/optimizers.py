"""Optimizer factory — the counterpart of ``deepspeed_tpu/runtime/
optimizers.py``: the adam family, lamb, lion (``fusedlion``,
``deepspeedcpulion``), adagrad, sgd (momentum, nesterov), muon and the
1-bit family (``runtime/fp16/onebit.py``).

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

The JAX package builds the optimizers other than Adam from optax, whose
updates run as XLA ops and no Pallas kernel; here each is the same
formula in plain tensor ops (:func:`lamb`, :func:`lion`, :func:`adagrad`,
:func:`sgd`, :func:`muon`), with optax's defaults where the JAX factory
leaves them (adagrad's initial accumulator 0.1; muon's Newton-Schulz
coefficients, 5 steps, beta 0.95 and Nesterov momentum on both halves).
Muon takes 2-D leaves by Newton-Schulz and the others by Adam: the port's
per-layer weights are 2-D, where the JAX tree stacks them into 3-D leaves
(which its muon sends to Adam), so the two trees split differently.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.fused_adam import fused_adam_update

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "deepspeedcpuadam"
ADAM_FAMILY = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM)
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZERS = ("lion", "fusedlion", "deepspeedcpulion")
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
MUON_OPTIMIZER = "muon"
ONEBIT_ADAM = "onebitadam"
ZERO_ONE_ADAM = "zerooneadam"
ONEBIT_LAMB = "onebitlamb"
#: optax.contrib.muon's Newton-Schulz coefficients and step count
MUON_NS_COEFFS = (3.4445, -4.7750, 2.0315)
MUON_NS_STEPS = 5


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
    if name in (ONEBIT_ADAM, ZERO_ONE_ADAM, ONEBIT_LAMB):
        from .fp16.onebit import one_bit_adam, one_bit_lamb, zero_one_adam

        a = _adam_args(params)
        common = dict(learning_rate=schedule, b1=a["b1"], b2=a["b2"], weight_decay=wd)
        if name == ONEBIT_ADAM:
            return one_bit_adam(**common, eps=a["eps"],
                                freeze_step=int(params.get("freeze_step", 100))), base_lr
        if name == ZERO_ONE_ADAM:
            return zero_one_adam(**common, eps=a["eps"],
                                 var_freeze_step=int(params.get("var_freeze_step", 100)),
                                 var_update_interval=int(params.get("var_update_interval", 16))
                                 ), base_lr
        return one_bit_lamb(**common, eps=float(params.get("eps", 1e-6)),
                            freeze_step=int(params.get("freeze_step", 100))), base_lr
    if name == LAMB_OPTIMIZER:
        a = _adam_args(params)
        return lamb(schedule, a["b1"], a["b2"], a["eps"], wd), base_lr
    if name in LION_OPTIMIZERS:
        betas = params.get("betas", (0.9, 0.99))
        return lion(schedule, float(betas[0]), float(betas[1]), wd), base_lr
    if name == ADAGRAD_OPTIMIZER:
        return adagrad(schedule, float(params.get("eps", 1e-10))), base_lr
    if name == SGD_OPTIMIZER:
        return sgd(schedule, float(params.get("momentum", 0.0)),
                   bool(params.get("nesterov", False))), base_lr
    if name == MUON_OPTIMIZER:
        a = _adam_args(params)
        return muon(schedule, a["b1"], a["b2"], wd), base_lr
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


# ---------------------------------------------------------------------------
# the optax optimizers of the JAX factory, as plain tensor ops
# ---------------------------------------------------------------------------
def _count_state(params, *names, fill: float = 0.0) -> Dict[str, Any]:
    device = params[0].device if params else None
    st: Dict[str, Any] = {n: [torch.full(p.shape, fill, dtype=torch.float32, device=p.device)
                              for p in params] for n in names}
    st["step"] = torch.zeros((), dtype=torch.int32, device=device)
    return st


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** count`` in fp32 (optax's ``bias_correction``)."""
    return 1 - torch.pow(torch.tensor(decay, dtype=torch.float32, device=count.device),
                         count.float())


def _sgd_like(schedule: Callable, direction: Callable, names: Sequence[str],
              fill: float = 0.0) -> GradientTransformation:
    """``update``: ``direction(g, p, slots, count) -> (u, new slots)`` per
    leaf, then ``-lr * u`` at the schedule's 0-based count."""

    def init(params):
        return _count_state(params, *names, fill=fill)

    def update(grads, state, params):
        lr = schedule(state["step"])
        count = state["step"] + 1
        updates, new = [], {n: [] for n in names}
        for k, (g, p) in enumerate(zip(grads, params)):
            u, slots = direction(g.float(), p, [state[n][k] for n in names], count)
            updates.append(-lr * u)
            for n, t in zip(names, slots):
                new[n].append(t)
        return updates, {**new, "step": count.to(torch.int32)}

    return GradientTransformation(init, update)


def leaf_norm(x: torch.Tensor) -> torch.Tensor:
    """A leaf's L2 norm as fp32, its squares summed in float64: PyTorch's
    CPU fp32 norm of a 25M-element leaf is 0.1-0.3 % off (its sequential
    fp32 lanes), the card's a few ulps, so the trust ratios would differ."""
    return torch.linalg.vector_norm(x, dtype=torch.float64).float()


def lamb(schedule: Callable, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         wd: float = 0.0) -> GradientTransformation:
    """optax ``lamb``: Adam's direction plus decay, scaled per leaf by the
    trust ratio ||p|| / ||u|| (1 where either norm is 0)."""

    def direction(g, p, slots, count):
        m = (1 - b1) * g + b1 * slots[0]
        v = (1 - b2) * g * g + b2 * slots[1]
        u = (m / _bias_correction(b1, count)) / (torch.sqrt(v / _bias_correction(b2, count))
                                                 + eps)
        if wd:
            u = u + wd * p
        pn, un = leaf_norm(p), leaf_norm(u)
        trust = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
        return u * trust, (m, v)

    return _sgd_like(schedule, direction, ("m", "v"))


def lion(schedule: Callable, b1: float = 0.9, b2: float = 0.99,
         wd: float = 0.0) -> GradientTransformation:
    """optax ``lion``: sign((1 - b1) g + b1 m) plus decoupled decay; the
    moment follows b2."""

    def direction(g, p, slots, count):
        u = torch.sign((1.0 - b1) * g + b1 * slots[0])
        m = (1 - b2) * g + b2 * slots[0]
        if wd:
            u = u + wd * p
        return u, (m,)

    return _sgd_like(schedule, direction, ("m",))


def adagrad(schedule: Callable, eps: float = 1e-10,
            initial_accumulator_value: float = 0.1) -> GradientTransformation:
    """optax ``adagrad``: g / sqrt(sum of g^2 + eps), the sum starting at
    ``initial_accumulator_value``."""

    def direction(g, p, slots, count):
        s = g * g + slots[0]
        inv = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
        return inv * g, (s,)

    return _sgd_like(schedule, direction, ("sum_sq",), fill=initial_accumulator_value)


def sgd(schedule: Callable, momentum: float = 0.0, nesterov: bool = False
        ) -> GradientTransformation:
    """optax ``sgd`` with its momentum trace (t = g + momentum t; Nesterov
    steps by g + momentum t)."""

    def direction(g, p, slots, count):
        t = g + momentum * slots[0]
        return (g + momentum * t if nesterov else t), (t,)

    return _sgd_like(schedule, direction, ("trace",))


def orthogonalize_newton_schulz(x: torch.Tensor, steps: int = MUON_NS_STEPS,
                                coeffs=MUON_NS_COEFFS, eps: float = 1e-8) -> torch.Tensor:
    """optax's quintic Newton-Schulz iteration on a 2-D matrix (the wide
    orientation, scaled to Frobenius norm <= 1 first)."""
    a, b, c = coeffs
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    for _ in range(steps):
        s = x @ x.T
        x = a * x + (b * s + c * s @ s) @ x
    return x.T if transposed else x


def muon(schedule: Callable, adam_b1: float = 0.9, adam_b2: float = 0.999, wd: float = 0.0,
         beta: float = 0.95, eps: float = 1e-8) -> GradientTransformation:
    """optax.contrib ``muon``: 2-D leaves take the Nesterov momentum,
    orthogonalised by Newton-Schulz and scaled by sqrt(max(1, out / in)),
    plus decoupled decay; the others take Nesterov Adam (no decay)."""

    def nesterov_hat(m, g, b, count):
        return b * (m / _bias_correction(b, count + 1)) + (1 - b) * (g / _bias_correction(b, count))

    def direction(g, p, slots, count):
        if g.dim() == 2:
            m = (1 - beta) * g + beta * slots[0]
            u = orthogonalize_newton_schulz(nesterov_hat(m, g, beta, count), eps=eps)
            u = math.sqrt(max(1.0, g.shape[1] / g.shape[0])) * u
            if wd:
                u = u + wd * p
            return u, (m, slots[1])
        m = (1 - adam_b1) * g + adam_b1 * slots[0]
        v = (1 - adam_b2) * g * g + adam_b2 * slots[1]
        u = nesterov_hat(m, g, adam_b1, count) / (torch.sqrt(v / _bias_correction(adam_b2, count))
                                                  + eps)
        return u, (m, v)

    return _sgd_like(schedule, direction, ("m", "v"))
