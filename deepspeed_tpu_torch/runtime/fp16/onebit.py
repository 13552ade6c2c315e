"""The 1-bit optimizer family: OneBitAdam, ZeroOneAdam, OneBitLamb — the
counterpart of ``deepspeed_tpu/runtime/fp16/onebit.py`` at one rank.

Their shared recipe: exact Adam (or LAMB) for ``freeze_step`` warm-up
steps; then the variance freezes (ZeroOneAdam refreshes it every
``var_update_interval`` steps) and the momentum is fed the gradient after
an error-feedback compression: the compensated gradient (g + error) is
quantised to int8 in blocks of 128 and back, and what the rounding lost is
the next step's error.  That quantise-dequantise is the value every rank
would fold into its momentum after the compressed all-reduce; the
all-reduce itself waits for ROADMAP Queue 1 #9.

Each is a ``GradientTransformation`` over lists of tensors
(``runtime/optimizers.py``), selected by its optimizer name.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..optimizers import GradientTransformation, _bias_correction, leaf_norm


def qdq_block_int8(x: torch.Tensor) -> torch.Tensor:
    """Per-128-block symmetric int8 quantise-dequantise of ``x``'s flat
    values (blocks padded with zeros), in ``x``'s shape and dtype."""
    n = x.numel()
    if n == 0:
        return x
    flat = x.reshape(-1)
    pad = (-n) % 128
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, 128)
    # divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, an ulp off the quotient the CPU takes
    scale = torch.clamp(blocks.abs().amax(-1, keepdim=True), min=1e-12) / torch.tensor(
        127.0, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    return (q * scale).reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def one_bit_adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_step: int = 100) -> GradientTransformation:
    """OneBitAdam: exact AdamW warm-up, then frozen variance and compressed
    momentum updates with error feedback."""
    return _one_bit_family(learning_rate, b1, b2, eps, weight_decay, freeze_step, 0, False)


def zero_one_adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: float = 0.0, var_freeze_step: int = 100,
                  var_update_interval: int = 16) -> GradientTransformation:
    """ZeroOneAdam: OneBitAdam whose variance still refreshes every
    ``var_update_interval`` steps after the freeze point."""
    return _one_bit_family(learning_rate, b1, b2, eps, weight_decay, var_freeze_step,
                           var_update_interval, False)


def one_bit_lamb(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, freeze_step: int = 100) -> GradientTransformation:
    """OneBitLamb: the compressed stage scaled by LAMB's per-leaf trust
    ratio."""
    return _one_bit_family(learning_rate, b1, b2, eps, weight_decay, freeze_step, 0, True)


def _one_bit_family(learning_rate, b1, b2, eps, weight_decay, freeze_step,
                    var_update_interval, lamb) -> GradientTransformation:
    sched: Callable = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        device = params[0].device if params else None
        z = lambda: [torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
                     for p in params]
        return {"step": torch.zeros((), dtype=torch.int32, device=device), "m": z(), "v": z(),
                "error": z()}

    def update(grads, state, params=None):
        if params is None and (weight_decay or lamb):
            raise ValueError("one-bit optimizer with weight_decay or LAMB needs params: call "
                             "update(grads, state, params)")
        count = state["step"] + 1
        warm = bool(count <= freeze_step)
        refresh = warm or (var_update_interval > 0 and int(count) % var_update_interval == 0)
        lr = sched(state["step"])
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out: Dict[str, List[torch.Tensor]] = {"u": [], "m": [], "v": [], "error": []}
        for k, g in enumerate(grads):
            g = g.float()
            m, v, e = state["m"][k], state["v"][k], state["error"][k]
            if warm:  # the exact gradient; no error accrues
                g_eff, new_e = g, torch.zeros_like(e)
            else:
                comp = g + e
                g_eff = qdq_block_int8(comp)
                new_e = comp - g_eff
            new_m = b1 * m + (1 - b1) * g_eff
            new_v = b2 * v + (1 - b2) * g_eff * g_eff if refresh else v
            upd = (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)
            p = params[k] if params is not None else g
            if weight_decay:
                upd = upd + weight_decay * p
            if lamb:
                wn, un = leaf_norm(p), leaf_norm(upd)
                trust = torch.where((wn > 0) & (un > 0), wn / un, torch.ones_like(wn))
                upd = trust * upd
            out["u"].append(-lr * upd)
            out["m"].append(new_m)
            out["v"].append(new_v)
            out["error"].append(new_e)
        return out["u"], {"step": count.to(torch.int32), "m": out["m"], "v": out["v"],
                          "error": out["error"]}

    return GradientTransformation(init, update)
