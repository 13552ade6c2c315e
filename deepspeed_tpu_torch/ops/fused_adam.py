"""Fused Adam/AdamW: the CUDA kernel ``csrc/fused_adam.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``deepspeed_tpu/ops/pallas/fused_adam.py``
``_adam_kernel`` (via ``fused_adam_update``): one pass of Adam or AdamW
over a flat parameter leaf.  Unlike the JAX function, which returns new
arrays, both versions here update ``p``, ``m`` and ``v`` **in place**: the
optimizer owns those buffers, and an out-of-place step would hold a second
copy of the master weights and both moments.

``scalars`` is a two-element fp32 tensor ``[step, lr]`` on the leaf's
device, ``step`` 1-based: the kernel reads it from device memory, as the
TPU kernel reads its SMEM scalars, so a scheduled learning rate never
becomes a launch argument and the step needs no host value.

:func:`fused_adam_update` launches the kernel for CUDA tensors and runs
:func:`fused_adam_plain` for CPU tensors; a CUDA tensor the kernel cannot
take raises.  Each launch adds one to ``fused_adam_update.launches``.

Both versions compute in fp32 in the JAX kernel's order of operations and
keep its bias correction ``1 - exp(step * log(beta))``.  On the card they
differ only where the compiler contracts a multiply and an add into one
fused multiply-add (a rounding of an ulp or two of each intermediate).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import op_builder

_P = ctypes.c_void_p
_F = ctypes.c_float
_SIG = {"dstpu_fused_adam": [
    _P, _P, _P, _P, _P,                 # p g m v scalars
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n m_dtype vec
    _F, _F, _F, _F, _F, _F, _F, _F,     # b1 1-b1 b2 1-b2 eps wd log(b1) log(b2)
    ctypes.c_int, ctypes.c_int, _P]}    # adam_w_mode bias_correction stream

_M_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(p, g, m, v, scalars) -> None:
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"p/g/m/v shapes differ: {tuple(p.shape)} {tuple(g.shape)} "
                         f"{tuple(m.shape)} {tuple(v.shape)}")
    if p.dtype != torch.float32 or g.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"p, g and v must be fp32 (got {p.dtype}, {g.dtype}, {v.dtype})")
    if m.dtype not in _M_DTYPES:
        raise TypeError(f"m must be fp32 or bf16, got {m.dtype}")
    if scalars.shape != (2,) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars must be fp32 [step, lr], got {scalars.dtype} "
                         f"{tuple(scalars.shape)}")


def fused_adam_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     scalars: torch.Tensor, *, beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-8, weight_decay: float = 0.0, adam_w_mode: bool = True,
                     bias_correction: bool = True) -> None:
    """The plain version: the TPU kernel's arithmetic as fp32 torch ops,
    written back into ``p``, ``m`` and ``v``."""
    _check(p, g, m, v, scalars)
    step, lr = scalars[0], scalars[1]
    pf, gf, mf, vf = p.float(), g.float(), m.float(), v.float()
    if weight_decay != 0.0 and not adam_w_mode:
        gf = gf + weight_decay * pf
    mf = beta1 * mf + (1.0 - beta1) * gf
    vf = beta2 * vf + (1.0 - beta2) * gf * gf
    if bias_correction:
        bc1 = 1.0 - torch.exp(step * math.log(beta1))
        bc2 = 1.0 - torch.exp(step * math.log(beta2))
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
    else:
        update = mf / (torch.sqrt(vf) + eps)
    if weight_decay != 0.0 and adam_w_mode:
        update = update + weight_decay * pf
    p.copy_(pf - lr * update)
    m.copy_(mf)
    v.copy_(vf)


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def fused_adam_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      scalars: torch.Tensor, *, beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-8, weight_decay: float = 0.0, adam_w_mode: bool = True,
                      bias_correction: bool = True) -> None:
    """One Adam/AdamW step over a leaf of any shape, in place.  p, g, v
    fp32; m fp32 or bf16; all contiguous, on one device."""
    if p.device.type == "cpu":
        fused_adam_plain(p, g, m, v, scalars, beta1=beta1, beta2=beta2, eps=eps,
                         weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                         bias_correction=bias_correction)
        return
    _check(p, g, m, v, scalars)
    if p.device.type != "cuda" or any(t.device != p.device for t in (g, m, v, scalars)):
        raise ValueError(f"fused_adam_update: p/g/m/v/scalars on {p.device}/{g.device}/"
                         f"{m.device}/{v.device}/{scalars.device}")
    if not all(t.is_contiguous() for t in (p, g, m, v, scalars)):
        raise ValueError("fused_adam_update: p, g, m, v and scalars must be contiguous "
                         "(the update is in place)")
    vec = (all(_aligned(t, 16) for t in (p, g, v))
           and _aligned(m, 16 if m.dtype == torch.float32 else 8))
    lib = op_builder.load("fused_adam", _SIG)
    with torch.cuda.device(p.device):
        err = lib.dstpu_fused_adam(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), scalars.data_ptr(),
            p.numel(), _M_DTYPES[m.dtype], int(vec), beta1, 1.0 - beta1, beta2, 1.0 - beta2,
            eps, weight_decay, math.log(beta1), math.log(beta2), int(bool(adam_w_mode)),
            int(bool(bias_correction)), torch.cuda.current_stream(p.device).cuda_stream)
    op_builder.check(err, "fused_adam")
    fused_adam_update.launches += 1


fused_adam_update.launches = 0
