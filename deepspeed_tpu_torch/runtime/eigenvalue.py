"""Hessian eigenvalue estimation by power iteration
(``deepspeed_tpu/runtime/eigenvalue.py``): the curvature estimate that
schedules compression's quantization.

The Hessian-vector products are double backward: the gradient is taken
with ``create_graph=True`` and differentiated again along ``v`` (the JAX
package takes ``jax.jvp`` of ``jax.grad``).  A loss that runs through a
hand-written kernel's ``autograd.Function`` (the flash attention's) has no
second derivative: its backward is the kernels, not differentiable ops.
The product then raises, naming the cause, as JAX's ``jvp`` of a
``custom_vjp`` does; it never switches to the plain version.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


def _normalize(vs: List[torch.Tensor]):
    norm = torch.sqrt(sum(torch.sum(torch.square(v)) for v in vs))
    return [v / (norm + 1e-12) for v in vs], norm


def _through_kernel(grads: Sequence[torch.Tensor]) -> bool:
    """Whether the graph of ``grads`` holds a backward that cannot be
    differentiated (``once_differentiable``: the kernels' functions)."""
    seen, todo = set(), [g.grad_fn for g in grads if g is not None and g.grad_fn is not None]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ in ("Error", "DelayedError"):
            return True
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return False


def hessian_vector_product(loss_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor],
                           params: Sequence[torch.Tensor],
                           v: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """H(params) @ v by double backward, on copies of ``params`` that
    require grad."""
    ps = [p.detach().requires_grad_(True) for p in params]
    grads = torch.autograd.grad(loss_fn(ps), ps, create_graph=True, allow_unused=True)
    if _through_kernel(grads):
        raise RuntimeError(
            "top_eigenvalue: the loss runs through a hand-written kernel's "
            "autograd.Function (flash attention), whose backward has no second "
            "derivative; use the plain attention (attn_impl='xla') for curvature")
    live = [(g, p, t) for g, p, t in zip(grads, ps, v) if g is not None and g.requires_grad]
    hv = dict()
    if live:
        out = torch.autograd.grad([g for g, _, _ in live], [p for _, p, _ in live],
                                  grad_outputs=[t for _, _, t in live], allow_unused=True)
        hv = {id(p): h for (_, p, _), h in zip(live, out)}
    # a leaf whose gradient is constant (or absent) has a zero Hessian row
    return [torch.zeros_like(p) if hv.get(id(p)) is None else hv[id(p)].detach() for p in ps]


def top_eigenvalue(loss_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor],
                   params: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None,
                   max_iters: int = 20, tol: float = 1e-2,
                   v0: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Largest |eigenvalue| of the Hessian of ``loss_fn`` (a function of the
    list ``params``) at ``params``: ``max_iters`` power iterations from
    ``v0``, or from a standard normal start drawn from ``generator`` (on
    the parameters' device).  Returns a 0-d fp32 tensor.  ``tol`` is kept
    for the JAX signature, which also runs every iteration."""
    del tol
    params = list(params)
    if v0 is None:
        if generator is None:
            raise ValueError("top_eigenvalue: pass the start vector v0 or a torch.Generator")
        v0 = [torch.randn(p.shape, generator=generator, dtype=torch.float32,
                          device=generator.device) for p in params]
    v, _ = _normalize([t.to(device=p.device, dtype=torch.float32) for t, p in zip(v0, params)])
    eig = torch.zeros((), dtype=torch.float32)
    for _ in range(max_iters):
        hv = hessian_vector_product(loss_fn, params, v)
        v, eig = _normalize([h.float() for h in hv])
    return eig
