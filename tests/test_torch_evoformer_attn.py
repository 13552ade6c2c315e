"""The port's evoformer attention on the CPU (the plain passes of kernels E,
E' and E'' under its autograd function, and the XLA formulation) vs the
JAX package: ``jax.grad`` through ``evoformer_attention_pallas`` (the
Pallas kernels in interpret mode, ``block_q = block_k = 8``, so N = 20
leaves padded tails) and through ``evoformer_attention_xla``.

Sizes are the JAX test's (``tests/unit/test_onebit_evoformer.py``: B=2,
S=3, N=20, H=2, D=16), for the bias sets [], [b1], [b1, b2] and
[None, b2].  The same numpy q, k, v, biases and output cotangent go
through both sides.  Tolerances in fp32: forward 2e-5 and gradients 2e-4,
absolute and relative (both sides compute the same softmax and recompute
P from the log-sum-exp in fp32; the Pallas kernels sum block by block in
another order, and the bias gradients sum up to N*H*S = 120 terms of
magnitude up to ~3).  The kernels themselves are held to the plain passes
on the card by ``chip_smoke.py`` (phases 19 and 20)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.evoformer_attn import evoformer_attention as jax_evo
from deepspeed_tpu.ops.evoformer_attn import evoformer_attention_xla as jax_xla
from deepspeed_tpu.ops.pallas.evoformer_attn import evoformer_attention_pallas as jax_pallas
from deepspeed_tpu_torch.ops import evoformer_attn as ev

torch.set_num_threads(2)

B, S, N, H, D = 2, 3, 20, 2, 16
FWD_TOL = 2e-5
GRAD_TOL = 2e-4
BIAS_SETS = {"none": (), "b1": ("b1",), "b1_b2": ("b1", "b2"), "none_b2": (None, "b2")}


def _inputs(seed=1, d=D):
    rng = np.random.RandomState(seed)
    arrs = {n: rng.randn(B, S, N, H, d).astype(np.float32) for n in ("q", "k", "v", "do")}
    arrs["b1"] = rng.randn(B, S, 1, 1, N).astype(np.float32)
    arrs["b2"] = rng.randn(B, 1, H, N, N).astype(np.float32)
    return arrs


def _jax_grads(fn, arrs, slots):
    """Output and the gradients of sum(o * dO) w.r.t. q, k, v and each
    present bias."""
    present = [s for s in slots if s is not None]

    def loss(q, k, v, *bs):
        it = iter(bs)
        biases = [None if s is None else next(it) for s in slots]
        return jnp.sum(fn(q, k, v, biases) * jnp.asarray(arrs["do"]))

    args = [jnp.asarray(arrs[n]) for n in ("q", "k", "v", *present)]
    grads = jax.grad(loss, tuple(range(len(args))))(*args)
    it = iter(args[3:])
    out = fn(*args[:3], [None if s is None else next(it) for s in slots])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(fn, arrs, slots):
    leaves = [torch.from_numpy(arrs[n]).requires_grad_() for n in ("q", "k", "v")]
    biases = [None if s is None else torch.from_numpy(arrs[s]).requires_grad_() for s in slots]
    out = fn(*leaves, biases)
    out.backward(torch.from_numpy(arrs["do"]))
    grads = [t.grad for t in leaves] + [b.grad for b in biases if b is not None]
    for b in biases:
        if b is not None:
            assert b.grad.shape == b.shape and b.grad.dtype == b.dtype
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", list(BIAS_SETS))
@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_kernel_path_matches_jax(name, ref):
    """The kernel branch (autograd over the plain passes on the CPU):
    output and all gradients against jax.grad of the Pallas custom VJP and
    of the XLA formulation."""
    arrs = _inputs()
    slots = BIAS_SETS[name]
    jfn = ((lambda q, k, v, b: jax_pallas(q, k, v, b, block_q=8, block_k=8))
           if ref == "pallas" else jax_xla)
    want_o, want_g = _jax_grads(jfn, arrs, slots)
    ev.evoformer_attention.plain_calls = 0
    got_o, got_g = _port_grads(ev.DS4Sci_EvoformerAttention, arrs, slots)
    assert ev.evoformer_attention.plain_calls == 0  # D = 16 and the exact layouts: kernels
    np.testing.assert_allclose(got_o, want_o, rtol=FWD_TOL, atol=FWD_TOL)
    assert len(got_g) == len(want_g) == 3 + sum(s is not None for s in slots)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("name", ["b1_b2", "none_b2"])
def test_xla_formulation_matches_jax_xla(name):
    arrs = _inputs(2)
    slots = BIAS_SETS[name]
    want_o, want_g = _jax_grads(jax_xla, arrs, slots)
    got_o, got_g = _port_grads(ev.evoformer_attention_xla, arrs, slots)
    np.testing.assert_allclose(got_o, want_o, rtol=FWD_TOL, atol=FWD_TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_plain_passes_are_the_gradient_of_the_formulation():
    """fwd_plain / bwd_plain (the oracles of kernels E, E', E'') against
    autograd of the formulation on [B,S,K] / [B,H,Q,K] fp32 biases."""
    a = _inputs(3)
    q, k, v, do = (torch.from_numpy(a[n]) for n in ("q", "k", "v", "do"))
    b1 = torch.from_numpy(a["b1"]).reshape(B, S, N)
    b2 = torch.from_numpy(a["b2"]).reshape(B, H, N, N)
    o, lse = ev.evoformer_attn_fwd_plain(q, k, v, b1, b2)
    assert lse.shape == (B, S, H, N) and lse.dtype == torch.float32
    got = ev.evoformer_attn_bwd_plain(q, k, v, do, lse, ev._delta(o, do), b1, b2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, b1, b2)]
    ref = ev.evoformer_attention_xla(*leaves[:3], [leaves[3][:, :, None, None],
                                                   leaves[4][:, None]])
    np.testing.assert_allclose(o.numpy(), ref.detach().numpy(), rtol=FWD_TOL, atol=FWD_TOL)
    ref.backward(do)
    for g, t in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    # each pass's wrapper takes its plain version on the CPU and launches nothing
    dq, db1 = ev.evoformer_attn_bwd_dq(q, k, v, do, lse, ev._delta(o, do), b1, None)
    dk, dv, db2 = ev.evoformer_attn_bwd_dkv(q, k, v, do, lse, ev._delta(o, do), None, b2)
    assert db1 is not None and db2 is not None
    assert ev.evoformer_attn_fwd.launches == ev.evoformer_attn_bwd_dq.launches == 0
    assert ev.evoformer_attn_bwd_dkv.launches == 0


def test_lone_pair_bias_in_slot_0_takes_the_formulation():
    """As in JAX, a pair-shaped bias in slot 0 fails the per-position
    layout check under impl='auto' and broadcasts through the formulation."""
    rng = np.random.RandomState(4)
    q = rng.randn(1, 2, 8, 2, 16).astype(np.float32)
    pair = rng.randn(1, 1, 2, 8, 8).astype(np.float32)
    ev.evoformer_attention.plain_calls = 0
    got = ev.evoformer_attention(*(torch.from_numpy(q),) * 3, [torch.from_numpy(pair)])
    assert ev.evoformer_attention.plain_calls == 1
    want = np.asarray(jax_evo(*(jnp.asarray(q),) * 3, [jnp.asarray(pair)]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_head_dim_outside_the_kernels_takes_the_formulation():
    a = _inputs(5, d=8)
    slots = ("b1", "b2")
    ev.evoformer_attention.plain_calls = 0
    got_o, got_g = _port_grads(ev.evoformer_attention, a, slots)
    assert ev.evoformer_attention.plain_calls == 1
    want_o, want_g = _jax_grads(jax_evo, a, slots)
    np.testing.assert_allclose(got_o, want_o, rtol=FWD_TOL, atol=FWD_TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_three_biases_raise():
    q = torch.ones((1, 2, 4, 1, 16))
    for fn in (ev.DS4Sci_EvoformerAttention, ev.evoformer_attention_xla,
               ev.evoformer_attention_kernel):
        with pytest.raises(ValueError, match="at most two"):
            fn(q, q, q, [None, None, None])


def test_kernel_path_checks_bias_layouts():
    q = torch.ones((1, 2, 4, 1, 16))
    with pytest.raises(ValueError, match="bias1"):
        ev.evoformer_attention(q, q, q, [torch.ones((1, 1, 2, 4, 4))], impl="pallas")
    with pytest.raises(ValueError, match="bias2"):
        ev.evoformer_attention(q, q, q, [None, torch.ones((1, 2, 1, 1, 4))], impl="pallas")


def test_no_bias_gradient_is_finite():
    q = torch.ones((1, 2, 4, 1, 16), requires_grad=True)
    ev.DS4Sci_EvoformerAttention(q, q, q).sum().backward()
    assert torch.isfinite(q.grad).all()


#: bf16: both sides form the scores in bf16 (einsum), add the biases in fp32
#: and round the probabilities to bf16 before PV; XLA and PyTorch accumulate
#: the bf16 products in other orders and round at other places, so outputs
#: of magnitude ~1 differ by a few bf16 ulps (2^-7 each): 3e-2.
BF16_TOL = 3e-2


def test_bf16_formulation_matches_jax_xla_in_bf16():
    a = _inputs(6)
    biases_np = [a["b1"], a["b2"]]
    want = np.asarray(jax_xla(*(jnp.asarray(a[n], jnp.bfloat16) for n in ("q", "k", "v")),
                              [jnp.asarray(b, jnp.bfloat16) for b in biases_np])
                      .astype(jnp.float32))
    got = ev.evoformer_attention_xla(
        *(torch.from_numpy(a[n]).bfloat16() for n in ("q", "k", "v")),
        [torch.from_numpy(b).bfloat16() for b in biases_np])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)


def test_bf16_kernel_path_gradients_come_back_in_the_bias_dtype():
    """bf16 inputs and biases through the kernel branch: the fp32 plain
    passes on the CPU, output within BF16_TOL of JAX's XLA path in bf16, and
    every gradient in its leaf's dtype and shape."""
    a = _inputs(7)
    leaves = [torch.from_numpy(a[n]).bfloat16().requires_grad_() for n in ("q", "k", "v")]
    biases = [torch.from_numpy(a[n]).bfloat16().requires_grad_() for n in ("b1", "b2")]
    out = ev.DS4Sci_EvoformerAttention(*leaves, biases)
    want = np.asarray(jax_xla(*(jnp.asarray(a[n], jnp.bfloat16) for n in ("q", "k", "v")),
                              [jnp.asarray(a[n], jnp.bfloat16) for n in ("b1", "b2")])
                      .astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)
    out.float().sum().backward()
    for t in leaves + biases:
        assert t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape


def test_row_masked_by_1e9_matches_the_jax_kernels_not_autodiff():
    """A row (b, s) whose bias1 is AlphaFold's 1e9 * (mask - 1) = -1e9 on
    every key.  The forward equals the formulation's (uniform attention).
    The backward recomputes P = exp(s - lse); the row's fp32 lse is -1e9
    and cannot hold log N, so P sums to N on that row — in the JAX Pallas
    kernels and in the port alike (ROADMAP Queue 3).  The port follows the
    reference kernels: its gradients match the Pallas VJP, and the masked
    row's dq differs from autodiff of the formulation."""
    a = _inputs(8)
    a["b1"][0, 1] = -1e9
    slots = ("b1", "b2")
    pallas_o, pallas_g = _jax_grads(
        lambda q, k, v, b: jax_pallas(q, k, v, b, block_q=8, block_k=8), a, slots)
    xla_o, xla_g = _jax_grads(jax_xla, a, slots)
    got_o, got_g = _port_grads(ev.DS4Sci_EvoformerAttention, a, slots)
    np.testing.assert_allclose(got_o, xla_o, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got_o, pallas_o, rtol=FWD_TOL, atol=FWD_TOL)
    for g, w in zip(got_g[:3], pallas_g[:3]):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)
    masked_dq = np.abs(got_g[0][0, 1]).max()
    assert masked_dq > 2 * np.abs(xla_g[0][0, 1]).max()
    np.testing.assert_allclose(got_g[0][1], xla_g[0][1], rtol=GRAD_TOL, atol=GRAD_TOL)


def test_bias1_gradient_past_the_old_key_limit_matches_jax():
    """K = 12,000 keys with bias1: past the ~5,500 (bf16) to ~20,000 (fp32)
    keys whose whole dbias1 accumulator fit one block, where the card's
    kernel E' now cuts the key axis into ranges.  The port's plain passes
    (its CPU path) against jax.grad through the Pallas kernels in
    interpret mode; Q = 8 rows keep it small.  Tolerances as above: the
    sums over 12,000 keys are fp32 on both sides in other orders."""
    rng = np.random.RandomState(7)
    K = 12000
    q = rng.randn(1, 1, 8, 2, 16).astype(np.float32)
    k, v = (rng.randn(1, 1, K, 2, 16).astype(np.float32) for _ in range(2))
    b1 = rng.randn(1, 1, 1, 1, K).astype(np.float32)
    do = rng.randn(1, 1, 8, 2, 16).astype(np.float32)

    def loss(q_, k_, v_, b_):
        o = jax_pallas(q_, k_, v_, [b_], block_q=8, block_k=512)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(loss, (0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, b1)))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, b1)]
    ev.DS4Sci_EvoformerAttention(t[0], t[1], t[2], [t[3]]).backward(torch.from_numpy(do))
    for x, w in zip(t, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL)
