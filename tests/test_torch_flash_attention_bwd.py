"""The port's differentiable ``flash_attention`` on the CPU (plain forward,
plain backward: the CPU paths of kernels A, A' and A'') vs ``jax.grad`` of
the JAX package's ``flash_attention`` (the Pallas backward kernels in
interpret mode) and of its ``xla_attention``.

The same numpy q, k, v and output cotangent go through both; the
gradients of ``sum(o * dO)`` are compared.  Tolerances: fp32 2e-5
absolute and relative (both sides recompute P in fp32 from the saved
log-sum-exp; only summation order differs, over gradients of magnitude
up to ~5); bf16 2e-2 (the port's plain forward forms the scores in bf16,
as the XLA formulation does, so its lse, o and hence P and delta carry
bf16 rounding that the all-fp32 Pallas kernels do not; the gradients are
then rounded to bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import _repeat_kv as jax_repeat_kv
from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.models.transformer import xla_attention as jax_xla_attention
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

TOL = {"fp32": 2e-5, "bf16": 2e-2}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, b, s, nh, kvh, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, nh, d).astype(np.float32), rng.randn(b, s, kvh, d).astype(np.float32),
            rng.randn(b, s, kvh, d).astype(np.float32), rng.randn(b, s, nh, d).astype(np.float32))


def _jax_grads(fn, q, k, v, do, dt):
    args = [jnp.asarray(a, JNP[dt]) for a in (q, k, v)]
    cot = jnp.asarray(do, JNP[dt])

    def loss(q_, k_, v_):
        return jnp.sum((fn(q_, k_, v_) * cot).astype(jnp.float32))

    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, (0, 1, 2))(*args)]


def _port_grads(q, k, v, do, dt, **kw):
    t = [torch.from_numpy(a).to(TORCH[dt]).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention(*t, **kw)
    o.backward(torch.from_numpy(do).to(TORCH[dt]))
    assert all(x.grad.dtype == TORCH[dt] for x in t)
    return [x.grad.float().numpy() for x in t]


def _check(got, want, dt):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("kvh", [4, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax_pallas_and_xla(causal, kvh, dt):
    q, k, v, do = _inputs(0, 2, 32, 4, kvh, 16)
    got = _port_grads(q, k, v, do, dt, causal=causal)
    _check(got, _jax_grads(lambda a, b, c: jax_flash(a, b, c, causal=causal, block_q=16,
                                                     block_k=16), q, k, v, do, dt), dt)
    g = 4 // kvh
    _check(got, _jax_grads(lambda a, b, c: jax_xla_attention(
        a, jax_repeat_kv(b, g), jax_repeat_kv(c, g), causal), q, k, v, do, dt), dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_flash_grads_uneven_s(dt):
    """S = 40 is not a multiple of the 16-row tiles: JAX pads, the port's
    kernels mask the ragged ends."""
    q, k, v, do = _inputs(1, 1, 40, 8, 2, 32)
    got = _port_grads(q, k, v, do, dt, causal=True)
    _check(got, _jax_grads(lambda a, b, c: jax_flash(a, b, c, causal=True, block_q=16,
                                                     block_k=16), q, k, v, do, dt), dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_alibi(causal, dt):
    q, k, v, do = _inputs(2, 2, 32, 8, 4, 16)
    got = _port_grads(q, k, v, do, dt, causal=causal,
                      alibi_slopes=alibi_slopes(8, device="cpu"))
    _check(got, _jax_grads(lambda a, b, c: jax_flash(
        a, b, c, causal=causal, block_q=16, block_k=16, alibi_slopes=jax_alibi_slopes(8)),
        q, k, v, do, dt), dt)


def test_plain_backward_matches_autograd_of_the_plain_forward():
    """The recompute formulas against autograd through the plain forward in
    float64, with GQA and ALiBi.  The plain backward works in fp32, as the
    kernels do: 1e-5 is fp32 rounding over sums of ~21 terms of magnitude
    up to ~3."""
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs(3, 2, 21, 6, 3, 8))
    slopes = alibi_slopes(6, device="cpu")
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(qa, ka, va, causal=True, alibi_slopes=slopes)
    o.backward(do)
    want = (qa.grad, ka.grad, va.grad)
    got = fa.flash_attention_bwd_plain(q, k, v, o.detach(), lse.detach(), do, causal=True,
                                       alibi_slopes=slopes)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_flash_cpu_backward_counts_no_launch():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, 1, 16, 4, 2, 16))
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*t, causal=True).backward(do)
    assert all(x.grad is not None for x in t)
    assert [c.launches for c in counters] == before


def test_flash_q_offset_is_forward_only():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(5, 1, 16, 4, 2, 16))
    with pytest.raises(NotImplementedError, match="forward-only"):
        fa.flash_attention(q.requires_grad_(), k, v, causal=True, q_offset=4)
    with torch.no_grad():
        o = fa.flash_attention(q, k, v, causal=True, q_offset=4)
    want, _ = fa.flash_attention_fwd_plain(q.detach(), k, v, causal=True, q_offset=4)
    assert torch.equal(o, want)


def test_flash_segment_mask_takes_the_plain_attention():
    """A [B, Sk] keep-mask goes to the plain attention with the KV heads
    repeated, as the JAX function does; its gradients flow."""
    q, k, v, do = _inputs(6, 2, 16, 4, 2, 16)
    keep = np.ones((2, 16), bool)
    keep[1, :5] = False
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention(*t, causal=True, segment_mask=torch.from_numpy(keep))
    o.backward(torch.from_numpy(do))
    want = _jax_grads(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                                segment_mask=jnp.asarray(keep)),
                      q, k, v, do, "fp32")
    _check([x.grad.numpy() for x in t], want, "fp32")


@pytest.mark.parametrize("group", [1, 2, 4, 5, 8, 71])
def test_dkv_two_terms_exactly_past_a_group_of_4(group):
    """Kernel A'' keeps P and dS as two bf16 terms exactly when the
    query-to-KV group is wider than 4 (at a compile-time head dim); fp16
    always takes two terms inside the kernel and fp32 none, so neither asks
    for the two-term code."""
    for D in (16, 64, 80, 128, 256):
        assert fa.dkv_two_terms(torch.bfloat16, group, D) == (group > 4)
        assert not fa.dkv_two_terms(torch.float16, group, D)
        assert not fa.dkv_two_terms(torch.float32, group, D)
    assert not fa.dkv_two_terms(torch.bfloat16, group, 288)  # runtime-head-dim kernel


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_flash_grads_wide_group_plain_version(dt):
    """The plain backward, which the CPU path runs and the card holds the
    kernels to, at a group of 8 (past the two-term threshold) against the
    JAX Pallas kernels: unchanged by the threshold."""
    q, k, v, do = _inputs(3, 1, 32, 8, 1, 16)
    got = _port_grads(q, k, v, do, dt, causal=True)
    _check(got, _jax_grads(lambda a, b, c: jax_flash(a, b, c, causal=True, block_q=16,
                                                     block_k=16), q, k, v, do, dt), dt)
