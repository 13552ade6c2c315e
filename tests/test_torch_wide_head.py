"""Head dims past 256 (the runtime-head-dim kernels' range): the port's
attention ops against the JAX package's Pallas kernels in interpret mode,
on the same numpy inputs made with a seed, on the CPU.

On the CPU the wrappers run their plain versions, which are what the
card's runtime-head-dim kernels are held against by ``chip_smoke.py``; the
JAX kernels take any head dim because a Pallas block spans the whole head.
Tolerances are those of the ops' own tests (the reasons are given there and
do not change with D): flash forward fp32 1e-5 and bf16 2e-2, flash
gradients fp32 2e-5 and bf16 2e-2, paged decode 1e-5, sparse 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import sparse_attention as jsa
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_paged
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import sparse_attention as sa

torch.set_num_threads(2)

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
WIDE = [288, 320]


def _inputs(seed, b, s, nh, kvh, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, nh, d).astype(np.float32), rng.randn(b, s, kvh, d).astype(np.float32),
            rng.randn(b, s, kvh, d).astype(np.float32), rng.randn(b, s, nh, d).astype(np.float32))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("D", WIDE)
def test_flash_forward_wide_heads_match_jax(D, alibi, dt):
    q, k, v, _ = _inputs(0, 1, 40, 4, 2, D)
    jkw = {"alibi_slopes": jax_alibi_slopes(4)} if alibi else {}
    tkw = {"alibi_slopes": alibi_slopes(4, device="cpu")} if alibi else {}
    want = jax_flash(*(jnp.asarray(a, JNP[dt]) for a in (q, k, v)), causal=True, block_q=16,
                     block_k=16, **jkw)
    got, _ = fa.flash_attention_fwd(*(torch.from_numpy(a).to(TORCH[dt]) for a in (q, k, v)),
                                    causal=True, **tkw)
    tol = {"fp32": 1e-5, "bf16": 2e-2}[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", WIDE)
def test_flash_grads_wide_heads_match_jax(D, causal, dt):
    """Gradients of sum(o * dO) through the port's flash_attention vs
    jax.grad through the Pallas kernels, GQA 4 over 2, S = 40."""
    q, k, v, do = _inputs(1, 1, 40, 4, 2, D)
    args = [jnp.asarray(a, JNP[dt]) for a in (q, k, v)]
    cot = jnp.asarray(do, JNP[dt])

    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal=causal, block_q=16, block_k=16)
        return jnp.sum((o * cot).astype(jnp.float32))

    want = [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, (0, 1, 2))(*args)]
    t = [torch.from_numpy(a).to(TORCH[dt]).requires_grad_() for a in (q, k, v)]
    fa.flash_attention(*t, causal=causal).backward(torch.from_numpy(do).to(TORCH[dt]))
    tol = {"fp32": 2e-5, "bf16": 2e-2}[dt]
    for x, w in zip(t, want):
        np.testing.assert_allclose(x.grad.float().numpy(), w, atol=tol, rtol=tol)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_wide_heads_match_jax(quant, alibi, D):
    rng = np.random.RandomState(2)
    B, NH, KVH, ps, MP = 3, 8, 2, 8, 4
    P = B * MP + 1
    q = rng.randn(B, NH, D).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, (P, ps, KVH, D)).astype(np.int8)
        v = rng.randint(-127, 128, (P, ps, KVH, D)).astype(np.int8)
        ks, vs = ((rng.rand(P, ps, KVH) * 0.05 + 0.01).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.randn(P, ps, KVH, D).astype(np.float32) for _ in range(2))
        ks = vs = None
    pos = np.array([5, 17, 30], np.int32)
    table = np.full((B, MP), P - 1, np.int32)
    perm, n = rng.permutation(P - 1), 0
    for b, p in enumerate(pos):
        table[b, :p // ps + 1] = perm[n:n + p // ps + 1]
        n += p // ps + 1
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = jax_paged(j(q), j(k), j(v), j(table), j(pos), k_scale=j(ks), v_scale=j(vs),
                     alibi_slopes=jax_alibi_slopes(NH) if alibi else None)
    got = pa.paged_decode_attention(t(q), t(k), t(v), t(table), t(pos), k_scale=t(ks),
                                    v_scale=t(vs),
                                    alibi_slopes=alibi_slopes(NH, device="cpu") if alibi else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name,block", [("fixed", 16), ("bigbird", 32), ("bslongformer", 24)])
@pytest.mark.parametrize("D", WIDE)
def test_sparse_wide_heads_match_jax_pallas(D, name, block, causal):
    cfgs = {"fixed": lambda m: m.FixedSparsityConfig(num_heads=2, block=block,
                                                      num_local_blocks=2, num_global_blocks=1),
            "bslongformer": lambda m: m.BSLongformerSparsityConfig(
                num_heads=2, block=block, num_sliding_window_blocks=3,
                global_block_indices=(0,)),
            "bigbird": lambda m: m.BigBirdSparsityConfig(num_heads=2, block=block,
                                                         num_random_blocks=1,
                                                         num_sliding_window_blocks=3,
                                                         num_global_blocks=1)}
    rng = np.random.RandomState(3)
    S = 120 if block == 24 else 128
    q, k, v = ((rng.randn(1, S, 2, D) * 0.1).astype(np.float32) for _ in range(3))
    want = np.asarray(jsa.sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           cfgs[name](jsa), causal=causal, impl="pallas"))
    got = sa.sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), cfgs[name](sa),
                              causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
