"""The port's paged decode attention (plain version, the CPU path) vs the
JAX package's Pallas ``paged_decode_attention`` run in interpret mode,
plus the port's no-fallback contract on a machine without CUDA.

Tolerance: fp32 1e-5 (both keep fp32 scores; the kernel runs an online
softmax over pages, the plain version one softmax over the gathered
window — summation order only), as in the JAX package's own paged test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_decode_attention as jax_paged
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceConfig
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)


def _case(kvh, quant=False, seed=0):
    """3 sequences at positions 5, 17, 30 over distinct random pages of a
    pool of 13 (+ trash); table trash-filled past each length."""
    rng = np.random.RandomState(seed)
    B, NH, D, ps, MP = 3, 8, 16, 8, 4
    P = B * MP + 1
    trash = P - 1
    q = rng.randn(B, NH, D).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, (P, ps, kvh, D)).astype(np.int8)
        v = rng.randint(-127, 128, (P, ps, kvh, D)).astype(np.int8)
        ks = (rng.rand(P, ps, kvh) * 0.05 + 0.01).astype(np.float32)
        vs = (rng.rand(P, ps, kvh) * 0.05 + 0.01).astype(np.float32)
    else:
        k = rng.randn(P, ps, kvh, D).astype(np.float32)
        v = rng.randn(P, ps, kvh, D).astype(np.float32)
        ks = vs = None
    pos = np.array([5, 17, 30], np.int32)
    table = np.full((B, MP), trash, np.int32)
    perm = rng.permutation(P - 1)
    n = 0
    for b, p in enumerate(pos):
        used = p // ps + 1
        table[b, :used] = perm[n:n + used]
        n += used
    return q, k, v, table, pos, ks, vs


def _run_both(q, k, v, table, pos, ks=None, vs=None, alibi=False):
    NH = q.shape[1]
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = jax_paged(j(q), j(k), j(v), j(table), j(pos), k_scale=j(ks), v_scale=j(vs),
                     alibi_slopes=jax_alibi_slopes(NH) if alibi else None)
    got = pa.paged_decode_attention(t(q), t(k), t(v), t(table), t(pos),
                                    k_scale=t(ks), v_scale=t(vs),
                                    alibi_slopes=alibi_slopes(NH, device="cpu") if alibi else None)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kvh", [8, 2, 1])
def test_paged_matches_jax(kvh, quant, alibi):
    want, got = _run_both(*_case(kvh, quant), alibi=alibi)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kvh", [8, 2])
def test_paged_poisoned_trash_page_ignored(kvh):
    """1e4 in the trash page changes neither side: only slots <= position
    contribute (the CUDA kernel never loads the page at all)."""
    q, k, v, table, pos, _, _ = _case(kvh, seed=1)
    clean = _run_both(q, k, v, table, pos)
    k[-1], v[-1] = 1e4, 1e4
    poisoned = _run_both(q, k, v, table, pos)
    np.testing.assert_allclose(poisoned[1], clean[1], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(poisoned[1], poisoned[0], atol=1e-5, rtol=1e-5)


def test_paged_cpu_takes_plain_and_counts_no_launch():
    q, k, v, table, pos, _, _ = (torch.from_numpy(a) if a is not None else None
                                 for a in _case(2))
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, k, v, table, pos)
    want = pa.paged_decode_attention_plain(q, k, v, table, pos)
    assert torch.equal(got, want)
    assert pa.paged_decode_attention.launches == before


# -- no fallback: without CUDA nothing quietly runs on the CPU --------------

def test_entry_points_default_to_cuda_and_raise_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    model = llama_model("tiny", max_seq_len=64)
    cfg = RaggedInferenceConfig(dtype="fp32", page_size=8, num_pages=16,
                                max_seqs=2, max_pages_per_seq=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngineV2(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(torch.Generator(), "cuda")


def test_kernel_wrappers_refuse_non_cpu_tensors_instead_of_falling_back():
    """A tensor off the CPU takes the kernel or raises: the plain version
    is never a fallback (here, a meta tensor stands in for a device the
    wrapper cannot launch on)."""
    q = torch.empty((1, 16, 4, 16), device="meta")
    kv = torch.empty((1, 16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention_fwd(q, kv, kv)
    pool = torch.empty((5, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        pa.paged_decode_attention(torch.empty((1, 4, 16), device="meta"), pool, pool,
                                  torch.zeros((1, 4), dtype=torch.int32, device="meta"),
                                  torch.zeros((1,), dtype=torch.int32, device="meta"))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("DSTPU_TORCH_BUILD", str(tmp_path / "build"))
    with pytest.raises(op_builder.KernelBuildError, match="nvcc"):
        op_builder.build()


@pytest.mark.parametrize("B,KVH,MP,sms,groups,resident,n", [
    (8, 8, 64, 132, 1, 3, 4),     # llama-1b decode: 64 (b, kv head) pairs, 3 blocks an SM
    (8, 8, 64, 132, 1, 1, 2),     # Mixtral-8x7b: the same pairs, one block an SM
    (8, 32, 64, 132, 1, 2, 1),    # llama-7b: 256 pairs cover the SMs already
    (1, 8, 64, 132, 1, 2, 8),     # one sequence: the cluster limit
    (8, 8, 2, 132, 1, 2, 2),      # no more splits than pages of the table
    (64, 32, 64, 132, 1, 2, 1),   # far past a wave
    (3, 8, 12, 132, 1, 1, 5),
    (4, 8, 20, 16, 1, 2, 1),      # a small card
    (8, 1, 64, 132, 9, 2, 3),     # falcon-7b: one kv head, 71 query rows in 9 groups
    (8, 1, 64, 132, 9, 1, 1),
    (1, 1, 64, 132, 9, 2, 8),
    (8, 4, 64, 132, 2, 2, 4),
    (8, 8, 64, 132, 1, 0, 2),     # no answer from the card counts as one block an SM
])
def test_split_count_covers_the_sms_within_a_cluster(B, KVH, MP, sms, groups, resident, n):
    """Up to head dim 256 each (sequence, kv head, row group) is split over
    a cluster of blocks: enough that the grid holds about two blocks an SM
    but no more than an SM holds at once (one wave), at most 8 (a portable
    cluster) and at most the table's pages."""
    assert pa.split_count(B, KVH, MP, sms, groups, resident) == n
    assert 1 <= n <= pa.MAX_SPLIT


@pytest.mark.parametrize("resident", [1, 2, 3, 8])
def test_split_count_never_leaves_the_grid_short_of_a_wave(resident):
    """Whenever fewer than the SMs' worth of (sequence, kv head, row group)
    blocks exist, the splits bring the grid past half the SMs (unless the
    cluster limit or the table's pages stop it), and never past the blocks
    the SMs hold at once unless the pairs alone do."""
    sms = 132
    for B in (1, 2, 4, 8, 16):
        for KVH in (1, 2, 4, 8, 32):
            for groups in (1, 2, 9):
                pairs = B * KVH * groups
                n = pa.split_count(B, KVH, 64, sms, groups, resident)
                assert pairs * n >= min(sms // 2 + 1, pairs * pa.MAX_SPLIT)
                assert pairs * n <= max(min(pa.BLOCKS_PER_SM, resident) * sms, pairs)


@pytest.mark.parametrize("D,tma", [
    (64, True), (128, True), (16, True), (160, True), (256, True), (224, True),
    (72, False),   # rows off 16 are read in place by cp.async, tails zero-filled
    (100, False), (33, False), (136, False), (1, False),
    (288, False),  # the runtime-head-dim kernel reads device memory directly
])
def test_tma_pages_rule(D, tma):
    """Chunks are TMA copies when the rows are the kernel's full width
    (every stride then a whole number of 16-byte vectors, the box one row),
    at every page size: a box holds one chunk of at most 16 slots.
    Otherwise every lane copies its vectors by cp.async."""
    assert pa.tma_pages(D) is tma


@pytest.mark.parametrize("G,groups,rows", [
    (1, 1, 1), (4, 1, 4), (8, 1, 8),  # llama-7b, llama-1b / Mixtral, gemma-like: one block
    (9, 2, 5), (16, 2, 8), (17, 3, 6),
    (71, 9, 8),                        # falcon-7b: 71 query heads over one KV head
    (128, 16, 8),
])
def test_row_groups_bound_a_block_to_eight_rows(G, groups, rows):
    """A kv head's query rows go to one block up to 8 and to the fewest
    near-equal groups of at most 8 past that; every group holds a row."""
    assert pa.row_groups(G) == (groups, rows)
    assert rows <= pa.MAX_ROWS and (groups - 1) * rows < G <= groups * rows


@pytest.mark.parametrize("ps,chunk", [
    (16, 16), (8, 8), (1, 1), (32, 16), (128, 16), (256, 16),
    (24, 12), (48, 16), (17, 1), (257, 1), (100, 10),
])
def test_page_chunk_divides_the_page(ps, chunk):
    """A block stages the largest divisor of the page size up to 16 slots,
    so no chunk straddles two pages and a stage stays small at pages of
    128 or 256 slots."""
    assert pa.page_chunk(ps) == chunk
    assert ps % chunk == 0 and chunk <= pa.MAX_CHUNK
