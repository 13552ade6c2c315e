// Grouped (block-diagonal) expert matmul for Hopper (sm_90a) and its two
// backward products, plain C interface for ctypes.
//
// G replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/grouped_matmul.py
// :_gmm_kernel (via grouped_matmul): the three expert matmuls of every
// dropless MoE layer (moe/sharded_moe.py _expert_ffn_blocks), three launches
// per layer on every prefill, prefill-chunk, decode and training call.  G'
// (grouped dX) and G'' (per-expert dW) are its backward, which the JAX
// package leaves to XLA's autodiff of the einsum branch: three of each per
// MoE layer per training micro-step (ops/grouped_matmul.py's autograd
// Function).
//
// What G computes, for x [P, H] (rows sorted by expert and padded so that
// every block of block_rows rows belongs to one expert), stacked expert
// weights w [E, H, F] and block_expert [P / block_rows] int32:
//   out[r, :] = x[r, :] @ w[block_expert[r / block_rows]]
// with fp32 sums rounded once to x's type, as the TPU kernel computes
// x_f32 @ w_f32 per block.  Products of bf16 or fp16 operands are exact in
// fp32, so the tensor-core path differs from it in summation order only.
// An expert index outside [0, E) is clamped (the router never makes one).
// G':  dx[r, :] = dy[r, :] @ w[block_expert[r / block_rows]]^T with w read
//      K-contiguous as stored, so no transposed copy of the expert weights
//      is ever made: gmm_dx_wgmma_kernel on the wgmma layouts (no K split),
//      G's mma.sync and FMA kernels with the template flag TW on the others.
// G'': dw[e] = sum over the blocks b of expert e of x_b^T @ dy_b, each
//      output tile owned by one block, which walks that expert's blocks in
//      ascending order and writes once: no atomics, so G'' is
//      bit-reproducible.
//
// What bounds G' and G'' at the training layout is the bytes each block
// brings from L2 into shared memory for its products, not HBM: 128 x 128
// tiles per block move 12-17 GB a call.  Their design therefore shares
// every loaded tile of dy between the two blocks of a thread-block cluster
// (one TMA load multicast into both), and the dW tile is 128 x 256.
//
// What bounds it on the H100, at Mixtral-8x7b's widths (H 4096, F 14336):
// decode (P = 1152: 16 assignments padded into 9 blocks of 128 rows, most
// of them zero) is bound by the bytes of the expert weights, ~7-8 distinct
// 117 MB matrices per call, ~0.28 ms at 3.35 TB/s; prefill of a 1024-token
// bucket (P = 3072) by the tensor cores, 361 GFLOP, 0.365 ms at 989 TFLOP/s.
// Training (4096 tokens at top-2: 8192 routed rows) puts G, G' and G'' all
// on the tensor cores: 962 GFLOP each, ~0.97 ms at 989 TFLOP/s.
//
// Rows of blocks at or past *n_used (an optional device int: the blocks that
// hold a real row, from the router) are written as zeros without being
// computed, which is what zero padding rows give; G'' leaves those blocks
// out of every sum.
//
// Design of G, bf16 and fp16, block_rows a multiple of 128 and H, F
// multiples of 8: wgmma fed by TMA (the main path).  Row tiles of
// 128 rows; one block of two consumer warpgroups per (run of up to two
// consecutive row tiles of one expert, 128-column tile, K split): a block
// starts at every even tile and at every tile whose expert differs from
// the one before, and takes the next tile too when that one is odd and
// shares its expert.  Its K loop is
// k-major over both tiles, so each 64 x 128 weight tile is read once for the
// pair; the blocks of one column tile sit side by side in the grid, so the
// rest of a run's blocks meet the same weight tiles in L2.  Warpgroup c
// holds rows 64 c .. 64 c + 63 of each tile (64 x 128 fp32 accumulators per
// tile).  Thread 0 issues the copies into a ring of 4 stages: per tile one
// box of 128 rows x 64 of x's K, and two boxes of 64 of w's K rows x 64
// columns, each with TMA's 128-byte swizzle (rows of 128 bytes: 8 times
// fewer TMA requests than 16-byte panels, which held the first version of
// this kernel below the mma.sync one on the card).  x is the K-major A
// operand, w the MN-major B operand, so nothing is transposed.  Blocks whose rows are all
// past *n_used load nothing.  At decode the down projection (K = 14336 over
// 32 column tiles) has too few blocks to fill the card: K is split, each
// split writes fp32 partials of its rows, and a second pass adds them in
// split order and rounds once (no atomics, so G is bit-reproducible).
//
// Other bf16/fp16 layouts (block_rows under 128 or off a multiple of it,
// ragged or unaligned H or F): the mma.sync kernel — one block of 8
// warps per 128 x 128 output tile (4 warps per 16 x 64 tile for small
// blocks), a 3-stage cp.async ring with 16-byte copies (per-element loads
// where H or F are ragged), ldmatrix fragments.
//
// Design of G and G', fp32 (tests and references): a 64 x 64 (or 16 x 64) tile on the
// fp32 FMA pipes out of shared memory, 16 x 16 threads, so fp32 stays fp32
// end to end (no TF32).
//
// Design of G', bf16 and fp16 on G's wgmma layouts: gmm_dx_wgmma_kernel
// below (dx^T = w[e] dy^T per run of row tiles on m64n256k16, clusters of
// two blocks along N sharing dy's tiles, a producer warp and a 4-stage
// ring, only the blocks of real runs, no K split: on an H100 it took as
// long as G's K-split kernel at 512 tokens of Mixtral 8x7b, and less at
// Mixtral 8x160m's widths, chip_smoke.py phase 21).
//
// Design of G'', bf16 and fp16, block_rows a multiple of 16, H and F of 8:
// gmm_dw_wgmma_kernel below (a persistent grid of clusters of two blocks
// along H sharing dy's tiles, 128 x 256 tiles on m64n256k16, x^T and dy
// both MN-major wgmma operands fed by TMA, a producer warp keeping a
// 4-stage ring full across tiles, 16-byte stores); fp32 and the other
// layouts: a 64 x 64 FMA tile, gmm_dw_fma_kernel.

#include "hopper.cuh"

namespace {

constexpr int kBK = 64;      // rows of K per stage (tensor-core kernel)
constexpr int kBKF = 32;     // rows of K per stage (FMA kernel)
constexpr int kStages = 3;   // cp.async ring depth

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static uint16_t cvt(float f) {
    __nv_bfloat16 v = __float2bfloat16_rn(f);
    return *reinterpret_cast<uint16_t*>(&v);
  }
};
template <> struct Mma<__half> {
  __device__ __forceinline__ static void run(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static uint16_t cvt(float f) {
    __half v = __float2half_rn(f);
    return *reinterpret_cast<uint16_t*>(&v);
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row_addr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row_addr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The rows [m0, m_end) of this tile: its row block and the block's expert.
struct TileRows {
  int m0, m_end, e;
  bool skip;  // the tile's block is past *n_used: its rows are written as zeros
};
__device__ __forceinline__ TileRows tile_rows(const int* __restrict__ block_expert,
                                              const int* __restrict__ n_used, int P, int E,
                                              int block_rows, int tiles_per_block, int bm) {
  const int blk = blockIdx.x / tiles_per_block;
  TileRows t;
  t.skip = n_used != nullptr && blk >= __ldg(n_used);
  t.m0 = blk * block_rows + (blockIdx.x % tiles_per_block) * bm;
  t.m_end = min(min(t.m0 + bm, (blk + 1) * block_rows), P);
  const int e = __ldg(block_expert + blk);
  t.e = e < 0 ? 0 : (e >= E ? E - 1 : e);
  return t;
}

// rows [m0, m_end) x columns [n0, n0 + bn) of out, as zeros
template <typename U>
__device__ __forceinline__ void zero_tile(U* out, const TileRows& tr, int n0, int bn, int F,
                                          int threads) {
  const int w = min(bn, F - n0);
  for (int i = threadIdx.x; i < (tr.m_end - tr.m0) * w; i += threads)
    out[(long long)(tr.m0 + i / w) * F + n0 + i % w] = U(0);
}

// ---------------------------------------------------------------------------
// mma.sync kernel (bf16, fp16 off the wgmma kernel's layouts)
// ---------------------------------------------------------------------------
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, bool TW>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 2)
gmm_mma_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
               const int* __restrict__ block_expert, const int* __restrict__ n_used,
               uint16_t* __restrict__ out, int P, int H, int F, int E, int block_rows,
               int tiles_per_block, int x_vec, int w_vec) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's tile
  constexpr int MT = WM / 16, NT = WN / 8;             // its m16 and n8 pieces
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  constexpr int XS = kBK + 8;                          // padded rows: conflict-free ldmatrix
  constexpr int WS = TW ? kBK + 8 : BN + 8;             // TW: w's tile [BN][kBK], K contiguous
  constexpr int X_ELEMS = BM * XS, W_ELEMS = TW ? BN * WS : kBK * WS;
  constexpr int XCHUNKS = BM * kBK / 8, WCHUNKS = kBK * BN / 8;  // 16-byte chunks per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sx = reinterpret_cast<uint16_t*>(smem_raw);  // [kStages][BM][XS]
  uint16_t* sw = sx + kStages * X_ELEMS;                  // [kStages][kBK][WS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr0 = (warp / WARPS_N) * WM;
  const int wc0 = (warp % WARPS_N) * WN;
  const TileRows tr = tile_rows(block_expert, n_used, P, E, block_rows, tiles_per_block, BM);
  const int n0 = blockIdx.y * BN;
  if (tr.skip) {
    zero_tile(out, tr, n0, BN, F, THREADS);
    return;
  }
  const uint16_t* we = w + (long long)tr.e * H * F;
  const int nk = (H + kBK - 1) / kBK;

  auto load_stage = [&](int buf, int kt) {
    const int k0 = kt * kBK;
    uint16_t* dx = sx + buf * X_ELEMS;
    uint16_t* dw = sw + buf * W_ELEMS;
    for (int c = tid; c < XCHUNKS; c += THREADS) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const int m = tr.m0 + r, k = k0 + kc;
      uint16_t* dst = dx + r * XS + kc;
      if (x_vec) {  // H % 8 == 0: a chunk is all in or all out
        const bool ok = m < tr.m_end && k < H;
        cp_async16(dst, ok ? x + (long long)m * H + k : x, ok ? 16 : 0);
      } else {
        const uint16_t* src = x + (long long)m * H + k;
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = (m < tr.m_end && k + j < H) ? src[j] : uint16_t(0);
      }
    }
    if constexpr (TW) {  // w[e] stored [N][K]: (k, n) at n * H + k
      for (int c = tid; c < WCHUNKS; c += THREADS) {
        const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
        const int n = n0 + r, k = k0 + kc;
        uint16_t* dst = dw + r * WS + kc;
        if (w_vec) {  // H % 8 == 0
          const bool ok = n < F && k < H;
          cp_async16(dst, ok ? we + (long long)n * H + k : we, ok ? 16 : 0);
        } else {
          const uint16_t* src = we + (long long)n * H + k;
#pragma unroll
          for (int j = 0; j < 8; ++j) dst[j] = (n < F && k + j < H) ? src[j] : uint16_t(0);
        }
      }
      return;
    }
    for (int c = tid; c < WCHUNKS; c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int k = k0 + r, n = n0 + nc;
      uint16_t* dst = dw + r * WS + nc;
      if (w_vec) {  // F % 8 == 0
        const bool ok = k < H && n < F;
        cp_async16(dst, ok ? we + (long long)k * F + n : we, ok ? 16 : 0);
      } else {
        const uint16_t* src = we + (long long)k * F + n;
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = (k < H && n + j < F) ? src[j] : uint16_t(0);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage kt-1's buffer is free
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, nxt);
    cp_async_commit();
    const uint16_t* bx = sx + (kt % kStages) * X_ELEMS;
    const uint16_t* bw = sw + (kt % kStages) * W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[NT / 2][4];  // two n8 pieces per ldmatrix
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        if constexpr (TW)  // rows n, K contiguous: the fragments without a transpose
          ldmatrix_x4(b[j2], bw + (wc0 + j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * WS + kk +
                                 ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(b[j2], bw + (kk + (lane & 15)) * WS + wc0 + j2 * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, bx + (wr0 + mt * 16 + (lane & 15)) * XS + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          Mma<T>::run(acc[mt][2 * j2], a, b[j2]);
          Mma<T>::run(acc[mt][2 * j2 + 1], a, b[j2] + 2);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool pair_store = (F & 1) == 0;
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + wc0 + j * 8 + cq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = tr.m0 + wr0 + mt * 16 + (lane >> 2) + half * 8;
        if (m >= tr.m_end || n >= F) continue;
        const float v0 = acc[mt][j][half * 2], v1 = acc[mt][j][half * 2 + 1];
        uint16_t* dst = out + (long long)m * F + n;
        if (pair_store) {
          *reinterpret_cast<uint32_t*>(dst) = Mma<T>::pack(v0, v1);
        } else {
          dst[0] = Mma<T>::cvt(v0);
          if (n + 1 < F) dst[1] = Mma<T>::cvt(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// FMA-pipe kernel (fp32)
// ---------------------------------------------------------------------------
template <int BM, bool TW>
__global__ void __launch_bounds__(256)
gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ block_expert, const int* __restrict__ n_used,
               float* __restrict__ out, int P, int H, int F, int E, int block_rows,
               int tiles_per_block) {
  constexpr int BN = 64;
  constexpr int TM = BM / 16;                      // rows per thread
  constexpr int XS = BM + 4;                       // padded rows of the transposed x tile
  constexpr int XE = (BM * kBKF + 255) / 256;       // x elements per thread per stage
  __shared__ __align__(16) float sx[2][kBKF][XS];   // [k][m]
  // TW: rows padded by 4 floats, so a warp's stores down one column of K
  // spread over 8 banks (float4 reads stay aligned)
  __shared__ __align__(16) float sw[2][kBKF][TW ? BN + 4 : BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4 .. +3
  const int ty = tid >> 4;  // rows ty*TM .. +TM-1
  const TileRows tr = tile_rows(block_expert, n_used, P, E, block_rows, tiles_per_block, BM);
  const int n0 = blockIdx.y * BN;
  if (tr.skip) {
    zero_tile(out, tr, n0, BN, F, 256);
    return;
  }
  const float* we = w + (long long)tr.e * H * F;
  const int nk = (H + kBKF - 1) / kBKF;
  const int w_row = tid >> 3, w_col = (tid & 7) * 8;  // 8 weights a thread per stage

  float xr[XE], wr[8];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int idx = tid + e * 256;
      const int m = tr.m0 + idx / kBKF, k = k0 + idx % kBKF;
      xr[e] = (idx < BM * kBKF && m < tr.m_end && k < H) ? __ldg(x + (long long)m * H + k) : 0.f;
    }
    if constexpr (TW) {  // w[e] [N][K]: a warp reads 32 consecutive k of one n
      const int k = k0 + (tid & 31), nb = n0 + (tid >> 5) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wr[j] = (k < H && nb + j < F) ? __ldg(we + (long long)(nb + j) * H + k) : 0.f;
    } else {
      const int k = k0 + w_row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + w_col + j;
        wr[j] = (k < H && n < F) ? __ldg(we + (long long)k * F + n) : 0.f;
      }
    }
  };
  auto store_stage = [&](int buf) {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int idx = tid + e * 256;
      if (idx < BM * kBKF) sx[buf][idx % kBKF][idx / kBKF] = xr[e];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (TW)
        sw[buf][tid & 31][(tid >> 5) * 8 + j] = wr[j];
      else
        sw[buf][w_row][w_col + j] = wr[j];
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int s = 0; s < nk; ++s) {
    const int buf = s & 1;
    if (s + 1 < nk) load_stage((s + 1) * kBKF);
#pragma unroll 8
    for (int k = 0; k < kBKF; ++k) {
      const float4 wv4 = *reinterpret_cast<const float4*>(&sw[buf][k][tx * 4]);
      const float wv[4] = {wv4.x, wv4.y, wv4.z, wv4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xv = sx[buf][k][ty * TM + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
      }
    }
    if (s + 1 < nk) store_stage(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tr.m0 + ty * TM + i;
    if (m >= tr.m_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < F) out[(long long)m * F + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma kernel (bf16, fp16; block_rows a multiple of 128, H and F of 8)
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 256;  // two consumer warpgroups
constexpr int kWgBM = 128;       // rows of a row tile, 64 per warpgroup
constexpr int kWgBN = 128;       // output columns of a block
constexpr int kWgTiles = 2;      // row tiles of one expert a block takes at most
constexpr int kWgBK = 64;        // K per pipeline step
constexpr int kWgStages = 4;
// steps in flight ahead of the one computed: a step's stage is released
// once the next step's products are issued (wgmma keeps one group in
// flight), so the stage refilled held the step two before the current one
constexpr int kWgAhead = 2;
constexpr int kWgX = kWgBM * kWgBK;  // elements of one x tile
constexpr int kWgW = kWgBK * kWgBN;  // elements of one w tile
constexpr size_t kWgSmem =
    1024 + (size_t)kWgStages * (kWgTiles * kWgX + kWgW) * 2 + 2 * kWgStages * 8;
// descriptor strides of the 128-byte-swizzled tiles: 8-row atoms of 1024
// bytes; w's two 64-column atoms (64 K rows each) 8 KB apart
constexpr uint32_t kSbo = 1024, kWLbo = 64 * 64 * 2, kXLbo = 16;

struct WgArgs {
  const int* block_expert;
  const int* n_used;  // null, or the device count of blocks holding a real row
  void* out;
  float* part;        // K split: fp32 partials [splits][P][F], else null
  int P, H, F, E, block_rows, steps_per_split;
};

__device__ __forceinline__ int tile_expert(const WgArgs& a, int t) {
  const int e = __ldg(a.block_expert + (long long)t * kWgBM / a.block_rows);
  return e < 0 ? 0 : (e >= a.E ? a.E - 1 : e);
}

// the K loop and the epilogue of NT live row tiles (1 or 2, a compile-time
// count, so no product is issued under a branch)
template <typename T, int NT, typename Issue>
__device__ __forceinline__ void gmm_tiles(const WgArgs& a, const T* Xs, const T* Ws,
                                          uint64_t* full, uint64_t* empty, int steps,
                                          bool issuer, Issue issue, int t0, int n0) {
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x - 128 * c;
  const int lane = tid & 31;
  float acc[NT][kWgBN / 2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < kWgBN / 2; ++i) acc[j][i] = 0.f;

  for (int i = 0; i < steps; ++i) {
    if (issuer && i + kWgAhead < steps) issue(i + kWgAhead);
    const int st = i % kWgStages;
    mbar_wait(&full[st], (i / kWgStages) & 1);
    const T* Wc = Ws + st * kWgW;
    wg_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const T* Xc = Xs + (st * kWgTiles + j) * kWgX + 64 * c * kWgBK;  // this warpgroup's rows
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        WgmmaSSt<T, kWgBN>::run(acc[j], gmma_desc_sw<64>(Xc + kk * 16, kXLbo, kSbo),
                                gmma_desc_sw<64>(Wc + kk * 16 * 64, kWLbo, kSbo), 1);
    }
    wg_commit();
    wg_wait<1>();  // step i - 1's products are done: its stage is free
    if (i > 0) mbar_arrive(&empty[(i - 1) % kWgStages]);
  }
  wg_wait<0>();
#pragma unroll
  for (int j = 0; j < NT; ++j) pin(acc[j]);

  // rows 64 c + 16 warp + lane / 4 (+ 8) of each tile, columns
  // n0 + 8 q + 2 (lane % 4) (+ 1)
  T* out = static_cast<T*>(a.out);
  const int rw = 64 * c + 16 * (tid >> 5) + (lane >> 2);
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = (long long)(t0 + j) * kWgBM + rw + 8 * r;
#pragma unroll
      for (int q = 0; q < kWgBN / 8; ++q) {
        const int col = n0 + 8 * q + cq;
        if (col >= a.F) continue;
        const float v0 = acc[j][4 * q + 2 * r], v1 = acc[j][4 * q + 2 * r + 1];
        if (a.part != nullptr)
          *reinterpret_cast<float2*>(a.part + ((long long)blockIdx.z * a.P + row) * a.F + col) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(out + row * a.F + col) = Cvt<T>::pack(v0, v1);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw, const WgArgs a) {
  const int n_tiles = a.P / kWgBM;
  const int t0 = blockIdx.x;
  const int e = tile_expert(a, t0);
  // blocks start at even tiles and at run starts; an odd tile of a run is
  // its even neighbour's second tile
  if (kWgTiles == 2 && (t0 & 1) && tile_expert(a, t0 - 1) == e) return;
  const int nt = (kWgTiles == 2 && !(t0 & 1) && t0 + 1 < n_tiles && tile_expert(a, t0 + 1) == e)
                     ? 2
                     : 1;
  const int used = a.n_used != nullptr
                       ? min(__ldg(a.n_used) * (a.block_rows / kWgBM), n_tiles)
                       : n_tiles;
  const int live = max(0, min(nt, used - t0));  // tiles with a real row
  const int n0 = blockIdx.y * kWgBN;
  const int nk = (a.H + kWgBK - 1) / kWgBK;
  const int kk0 = blockIdx.z * a.steps_per_split;
  const int steps = live > 0 ? min(nk, kk0 + a.steps_per_split) - kk0 : 0;

  T* out = static_cast<T*>(a.out);
  if (a.part == nullptr && live < nt) {  // rows past the real ones: zeros
    const int r0 = (t0 + live) * kWgBM, rows = (nt - live) * kWgBM;
    const int w = min(kWgBN, a.F - n0);
    for (int i = threadIdx.x; i < rows * (w / 2); i += kWgThreads)
      *reinterpret_cast<uint32_t*>(out + (long long)(r0 + i / (w / 2)) * a.F + n0 +
                                   2 * (i % (w / 2))) = 0u;
  }
  if (steps <= 0) return;

  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: tiles start on that
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Xs = reinterpret_cast<T*>(base);       // [stages][tiles][BM][BK], rows of 128 bytes
  T* Ws = Xs + kWgStages * kWgTiles * kWgX;  // [stages][BN/64][BK][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + kWgStages * kWgW);
  uint64_t* empty = full + kWgStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 keeps the ring kWgAhead steps ahead: step i brings the live
  // tiles' x columns and the expert's w rows of K step kk0 + i
  const bool issuer = threadIdx.x == 0;
  auto issue = [&](int i) {
    const int st = i % kWgStages;
    if (i >= kWgStages) mbar_wait(&empty[st], (i / kWgStages - 1) & 1);
    const int k = (kk0 + i) * kWgBK;
    mbar_arrive_tx(&full[st], (uint32_t)(live * kWgX + kWgW) * 2u);
    for (int j = 0; j < live; ++j)
      tma_load_2d(Xs + (st * kWgTiles + j) * kWgX, &tx, k, (t0 + j) * kWgBM, &full[st]);
    for (int h = 0; h < kWgBN / 64; ++h)
      tma_load_3d(Ws + st * kWgW + h * 64 * kWgBK, &tw, n0 + 64 * h, k, e, &full[st]);
  };
  if (issuer)
    for (int i = 0; i < min(steps, kWgAhead); ++i) issue(i);
  if (kWgTiles == 2 && live == 2)
    gmm_tiles<T, kWgTiles>(a, Xs, Ws, full, empty, steps, issuer, issue, t0, n0);
  else
    gmm_tiles<T, 1>(a, Xs, Ws, full, empty, steps, issuer, issue, t0, n0);
}

// ---------------------------------------------------------------------------
// G': dx = dy w[e]^T, w read as stored (bf16, fp16; block_rows a multiple
// of 128, H and F of 8; no K split)
// ---------------------------------------------------------------------------
constexpr int kDxStages = 4;
constexpr int kDxThreads = kWgThreads + 32;  // two consumer warpgroups and a producer warp
constexpr int kDxRows = kWgTiles * kWgBM;    // dy rows of a run's products (both tiles)
// a band of runs holds this many bytes of dy rows (kernel comment below)
constexpr long long kDxBand = 24LL << 20;
constexpr size_t kDxSmem = 1024 + (size_t)kDxStages * (kWgTiles * kWgX + kWgW) * 2 + 2 * kDxStages * 8;
constexpr int kDxPad = kWgBN + 8;  // elements of a staged dx row (16 bytes spread the banks)

// the slot-th (from 0) block start of G's pairing rule in ascending tile
// order (tiles that are even or whose expert differs from the tile
// before's), -1 past the last; a warp's ballots over 32 tiles at a time,
// every lane gets it
__device__ __forceinline__ int run_start(const WgArgs& a, int n_tiles, int slot) {
  const int lane = threadIdx.x & 31;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int t = t0 + lane;
    const bool start = t < n_tiles && ((t & 1) == 0 || tile_expert(a, t - 1) != tile_expert(a, t));
    unsigned m = __ballot_sync(0xffffffffu, start);
    const int n = __popc(m);
    if (slot < n) {
      for (int k = 0; k < slot; ++k) m &= m - 1;
      return t0 + __ffs(m) - 1;
    }
    slot -= n;
  }
  return -1;
}

// the ring steps a run takes: its nk K steps and at least a whole ring.
// The epilogue stages the tile over the ring's first stages, so it must
// hold every stage: with nk < kDxStages the steps past K bring nothing and
// only keep the producers off the stages a run before released.
__device__ __forceinline__ int dx_ring_steps(int nk) { return max(nk, kDxStages); }

// one run by the two consumer warpgroups: warpgroup c computes dx's
// columns n0 + 64 c .. + 63 for the run's 256 rows as (w[e] dy^T), A its 64
// rows of the step's w box, B the run's dy rows (a second tile's are
// computed but not stored when only one is live), both K-major
// (m64n256k16, 128 fp32 accumulators a thread): every dy row is read once
// per warpgroup and k16.  Steps g0 .. g0 + dx_ring_steps(nk) - 1 of the
// ring; the last kDxStages stages, so every stage, stay held until the
// epilogue has staged the tile in the ring, transposed by stmatrix, and
// written it out, 16 bytes a thread, a row's 256 bytes by 16 neighbouring
// threads.
template <typename T>
__device__ __forceinline__ void dx_run(const WgArgs& a, T* ring, const T* Xs, const T* Ws,
                                       uint64_t* full, uint64_t* empty, int g0, int nk, int t0,
                                       int n0, int live) {
  constexpr int N = kDxRows;
  const int c = threadIdx.x / 128, w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  auto release = [&](int g) {  // a warp's release of a stage to both blocks' producers
    if (lane == 0) {
      mbar_arrive_cluster(&empty[g % kDxStages], 0);
      mbar_arrive_cluster(&empty[g % kDxStages], 1);
    }
  };
  const int steps = dx_ring_steps(nk);
  float acc[N / 2];  // a new sum at the first k16
  for (int i = 0; i < steps; ++i) {
    const int g = g0 + i, st = g % kDxStages;
    mbar_wait(&full[st], (g / kDxStages) & 1);
    if (i >= nk) continue;  // past K: the stage is only held
    wg_fence();
    const T* Ac = Ws + st * kWgW + 64 * c * kWgBK;  // w's rows n0 + 64 c ..
    const T* Bc = Xs + st * kWgTiles * kWgX;        // the run's dy rows
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      WgmmaSS<T, N>::run(acc, gmma_desc_sw<64>(Ac + kk * 16, kXLbo, kSbo),
                         gmma_desc_sw<64>(Bc + kk * 16, kXLbo, kSbo), (i | kk) != 0);
    wg_commit();
    wg_wait<1>();  // step g - 1's products are done: its stage is free
    if (i > 0 && i - 1 < steps - kDxStages) release(g - 1);
  }
  wg_wait<0>();
  pin(acc);
  bar_sync(1, kWgThreads);  // every product of the run is done: the ring is free
  // dx^T's 8 x 8 blocks (this warp's 16 columns, rows 8 q ..) transposed
  // into D [N rows][kDxPad]: matrix j of a stmatrix is block (q + j / 2,
  // column half j % 2)
  T* D = ring;
  const int mat = lane >> 3, t = lane & 7;
#pragma unroll
  for (int q = 0; q < N / 8; q += 2) {
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = Cvt<T>::pack(acc[4 * q + 2 * j], acc[4 * q + 2 * j + 1]);
    stmatrix_x4_trans(D + (8 * (q + (mat >> 1)) + t) * kDxPad + 64 * c + 16 * w + 8 * (mat & 1), v);
  }
  bar_sync(1, kWgThreads);
  T* out = static_cast<T*>(a.out);
  const int cols = min(kWgBN, a.F - n0);
  for (int i = threadIdx.x; i < live * kWgBM * (kWgBN / 8); i += kWgThreads) {
    const int r = i / (kWgBN / 8), ch = i % (kWgBN / 8);
    if (8 * ch < cols)
      *reinterpret_cast<uint4*>(out + (long long)(t0 * kWgBM + r) * a.F + n0 + 8 * ch) =
          *reinterpret_cast<const uint4*>(D + r * kDxPad + 8 * ch);
  }
  bar_sync(1, kWgThreads);  // D is read: the ring may be refilled
  for (int i = steps - kDxStages; i < steps; ++i) release(g0 + i);
}

// G' on wgmma: the row tiles paired into runs as in G (up to two
// consecutive tiles of one expert), in clusters of two blocks along N.
// The two blocks of a cluster share a run and take columns n0 and n0 +
// 128: each loads its own 128 x 64 box of w (K-major as stored) and one of
// the run's two 128 x 64 dy tiles, multicast into both blocks, so a K step
// brings 32 of its 48 KB from L2 (131 FLOP per byte).  The grid holds P /
// 256 + E slots (the runs a sorted map can have) in bands of gridDim.x
// slots along z, each band's column pairs along y: launched in that order,
// the clusters take every column pair of a band (as many runs as kDxBand
// bytes of dy rows) before the next band, so a band's dy rows stay in L2
// while its experts' w streams past them once.  A slot's run is found on
// the device by ballots (run_start), so nothing is read on the host and no
// block is launched for an odd tile; the slots past the last run take
// those a map with more runs has.  A producer warp keeps a 4-stage ring
// full, refilling a stage once the consumer warps of both blocks have
// released it; the two consumer warpgroups only compute (dx_run), with 128
// accumulators a thread under the 168 registers a thread has beside a
// producer warp.  The sums are G's: per output, fp32
// over K in steps of 64, k16 by k16, rounded once.  Rows of tiles past
// *n_used are zeros and never computed; a block whose columns lie past N
// still multicasts its dy tile and writes nothing.
template <typename T>
__global__ void __launch_bounds__(kDxThreads, 1)
    gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tdy,
                        const __grid_constant__ CUtensorMap tw, const WgArgs a) {
  // in the kernels' terms a.H is K (the layer's F) and a.F is N (its H)
  const int n_tiles = a.P / kWgBM;
  const uint32_t rank = cluster_rank();
  const int n0 = blockIdx.y * kWgBN;
  const bool n_live = n0 < a.F;
  const int nk = (a.H + kWgBK - 1) / kWgBK;
  const int used = a.n_used != nullptr ? max(0, min(__ldg(a.n_used) * (a.block_rows / kWgBM), n_tiles))
                                       : n_tiles;
  const bool producer = threadIdx.x >= kWgThreads;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Xs = reinterpret_cast<T*>(base);       // [stages][tiles][BM][BK], rows of 128 bytes
  T* Ws = Xs + kDxStages * kWgTiles * kWgX;  // [stages][BN][BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + kDxStages * kWgW);
  uint64_t* empty = full + kDxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWgThreads / 32);  // every consumer warp of both blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  int g = 0;  // steps of the ring used so far
  for (int slot = blockIdx.z * gridDim.x + blockIdx.x;; slot += gridDim.x * gridDim.z) {
    const int t0 = run_start(a, n_tiles, slot);
    if (t0 < 0) break;
    const int e = tile_expert(a, t0);
    const int nt = (!(t0 & 1) && t0 + 1 < n_tiles && tile_expert(a, t0 + 1) == e) ? 2 : 1;
    const int live = max(0, min(nt, used - t0));  // tiles with a real row
    if (!producer && live < nt && n_live)  // rows past the real ones: zeros
      zero_rows16(static_cast<T*>(a.out), a.F, (t0 + live) * kWgBM, (t0 + nt) * kWgBM, n0,
                  min(n0 + kWgBN, a.F), kWgThreads);
    if (live == 0) continue;
    if (producer) {
      // step i: the live dy tiles' K columns (rank r brings tile r of the
      // run, multicast) and this block's w box; a step past K brings nothing
      if (threadIdx.x == kWgThreads)
        for (int i = 0; i < dx_ring_steps(nk); ++i) {
          const int gi = g + i, st = gi % kDxStages;
          if (gi >= kDxStages) mbar_wait(&empty[st], (gi / kDxStages - 1) & 1);
          if (i >= nk) {
            mbar_arrive(&full[st]);
            continue;
          }
          const int k = i * kWgBK;
          mbar_arrive_tx(&full[st], (uint32_t)(live * kWgX + (n_live ? kWgW : 0)) * 2u);
          if ((int)rank < live)
            tma_load_2d_mc(Xs + (st * kWgTiles + (int)rank) * kWgX, &tdy, k,
                           (t0 + (int)rank) * kWgBM, &full[st], 0x3);
          if (n_live) tma_load_3d(Ws + st * kWgW, &tw, k, n0, e, &full[st]);
        }
    } else {
      dx_run<T>(a, Xs, Xs, Ws, full, empty, g, nk, t0, n_live ? n0 : a.F, live);
    }
    g += dx_ring_steps(nk);
  }
  __syncwarp();
  cluster_sync();  // no block exits while another may still signal it
}

// out = the splits' partials added in split order, rounded once; rows of
// blocks past *n_used are zeros
template <typename T>
__global__ void gmm_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                                  const int* __restrict__ n_used, int P, int F, int block_rows,
                                  int splits) {
  const long long n = (long long)P * F;
  const long long live = n_used != nullptr ? min((long long)__ldg(n_used) * block_rows, (long long)P) * F : n;
  for (long long i = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 2LL * gridDim.x * blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    if (i < live) {
      v = *reinterpret_cast<const float2*>(part + i);
      for (int s = 1; s < splits; ++s) {
        const float2 p = *reinterpret_cast<const float2*>(part + s * n + i);
        v.x += p.x;
        v.y += p.y;
      }
    }
    *reinterpret_cast<uint32_t*>(out + i) = Cvt<T>::pack(v.x, v.y);
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 132;
    return v;
  }();
  return n;
}

// the K splits of a layout: 1 unless the blocks (at most one per expert and
// column tile when every expert holds one tile, as at decode) would not
// cover the card twice; every split gets at least 8 K steps
int gmm_splits(int P, int H, int F, int E) {
  const int col_tiles = (F + kWgBN - 1) / kWgBN;
  const int row_tiles = P / kWgBM;
  if (row_tiles > 2 * E) return 1;
  const int blocks = min(row_tiles, E) * col_tiles;
  const int nk = (H + kWgBK - 1) / kWgBK;
  int s = (2 * sm_count() + blocks - 1) / blocks;
  s = min(s, max(1, nk / 8));
  return max(1, min(s, 8));
}

// `kernel` launched in clusters of `cl` blocks of `threads` along x (dim
// 0) or y (dim 1)
template <typename... Exp, typename... Act>
cudaError_t launch_cluster(void (*kernel)(Exp...), dim3 grid, int threads, int dim, int cl,
                           size_t smem, cudaStream_t st, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = dim == 0 ? cl : 1;
  at[0].val.clusterDim.y = dim == 1 ? cl : 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the clusters of `cl` blocks of `kernel` (smem bytes each) the card holds
// at once: the occupancy query, else the SMs over cl
template <typename Kernel>
int max_clusters(Kernel kernel, int threads, size_t smem, int cl) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg) !=
          cudaSuccess ||
      n <= 0) {
    (void)cudaGetLastError();
    n = sm_count() / cl;
  }
  return n;
}

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* w, const int* be, const int* n_used,
                         void* out, void* part, int P, int H, int F, int E, int block_rows,
                         cudaStream_t st) {
  // x as (H, P), boxes of 64 x 128; w as (F, H, E), boxes of 64 x 64 x 1;
  // K past H and columns past F arrive as zeros
  CUtensorMap m[2];
  const cuuint64_t e = 2;
  const cuuint64_t xd[2] = {(cuuint64_t)H, (cuuint64_t)P};
  const cuuint64_t xs[1] = {(cuuint64_t)H * e};
  const cuuint32_t xb[2] = {kWgBK, kWgBM};
  const cuuint64_t wd[3] = {(cuuint64_t)F, (cuuint64_t)H, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)F * e, (cuuint64_t)H * F * e};
  const cuuint32_t wb[3] = {64u, (cuuint32_t)kWgBK, 1};
  cudaError_t err;
  if ((err = encode_map<T>(&m[0], x, 2, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = encode_map<T>(&m[1], w, 3, wd, ws, wb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return err;
  static const cudaError_t attr = opt_in(gmm_wgmma_kernel<T>, kWgSmem);
  if (attr != cudaSuccess) return attr;
  const int nk = (H + kWgBK - 1) / kWgBK;
  const int splits = part != nullptr ? gmm_splits(P, H, F, E) : 1;
  const int per = (nk + splits - 1) / splits;
  const int used_splits = (nk + per - 1) / per;  // no split is empty
  const WgArgs a{be, n_used, out, used_splits > 1 ? static_cast<float*>(part) : nullptr,
                 P, H, F, E, block_rows, per};
  const dim3 grid((unsigned)(P / kWgBM), (unsigned)((F + kWgBN - 1) / kWgBN),
                  (unsigned)used_splits);
  gmm_wgmma_kernel<T><<<grid, kWgThreads, kWgSmem, st>>>(m[0], m[1], a);
  if (used_splits > 1) {
    const cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return e1;
    const long long pairs = (long long)P * F / 2;
    const int blocks = (int)min((pairs + 255) / 256, (long long)(8 * sm_count()));
    gmm_reduce_kernel<T><<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                                 static_cast<T*>(out), n_used, P, F,
                                                 block_rows, used_splits);
  }
  return cudaGetLastError();
}

// G' on the cluster kernel (no K split): dy as (K, P), boxes of 64 x 128;
// w[e] stored [N][K], as (K, N, E), boxes of 64 x 128 x 1; K past its end
// and rows past N arrive as zeros
template <typename T>
cudaError_t launch_dx_wgmma(const void* dy, const void* w, const int* be, const int* n_used,
                            void* dx, int P, int K, int N, int E, int block_rows, cudaStream_t st) {
  CUtensorMap m[2];
  const cuuint64_t e = 2;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)P}, xs[1] = {(cuuint64_t)K * e};
  const cuuint32_t xb[2] = {kWgBK, kWgBM};
  const cuuint64_t wd[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)K * e, (cuuint64_t)K * N * e};
  const cuuint32_t wb[3] = {kWgBK, kWgBN, 1};
  cudaError_t err;
  if ((err = encode_map<T>(&m[0], dy, 2, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = encode_map<T>(&m[1], w, 3, wd, ws, wb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return err;
  auto kern = gmm_dx_wgmma_kernel<T>;
  static const cudaError_t attr = opt_in(kern, kDxSmem);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = P / kWgBM;
  const int slots = min(n_tiles, (n_tiles + 1) / 2 + E);
  const int pairs = (N + 2 * kWgBN - 1) / (2 * kWgBN);
  if (pairs > 32767) return cudaErrorInvalidConfiguration;
  const int band = (int)max(1LL, min((long long)slots, kDxBand / ((long long)kDxRows * K * 2)));
  const int bands = (slots + band - 1) / band;
  if (bands > 65535) return cudaErrorInvalidConfiguration;
  const WgArgs a{be, n_used, dx, nullptr, P, K, N, E, block_rows, 0};
  return launch_cluster(kern, dim3((unsigned)band, (unsigned)(2 * pairs), (unsigned)bands),
                        kDxThreads, 1, 2, kDxSmem, st, m[0], m[1], a);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16u == 0; }

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, bool TW>
cudaError_t launch_mma(const void* x, const void* w, const int* be, const int* n_used, void* out,
                       int P, int H, int F, int E, int block_rows, cudaStream_t st) {
  constexpr int XS = kBK + 8;
  constexpr int SMEM = kStages * (BM * XS + (TW ? BN * (kBK + 8) : kBK * (BN + 8))) * 2;
  auto kern = gmm_mma_kernel<T, BM, BN, WARPS_M, WARPS_N, TW>;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles_per_block = (block_rows + BM - 1) / BM;
  const long long row_tiles = (long long)(P / block_rows) * tiles_per_block;
  const int col_tiles = (F + BN - 1) / BN;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return cudaErrorInvalidConfiguration;
  const int x_vec = (H % 8 == 0) && aligned16(x);
  const int w_vec = ((TW ? H : F) % 8 == 0) && aligned16(w);
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  kern<<<grid, WARPS_M * WARPS_N * 32, SMEM, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), be, n_used,
      static_cast<uint16_t*>(out), P, H, F, E, block_rows, tiles_per_block, x_vec, w_vec);
  return cudaGetLastError();
}

template <int BM, bool TW>
cudaError_t launch_fma(const void* x, const void* w, const int* be, const int* n_used, void* out,
                       int P, int H, int F, int E, int block_rows, cudaStream_t st) {
  const int tiles_per_block = (block_rows + BM - 1) / BM;
  const long long row_tiles = (long long)(P / block_rows) * tiles_per_block;
  const int col_tiles = (F + 63) / 64;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  gmm_fma_kernel<BM, TW><<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                            static_cast<const float*>(w), be, n_used,
                                            static_cast<float*>(out), P, H, F, E, block_rows,
                                            tiles_per_block);
  return cudaGetLastError();
}

// the layouts the wgmma kernel takes; the others take the mma.sync kernel
bool wgmma_layout(const void* x, const void* w, int dtype, int H, int F, int block_rows) {
  return dtype != 0 && block_rows % kWgBM == 0 && H % 8 == 0 && F % 8 == 0 && aligned16(x) &&
         aligned16(w);
}


// ---------------------------------------------------------------------------
// G'': per-expert dW = sum over the expert's row blocks of x_b^T dy_b
// ---------------------------------------------------------------------------
// The blocks below *n_used that belong to expert e: the first (lo), the
// last + 1 (hi) and their count (n; lo == hi, n == 0 when there is none).
// Each thread scans the map itself, so nothing is read on the host.  A
// sorted map (the router's) gives n == hi - lo; blocks of other experts
// inside [lo, hi) are skipped, so any map gives the sum over e's blocks.
struct BlockSpan {
  int lo, hi, n;
};
__device__ __forceinline__ int clamp_expert(int e, int E) { return e < 0 ? 0 : (e >= E ? E - 1 : e); }
__device__ __forceinline__ BlockSpan expert_span(const int* __restrict__ be,
                                                 const int* __restrict__ n_used, int n_blocks,
                                                 int E, int e) {
  const int nu = n_used != nullptr ? max(0, min(__ldg(n_used), n_blocks)) : n_blocks;
  BlockSpan s{nu, nu, 0};
  for (int b = 0; b < nu; ++b)
    if (clamp_expert(__ldg(be + b), E) == e) {
      if (s.n++ == 0) s.lo = b;
      s.hi = b + 1;
    }
  if (s.n == 0) s.lo = s.hi = 0;
  return s;
}

// a warp's scan of the same: 32 map entries a load, every lane gets the span
__device__ __forceinline__ BlockSpan expert_span_warp(const int* __restrict__ be,
                                                      const int* __restrict__ n_used, int n_blocks,
                                                      int E, int e) {
  const int lane = threadIdx.x & 31;
  const int nu = n_used != nullptr ? max(0, min(__ldg(n_used), n_blocks)) : n_blocks;
  BlockSpan s{0, 0, 0};
  for (int b0 = 0; b0 < nu; b0 += 32) {
    const int b = b0 + lane;
    const unsigned m = __ballot_sync(0xffffffffu, b < nu && clamp_expert(__ldg(be + b), E) == e);
    if (m != 0u) {
      if (s.n == 0) s.lo = b0 + __ffs(m) - 1;
      s.hi = b0 + 32 - __clz(m);
      s.n += __popc(m);
    }
  }
  return s;
}

constexpr int kDwStages = 4;
constexpr int kDwThreads = kWgThreads + 32;  // two consumer warpgroups and a producer warp
constexpr int kDwBM = 128;  // rows of H a block takes (64 per warpgroup)
constexpr int kDwBN = 256;  // columns of F a block takes

template <int S>  // rows of K per step: 64, or 16 for blocks off a multiple of 64
constexpr size_t dw_smem() {
  return 1024 + (size_t)kDwStages * ((kDwBM + kDwBN) * S * 2 + 2 * 8);
}

// wgmma kernel (bf16, fp16; block_rows a multiple of 16, H and F of 8).  A
// persistent grid of clusters of two blocks.  A cluster's tile is 256 rows
// of H x 256 columns of F of one expert's dw; rank r takes rows m0 + 128 r,
// so the two share every dy tile: each loads its own x^T tile (S rows x 128
// columns, two 64-column boxes) and half of the step's S x 256 dy tile,
// multicast into both blocks (131 FLOP per byte brought from L2).  Clusters
// walk the tiles expert-major (column tile, then row pair), so an expert's
// rows stay in L2.  A producer warp keeps a 4-stage ring full across tile
// boundaries, so the next tile's first loads land while a tile's epilogue
// runs; it refills a stage once the consumer warps of both blocks have
// released it (the empty barrier counts 16 warps), and the consumers only
// compute.  x^T is wgmma's A operand and dy its B, both MN-major, so
// neither is transposed in memory; warpgroup c takes 64 rows x 256 columns
// (m64n256k16, 128 fp32 accumulators a thread, under the 168 registers a
// thread has beside a producer warp).  Sums in fp32 over the expert's
// blocks in ascending order, k16 by k16 (the same sum whatever the tile's
// width), written once in dw's type with 16-byte stores: no atomics, the
// same bits on every call.  Every warp, the producer's too, finds an
// expert's blocks with the same ballots (expert_span_warp) when its tile's
// expert changes, so the two sides of the ring count the same steps.  A block whose rows
// lie past H (H off a multiple of 256) still multicasts its half of dy and
// writes nothing.
template <typename T, int S>
__global__ void __launch_bounds__(kDwThreads, 1)
    gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tdy, const int* __restrict__ be,
                        const int* __restrict__ n_used, T* __restrict__ dw, int P, int H, int F,
                        int E, int block_rows) {
  constexpr int BOX = S * 64;  // elements of one 64-column box of S rows
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / 2, n_clusters = gridDim.x / 2;
  const int m_pairs = (H + 2 * kDwBM - 1) / (2 * kDwBM), n_tiles = (F + kDwBN - 1) / kDwBN;
  const int per_e = m_pairs * n_tiles, tiles = E * per_e;
  const int n_blocks = P / block_rows, spb = block_rows / S;
  const int c = threadIdx.x / 128, lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* As = reinterpret_cast<T*>(base);  // [stages][2][S][64]: x's columns m0 ..
  T* Bs = As + kDwStages * 2 * BOX;    // [stages][4][S][64]: dy's columns n0 ..
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kDwStages * 4 * BOX);
  uint64_t* empty = full + kDwStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWgThreads / 32);  // every consumer warp of both blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // tile t: its expert, this block's first row of H and the first column
  auto tile = [&](int t, int& e, int& m0, int& n0) {
    e = t / per_e;
    const int r = t % per_e;
    n0 = (r / m_pairs) * kDwBN;
    m0 = ((r % m_pairs) * 2 + (int)rank) * kDwBM;
  };

  if (threadIdx.x >= kWgThreads) {
    // the producer warp walks the cluster's tiles, finding each expert's
    // blocks as the consumer warps do; its lane 0 brings, in each tile, the
    // expert's blocks in ascending order (the k-th at b), every step into
    // its stage once both blocks have released it
    int g = 0, pe = -1;
    BlockSpan span{0, 0, 0};
    for (int t = cluster; t < tiles; t += n_clusters) {
      int e, m0, n0;
      tile(t, e, m0, n0);
      if (e != pe) {
        pe = e;
        span = expert_span_warp(be, n_used, n_blocks, E, e);
      }
      if (lane == 0) {
        const bool x_live = m0 < H;
        for (int i = 0, b = span.lo - 1, k = -1; i < span.n * spb; ++i, ++g) {
          const int st = g % kDwStages;
          if (g >= kDwStages) mbar_wait(&empty[st], (g / kDwStages - 1) & 1);
          while (k < i / spb)
            if (clamp_expert(__ldg(be + ++b), E) == e) ++k;
          const int r0 = b * block_rows + (i % spb) * S;
          mbar_arrive_tx(&full[st], (uint32_t)((x_live ? 6 : 4) * BOX) * 2u);
          if (x_live)
            for (int h = 0; h < 2; ++h)
              tma_load_2d(As + (st * 2 + h) * BOX, &tx, m0 + 64 * h, r0, &full[st]);
          for (int h = 2 * (int)rank; h < 2 * (int)rank + 2; ++h)
            tma_load_2d_mc(Bs + (st * 4 + h) * BOX, &tdy, n0 + 64 * h, r0, &full[st], 0x3);
        }
      }
    }
  } else {
    // a warp's release of a stage to the producers of both blocks
    auto release = [&](int g) {
      if (lane == 0) {
        mbar_arrive_cluster(&empty[g % kDwStages], 0);
        mbar_arrive_cluster(&empty[g % kDwStages], 1);
      }
    };
    float acc[kDwBN / 2];  // a new sum at each tile's first k16
    int g = 0, cur_e = -1;
    BlockSpan span{0, 0, 0};
    for (int t = cluster; t < tiles; t += n_clusters) {
      int e, m0, n0;
      tile(t, e, m0, n0);
      if (e != cur_e) {
        cur_e = e;
        span = expert_span_warp(be, n_used, n_blocks, E, e);
      }
      const int steps = span.n * spb;
      T* out = dw + (long long)e * H * F;
      if (steps == 0) {  // an expert with no rows: zeros
        zero_rows16(out, F, m0, min(m0 + kDwBM, H), n0, min(n0 + kDwBN, F), kWgThreads);
        continue;
      }
      for (int i = 0; i < steps; ++i, ++g) {
        const int st = g % kDwStages;
        mbar_wait(&full[st], (g / kDwStages) & 1);
        wg_fence();
        const T* Ac = As + (st * 2 + c) * BOX;  // this warpgroup's 64 rows of H
        const T* Bc = Bs + st * 4 * BOX;
#pragma unroll
        for (int kk = 0; kk < S / 16; ++kk)
          WgmmaSStt<T, kDwBN>::run(acc, gmma_desc_sw<64>(Ac + kk * 16 * 64, BOX * 2, kSbo),
                                   gmma_desc_sw<64>(Bc + kk * 16 * 64, BOX * 2, kSbo),
                                   (i | kk) != 0);
        wg_commit();
        wg_wait<1>();  // step g - 1's products are done: its stage is free
        if (i > 0) release(g - 1);
      }
      wg_wait<0>();
      release(g - 1);
      pin(acc);
      store_acc16<T, kDwBN>(out, F, acc, m0 + 64 * c, H, n0, F);
    }
  }
  __syncwarp();
  cluster_sync();  // no block exits while the other may still signal it
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32(float v) { return v; }
template <> __device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <> __device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// FMA kernel (fp32, and bf16/fp16 off the wgmma kernel's layouts): a 64 x 64
// tile of one expert's dW on the fp32 FMA pipes, 16 x 16 threads of 4 x 4;
// steps of 32 rows of one row block (rows past the block's end as zeros).
// Each block's product is summed on its own and then added to the total, in
// ascending block order, as the plain version adds whole blocks: one fp32
// sum over all of an expert's rows (~1,150 at Mixtral's training shape)
// drifts further from it.
template <typename T>
__global__ void __launch_bounds__(256)
gmm_dw_fma_kernel(const T* __restrict__ x, const T* __restrict__ dy, const int* __restrict__ be,
                  const int* __restrict__ n_used, T* __restrict__ dw, int P, int H, int F, int E,
                  int block_rows) {
  constexpr int BM = 64, BN = 64, TM = 4, SR = 32;
  __shared__ __align__(16) float sx[SR][BM];  // [row][h]
  __shared__ __align__(16) float sd[SR][BN];  // [row][f]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const BlockSpan span = expert_span(be, n_used, P / block_rows, E, e);
  const int spb = (block_rows + SR - 1) / SR;
  const int steps = (span.hi - span.lo) * spb;
  float acc[TM][4], part[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int b = span.lo + s / spb;
    if (clamp_expert(__ldg(be + b), E) != e) continue;  // uniform across the block
    const int r0 = b * block_rows + (s % spb) * SR;
    const int r_end = min(r0 + SR, (b + 1) * block_rows);
#pragma unroll
    for (int j = 0; j < SR * BM / 256; ++j) {
      const int idx = tid + j * 256, k = idx / BM, m = idx % BM;
      const int r = r0 + k;
      sx[k][m] = (r < r_end && m0 + m < H) ? to_f32(x[(long long)r * H + m0 + m]) : 0.f;
      sd[k][m] = (r < r_end && n0 + m < F) ? to_f32(dy[(long long)r * F + n0 + m]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < SR; ++k) {
      const float4 d4 = *reinterpret_cast<const float4*>(&sd[k][tx * 4]);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xv = sx[k][ty * TM + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(xv, dv[j], part[i][j]);
      }
    }
    __syncthreads();
    if (s % spb == spb - 1) {  // the block's product is complete: add it
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }
  T* out = dw + (long long)e * H * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < F) out[(long long)m * F + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int S>
cudaError_t launch_dw_wgmma(const void* x, const void* dy, const int* be, const int* n_used,
                            void* dw, int P, int H, int F, int E, int block_rows, cudaStream_t st) {
  // x as (H, P) and dy as (F, P), boxes of 64 columns x S rows; columns
  // past H or F arrive as zeros
  CUtensorMap m[2];
  const cuuint64_t e = 2;
  const cuuint64_t xd[2] = {(cuuint64_t)H, (cuuint64_t)P}, xs[1] = {(cuuint64_t)H * e};
  const cuuint64_t dd[2] = {(cuuint64_t)F, (cuuint64_t)P}, ds[1] = {(cuuint64_t)F * e};
  const cuuint32_t box[2] = {64, S};
  cudaError_t err;
  if ((err = encode_map<T>(&m[0], x, 2, xd, xs, box, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = encode_map<T>(&m[1], dy, 2, dd, ds, box, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return err;
  auto kern = gmm_dw_wgmma_kernel<T, S>;
  static const cudaError_t attr = opt_in(kern, dw_smem<S>());
  if (attr != cudaSuccess) return attr;
  // a persistent grid: as many clusters as the card holds at once, or one
  // per tile when there are fewer
  static const int resident = max_clusters(kern, kDwThreads, dw_smem<S>(), 2);
  const long long tiles = (long long)E * ((H + 2 * kDwBM - 1) / (2 * kDwBM)) *
                          ((F + kDwBN - 1) / kDwBN);
  if (tiles > 0x3fffffffLL) return cudaErrorInvalidConfiguration;
  const int clusters = (int)min(tiles, (long long)resident);
  return launch_cluster(kern, dim3((unsigned)(2 * clusters)), kDwThreads, 0, 2, dw_smem<S>(), st,
                        m[0], m[1], be, n_used, static_cast<T*>(dw), P, H, F, E, block_rows);
}

template <typename T>
cudaError_t launch_dw_fma(const void* x, const void* dy, const int* be, const int* n_used,
                          void* dw, int P, int H, int F, int E, int block_rows, cudaStream_t st) {
  if ((F + 63) / 64 > 65535 || E > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((H + 63) / 64), (unsigned)((F + 63) / 64), (unsigned)E);
  gmm_dw_fma_kernel<T><<<grid, 256, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                            be, n_used, static_cast<T*>(dw), P, H, F, E,
                                            block_rows);
  return cudaGetLastError();
}

// the forward (TW false: out = x @ w[e]) and G' (TW true: out = x @ w[e]^T,
// w[e] read as stored, so "H" is K and "F" is N in the kernels' terms)
template <bool TW>
int gmm_launch(const void* x, const void* w, const int* be, const int* nu, void* out, void* part,
               int dtype, int P, int K, int N, int E, int block_rows, int big_tile,
               cudaStream_t st) {
  if (wgmma_layout(x, w, dtype, K, N, block_rows)) {
    if constexpr (TW)  // G': the cluster kernel, no K split
      return dtype == 1 ? (int)launch_dx_wgmma<__nv_bfloat16>(x, w, be, nu, out, P, K, N, E,
                                                              block_rows, st)
                        : (int)launch_dx_wgmma<__half>(x, w, be, nu, out, P, K, N, E,
                                                       block_rows, st);
    else
      return dtype == 1 ? (int)launch_wgmma<__nv_bfloat16>(x, w, be, nu, out, part, P, K, N, E,
                                                           block_rows, st)
                        : (int)launch_wgmma<__half>(x, w, be, nu, out, part, P, K, N, E,
                                                    block_rows, st);
  }
  switch (dtype * 2 + (big_tile ? 1 : 0)) {
    case 0: return (int)launch_fma<16, TW>(x, w, be, nu, out, P, K, N, E, block_rows, st);
    case 1: return (int)launch_fma<64, TW>(x, w, be, nu, out, P, K, N, E, block_rows, st);
    case 2: return (int)launch_mma<__nv_bfloat16, 16, 64, 1, 4, TW>(x, w, be, nu, out, P, K, N, E,
                                                                     block_rows, st);
    case 3: return (int)launch_mma<__nv_bfloat16, 128, 128, 2, 4, TW>(x, w, be, nu, out, P, K, N,
                                                                       E, block_rows, st);
    case 4: return (int)launch_mma<__half, 16, 64, 1, 4, TW>(x, w, be, nu, out, P, K, N, E,
                                                              block_rows, st);
    case 5: return (int)launch_mma<__half, 128, 128, 2, 4, TW>(x, w, be, nu, out, P, K, N, E,
                                                                block_rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// the K splits dstpu_grouped_matmul takes for this layout on this card (1: no
// partials, also off the wgmma kernel); above 1 the caller passes part, fp32
// [splits][P][F]
extern "C" int dstpu_grouped_matmul_splits(const void* x, const void* w, int dtype, int P, int H,
                                           int F, int E, int block_rows) {
  return P > 0 && wgmma_layout(x, w, dtype, H, F, block_rows) ? gmm_splits(P, H, F, E) : 1;
}

// the same for dstpu_grouped_matmul_dx (dy [P, F] and w [E, H, F]): 1, G'
// splits no K (asked as G is, so that one wrapper serves both)
extern "C" int dstpu_grouped_matmul_dx_splits(const void*, const void*, int, int, int, int, int,
                                              int) {
  return 1;
}

// out [P, F] = x [P, H] @ w[block_expert[r / block_rows]] for every row r;
// rows of blocks at or past *n_used (n_used null: none) are zeros.
// dtype: 0 fp32, 1 bf16, 2 fp16 (x, w and out); w [E, H, F]; block_expert
// [P / block_rows] int32; P a multiple of block_rows.  bf16/fp16 with
// block_rows a multiple of 128, H and F multiples of 8 and 16-byte aligned x
// and w take the wgmma kernel (part: null, or the fp32 scratch of
// dstpu_grouped_matmul_splits); otherwise big_tile 1 takes the 128-row
// tile (64 rows in fp32), 0 the 16-row one.  All tensors contiguous.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int dstpu_grouped_matmul(const void* x, const void* w, const void* block_expert,
                                    const void* n_used, void* out, void* part, int dtype, int P,
                                    int H, int F, int E, int block_rows, int big_tile,
                                    void* stream) {
  if (P < 0 || H <= 0 || F <= 0 || E <= 0 || block_rows <= 0 || P % block_rows != 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  return gmm_launch<false>(x, w, static_cast<const int*>(block_expert),
                           static_cast<const int*>(n_used), out, part, dtype, P, H, F, E,
                           block_rows, big_tile, static_cast<cudaStream_t>(stream));
}

// G': dx [P, H] = dy [P, F] @ w[block_expert[r / block_rows]]^T for every
// row r, reading w [E, H, F] as stored (no transposed copy); rows of blocks
// at or past *n_used are zeros and never computed.  The same layouts and
// arguments as dstpu_grouped_matmul, with K = F and N = H, and no K split
// (part unused): gmm_dx_wgmma_kernel on the wgmma layouts, G's mma.sync
// and FMA kernels on the others.
extern "C" int dstpu_grouped_matmul_dx(const void* dy, const void* w, const void* block_expert,
                                       const void* n_used, void* dx, void* part, int dtype, int P,
                                       int H, int F, int E, int block_rows, int big_tile,
                                       void* stream) {
  if (P < 0 || H <= 0 || F <= 0 || E <= 0 || block_rows <= 0 || P % block_rows != 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  return gmm_launch<true>(dy, w, static_cast<const int*>(block_expert),
                          static_cast<const int*>(n_used), dx, part, dtype, P, F, H, E,
                          block_rows, big_tile, static_cast<cudaStream_t>(stream));
}

// G'': dw [E, H, F], dw[e] = the sum over the row blocks b < *n_used with
// block_expert[b] == e, in ascending b, of x_b^T @ dy_b (x [P, H], dy [P,
// F]); fp32 sums written once in dw's type, zeros for an expert with no
// block.  bf16/fp16 with block_rows a multiple of 16, H and F multiples of 8
// and 16-byte aligned x and dy take the wgmma kernel, the rest the FMA one.
extern "C" int dstpu_grouped_matmul_dw(const void* x, const void* dy, const void* block_expert,
                                       const void* n_used, void* dw, int dtype, int P, int H,
                                       int F, int E, int block_rows, void* stream) {
  if (P < 0 || H <= 0 || F <= 0 || E <= 0 || block_rows <= 0 || P % block_rows != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)E * H * F * (dtype == 0 ? 4 : 2);
  if (P == 0) return (int)cudaMemsetAsync(dw, 0, bytes, st);
  const int* be = static_cast<const int*>(block_expert);
  const int* nu = static_cast<const int*>(n_used);
  const bool tc = dtype != 0 && block_rows % 16 == 0 && H % 8 == 0 && F % 8 == 0 &&
                  aligned16(x) && aligned16(dy);
  if (tc && block_rows % 64 == 0)
    return dtype == 1 ? (int)launch_dw_wgmma<__nv_bfloat16, 64>(x, dy, be, nu, dw, P, H, F, E,
                                                                block_rows, st)
                      : (int)launch_dw_wgmma<__half, 64>(x, dy, be, nu, dw, P, H, F, E,
                                                         block_rows, st);
  if (tc)
    return dtype == 1 ? (int)launch_dw_wgmma<__nv_bfloat16, 16>(x, dy, be, nu, dw, P, H, F, E,
                                                                block_rows, st)
                      : (int)launch_dw_wgmma<__half, 16>(x, dy, be, nu, dw, P, H, F, E,
                                                         block_rows, st);
  switch (dtype) {
    case 0: return (int)launch_dw_fma<float>(x, dy, be, nu, dw, P, H, F, E, block_rows, st);
    case 1: return (int)launch_dw_fma<__nv_bfloat16>(x, dy, be, nu, dw, P, H, F, E, block_rows, st);
    case 2: return (int)launch_dw_fma<__half>(x, dy, be, nu, dw, P, H, F, E, block_rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
