// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/pallas/flash_attention.py
// :_bwd_dq_kernel (kernel A', dQ) and :_bwd_dkv_kernel (kernel A'', dK and
// dV), the custom VJP of the training attention.  Both recompute the
// probabilities from q, k and the forward's log-sum-exp instead of storing
// them, so the backward never materialises [S, S]:
//   s[i, j]  = sm_scale * (q[i] . k[j]) - slope[h] * (i - j)        (ALiBi)
//   p[i, j]  = exp(s[i, j] - lse[i])   where visible, else 0
//              visible: i < Sq, j < Sk and (not causal or i >= j)
//   dp[i, j] = dO[i] . v[j]
//   ds[i, j] = p[i, j] * (dp[i, j] - delta[i]) * sm_scale,  delta = rowsum(O * dO)
//   dQ[i]    = sum_j ds[i, j] k[j]
//   dK[j]    = sum_{h in group} sum_i ds[i, j] q[i]
//   dV[j]    = sum_{h in group} sum_i p[i, j] dO[i]
// with query head h reading KV head h / (NH / KVH), exactly as the forward.
// delta is a [B, NH, Sq] fp32 input computed outside (as JAX computes it
// outside the Pallas calls).  D is a multiple of 16 to 128 or of 32 to 256
// (the wrapper pads other head dims with zero columns); past 128 each block
// computes one half of the gradients' columns (a grid axis over the halves)
// while S and dP still take the whole D, so the register budget stays that
// of D <= 128, and the ring is as deep as the tiles let a block hold.
//
// What bounds it on the H100: the arithmetic.  At llama-1b training shapes
// (B = 4, S = 1024, 32 heads over 8 KV heads, D = 64, causal) dQ needs 6 * D
// and dK/dV 8 * D flops per visible (query, key) pair (S and dP are
// recomputed in both, which keeps each kernel free of atomics): 26 + 35 us
// at 989 TFLOP/s, against ~50 MB of q/k/v/o/dO/dq/dk/dv/lse/delta traffic
// (15 us).  So the tensor cores set the least time, and only wgmma reaches
// their rate.
//
// bf16 and fp16 (training), both kernels: two warpgroups of 64 rows each
// per block and one block per SM, so a thread may hold 255 registers.
//   Copies.  Tiles arrive by TMA (cp.async.bulk.tensor) from tensor maps
//   over [B, S, H, D] with the tensors' own strides, so strided views need
//   no copy and rows past S arrive as zeros.  A map sees D as D/8 panels of
//   8 columns, a dimension of its own, so one copy lands a whole tile as
//   [D/8][rows][8].  Thread 0 keeps a ring of kStages = 5 stages kAhead = 3 tiles
//   ahead of the one computed, under mbarriers (full: the bytes landed;
//   empty: both warpgroups are done with the stage); the stage it refills
//   held the tile two before the current one.  A'' also brings each query
//   tile's lse and delta rows by bulk copies on the same barrier (when Sq is
//   a multiple of 4; else each thread loads its columns while the tile
//   lands).  Why no producer warp: ptxas sizes every thread of a block for
//   a whole number of warpgroups, so a 9th warp (or a producer warpgroup,
//   whose setmaxnreg did not lift the cap) limits all threads to 168
//   registers, and the D-wide dK/dV accumulators spilled.  Issuing from a
//   consumer costs it nothing once each tile is one copy: with a copy per
//   panel, and lse staged by a warp's loads, the same kernels ran 25-50 %
//   slower on the card.
//   Layout.  No swizzle: 8 rows of a panel are one 128-byte wgmma core
//   matrix.  The same tile serves as a K-major operand (S = Q K^T: core
//   matrices 128 bytes apart along the rows, a panel apart along D) and as
//   an MN-major one (dQ += dS K, dV += P^T dO, dK += dS^T Q: a panel apart
//   along D, 128 bytes apart along the rows), so nothing is stored twice or
//   transposed, and every D that is a multiple of 8 needs no padding.
//   Products.  S and dP are wgmma with both operands in shared memory; P
//   and dS are packed from the fp32 accumulators into bf16/fp16 A fragments
//   in registers, the A operand of the second pair; fp16 adds each one's
//   second term (hopper.cuh pack_a_lo) and a second product into the same
//   accumulators, so ~22 bits of P and dS reach the sums, as in the TPU
//   kernels' fp32 P and dS.  bf16 keeps one term, except in A'' past a
//   query-to-KV group of 4 (the kTwoTerms instantiation, type code 3): there
//   dK and dV sum G x Sq rounded products per key, and one bf16 term missed
//   FLASH_BWD_TOL at falcon-7b's 71:1 (dK/dV needed 0.026 / 0.032 against
//   0.022), so P and dS enter as bf16 hi and lo (~16 bits each) at twice the
//   tensor-core work of the two products.  Each warpgroup issues
//   S, then dP, and forms P while dP is on the tensor cores; A'' issues
//   dV += P^T dO before it forms dS^T, so that product runs under the dS^T
//   arithmetic.  (Letting the last products of a tile finish under the next
//   tile's S, releasing its stage a tile later, was slower on the card.)
//   p = exp2(s * scale * log2(e) - lse * log2(e)).  The causal/ragged mask
//   and the ALiBi term are compiled into separate versions of the
//   per-element code, and the masked one runs only on tiles that cross the
//   diagonal or the ragged edge; tiles wholly masked for a warpgroup are
//   skipped.  sm_scale multiplies dS once, in the epilogue (dQ, dK).
//
// A'' (dK/dV): one block per (b, KV head, 128-key tile); each warpgroup holds
// 64 keys' dK and dV in fp32 registers across every query head of the group
// and every query tile (64 queries per step; 32 for D > 96, which keeps
// S^T, dP^T and the D-wide dK/dV accumulators in registers).  K and V are
// loaded once; Q, dO, lse and delta stream.  Under causal attention key
// tile 0 walks every query tile and the last one walks 2 (an 8x spread at
// S = 1024): the grid is ordered heaviest tiles first (block x -> key tile
// x / (B * KVH)), so the light tiles fill the SMs at the end.
//
// A' (dQ): one block per (b * NH + h, 128-query tile), each warpgroup 64
// rows.  Q and dO are loaded once; K and V stream in 64-key tiles.  Causal
// blocks are ordered heaviest (last query tile) first.
//
// What the card gave (H100 80GB HBM3, 700 W; chip_smoke.py phase 6, numbers
// in PERF.md section 6 rows 2-3): at the llama-1b training shape about 4x
// the ops bound per kernel, 2.6x faster than the mma.sync kernels this
// replaces and within ~10 % of SDPA's backward; at D = 128 the 32-query
// step of A'' leaves it ~1.7x SDPA's.
//
// No atomics: every output element is written once by the block that owns
// it, after sums taken in a fixed order, so gradients are bit-equal across
// calls.
//
// Head dims past 256, every type: the runtime-head-dim kernels
// (csrc/wide_head.cuh) on the FMA pipes, fp32 throughout, the gradients'
// columns in parts of 128 over a grid axis and S and dP over the whole head
// in 32-column chunks.  No public model has such a head; right, not fast.
//
// fp32 (tests and small references): the FMA pipes, fp32 throughout.
// dQ: one block of 256 threads per (b * NH + h, 64-row query tile),
// as the forward.  Q, dO, lse and delta of the tile are staged once in
// shared memory; the block walks the 64-key tiles up to the causal diagonal
// (tiles wholly above it are skipped), staging K and V, and each thread
// computes a 4 x 4 patch of s and dp (rows ty*4.., columns tx + 16 j), turns
// it into ds in shared memory, and accumulates its 4 rows x D/16 columns of
// dQ in registers.  One store per element at the end.  dK/dV: one block per
// (b * KVH + kv head, 64-key tile) loops over the query heads of its group
// and their query tiles itself, keeping its keys' dK and dV in registers
// across the whole group.  Shared-memory rows are padded to D + 1 floats so
// that the lanes' column reads fall in distinct banks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "wide_head.cuh"

namespace {

constexpr int kB = 64;         // fp32 kernels: query-tile and key-tile size
constexpr int kThreads = 256;  // fp32 kernels: 16 x 16 threads, 4 x 4 patch each
// rows [r0, r0 + kB) of one head of a [B, S, H, D] fp32 tensor into smem
// [kB][D + 1]; rows at or past S become zeros
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long row_stride,
                                           int r0, int S) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r;
    dst[r * DP + d] = row < S ? src[(long long)row * row_stride + d] : 0.f;
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *slopes;
  void *dq, *dk, *dv;
  int B, NH, KVH, Sq, Sk, causal;
  float sm_scale;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int lse_bulk;   // bf16/fp16 dK/dV: lse and delta rows ride bulk copies (Sq % 4 == 0)
};

// fp32 past D = 128: four [kB][D + 1] tiles would not fit a block, so the
// operands that only the score loop reads (Q and dO in A', K and V in A'')
// are read there from global memory (L1) instead of being staged
template <int D>
__host__ __device__ constexpr int staged_tiles() {
  return D > 128 ? 2 : 4;
}
template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO (D <= 128), K, V tiles + dS
  return sizeof(float) * (staged_tiles<D>() * kB * (D + 1) + kB * (kB + 1));
}
template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V (D <= 128), Q, dO tiles + P^T, dS^T
  return sizeof(float) * (staged_tiles<D>() * kB * (D + 1) + 2 * kB * (kB + 1));
}
// row r of a [B, S, H, D] fp32 head, or null past S
__device__ __forceinline__ const float* row_or_null(const float* base, long long stride, int r,
                                                    int S) {
  return r < S ? base + (long long)r * stride : nullptr;
}

// ---------------------------------------------------------------------------
// kernel A': dQ (fp32, FMA pipes)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int NC = D / 16;
  constexpr bool GQ = D > 128;  // Q and dO read from global memory
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kB][DP] (D <= 128)
  float* dOs = Qs + (GQ ? 0 : kB * DP);  // [kB][DP] (D <= 128)
  float* Ks = dOs + (GQ ? 0 : kB * DP);  // [kB][DP]
  float* Vs = Ks + kB * DP;   // [kB][DP]
  float* dSs = Vs + kB * DP;  // [kB][PP]
  __shared__ float lse_s[kB], delta_s[kB];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / a.NH, h = bh % a.NH;
  const int kvh = h / (a.NH / a.KVH);
  const int q_start = blockIdx.x * kB;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;
  const float* ob = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
  const long long rowbase = ((long long)b * a.NH + h) * a.Sq;

  if constexpr (!GQ) {
    stage_rows<D>(Qs, qb, a.qss, q_start, a.Sq);
    stage_rows<D>(dOs, ob, a.dss, q_start, a.Sq);
  }
  const float* qg[4];
  const float* og[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    qg[r] = row_or_null(qb, a.qss, q_start + ty * 4 + r, a.Sq);
    og[r] = row_or_null(ob, a.dss, q_start + ty * 4 + r, a.Sq);
  }
  if (tid < kB) {
    const int qi = q_start + tid;
    lse_s[tid] = qi < a.Sq ? a.lse[rowbase + qi] : 0.f;
    delta_s[tid] = qi < a.Sq ? a.delta[rowbase + qi] : 0.f;
  }
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_start + kB);  // keys past the tile's last row
  const int n_tiles = (k_end + kB - 1) / kB;

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs
    stage_rows<D>(Ks, kb, a.kss, k0, a.Sk);
    stage_rows<D>(Vs, vb, a.vss, k0, a.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (GQ) {
          qv[r] = qg[r] != nullptr ? __ldg(qg[r] + d) : 0.f;
          ov[r] = og[r] != nullptr ? __ldg(og[r] + d) : 0.f;
        } else {
          qv[r] = Qs[(ty * 4 + r) * DP + d];
          ov[r] = dOs[(ty * 4 + r) * DP + d];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
          dp[r][j] = fmaf(ov[r], vv[j], dp[r][j]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = ty * 4 + r;
      const int row = q_start + lr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[r][j] * a.sm_scale;
        if (a.slopes != nullptr) x -= slope * (float)(row - col);
        const bool vis = row < a.Sq && col < a.Sk && (!a.causal || row >= col);
        const float p = vis ? expf(x - lse_s[lr]) : 0.f;
        dSs[lr * PP + tx + 16 * j] = p * (dp[r][j] - delta_s[lr]) * a.sm_scale;
      }
    }
    __syncwarp();  // a row group's dS rows are written and read by its own half-warp

#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float dsv[4], kv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = dSs[(ty * 4 + r) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsv[r], kv[c], acc[r][c]);
    }
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_start + ty * 4 + r;
    if (qi >= a.Sq) continue;
    float* row = dq + (((long long)b * a.Sq + qi) * a.NH + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = acc[r][c];
  }
}

// ---------------------------------------------------------------------------
// kernel A'': dK and dV (fp32, FMA pipes)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int NC = D / 16;
  constexpr bool GK = D > 128;  // K and V read from global memory
  extern __shared__ float smem[];
  float* Ks = smem;                    // [kB][DP] (D <= 128)
  float* Vs = Ks + (GK ? 0 : kB * DP);  // [kB][DP] (D <= 128)
  float* Qs = Vs + (GK ? 0 : kB * DP);  // [kB][DP]
  float* dOs = Qs + kB * DP;  // [kB][DP]
  float* Pt = dOs + kB * DP;  // [kB keys][PP]
  float* dSt = Pt + kB * PP;  // [kB keys][PP]
  __shared__ float lse_s[kB], delta_s[kB];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bk = blockIdx.y;
  const int b = bk / a.KVH, kvh = bk % a.KVH;
  const int group = a.NH / a.KVH;
  const int k_start = blockIdx.x * kB;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;

  if constexpr (!GK) {
    stage_rows<D>(Ks, kb, a.kss, k_start, a.Sk);
    stage_rows<D>(Vs, vb, a.vss, k_start, a.Sk);
  }
  const float* kg[4];
  const float* vg[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    kg[r] = row_or_null(kb, a.kss, k_start + ty * 4 + r, a.Sk);
    vg[r] = row_or_null(vb, a.vss, k_start + ty * 4 + r, a.Sk);
  }

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  // query tiles wholly before this key tile see none of it when causal
  const int first = a.causal ? k_start / kB : 0;
  const int n_q_tiles = (a.Sq + kB - 1) / kB;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
    const float* ob = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
    const long long rowbase = ((long long)b * a.NH + h) * a.Sq;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
    for (int it = first; it < n_q_tiles; ++it) {
      const int q0 = it * kB;
      __syncthreads();  // the previous tile's readers are done with Qs/dOs/Pt/dSt
      stage_rows<D>(Qs, qb, a.qss, q0, a.Sq);
      stage_rows<D>(dOs, ob, a.dss, q0, a.Sq);
      if (tid < kB) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < a.Sq ? a.lse[rowbase + qi] : 0.f;
        delta_s[tid] = qi < a.Sq ? a.delta[rowbase + qi] : 0.f;
      }
      __syncthreads();

      // s^T and dp^T: keys ty*4 + r against queries tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (GK) {
            kv[r] = kg[r] != nullptr ? __ldg(kg[r] + d) : 0.f;
            vv[r] = vg[r] != nullptr ? __ldg(vg[r] + d) : 0.f;
          } else {
            kv[r] = Ks[(ty * 4 + r) * DP + d];
            vv[r] = Vs[(ty * 4 + r) * DP + d];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          ov[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[r][j] = fmaf(qv[j], kv[r], s[r][j]);
            dp[r][j] = fmaf(ov[j], vv[r], dp[r][j]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lk = ty * 4 + r;
        const int key = k_start + lk;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lq = tx + 16 * j;
          const int row = q0 + lq;
          float x = s[r][j] * a.sm_scale;
          if (a.slopes != nullptr) x -= slope * (float)(row - key);
          const bool vis = row < a.Sq && key < a.Sk && (!a.causal || row >= key);
          const float p = vis ? expf(x - lse_s[lq]) : 0.f;
          Pt[lk * PP + lq] = p;
          dSt[lk * PP + lq] = p * (dp[r][j] - delta_s[lq]) * a.sm_scale;
        }
      }
      __syncwarp();  // a key group's P^T / dS^T rows are its own half-warp's

#pragma unroll 4
      for (int qq = 0; qq < kB; ++qq) {
        float pv[4], dsv[4], ov[NC], qv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = Pt[(ty * 4 + r) * PP + qq];
          dsv[r] = dSt[(ty * 4 + r) * PP + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = dOs[qq * DP + tx + 16 * c];
          qv[c] = Qs[qq * DP + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[r][c] = fmaf(pv[r], ov[c], dv[r][c]);
            dk[r][c] = fmaf(dsv[r], qv[c], dk[r][c]);
          }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k_start + ty * 4 + r;
    if (key >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + key) * a.KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkp[off + tx + 16 * c] = dk[r][c];
      dvp[off + tx + 16 * c] = dv[r][c];
    }
  }
}


// ---------------------------------------------------------------------------
// Hopper kernels (bf16, fp16): wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int kThreadsWg = 256;     // two consumer warpgroups, 64 rows each
constexpr size_t kSmemCap = 232448 - 1024;

// the ring of streamed tiles: up to 5 stages (5 for every D <= 128), and
// tiles in flight ahead of the one computed such that the stage refilled
// held the tile two before the current one (the previous one for rings of
// fewer than 4 stages: past D = 128 Q/dO or K/V fill most of the block)
__host__ __device__ constexpr int ring_stages(size_t fixed, size_t stage) {
  return (int)((kSmemCap - fixed) / stage) < 5 ? (int)((kSmemCap - fixed) / stage) : 5;
}
__host__ __device__ constexpr int ring_ahead(int stages) { return stages >= 4 ? stages - 2 : stages - 1; }

// past D = 128 each block computes one half of the gradients' columns (a
// grid axis over the halves); S and dP still take the whole D
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D > 128 ? D / 2 : D;
}

// P^T of one 64-key x BQ-query tile of A'', in place of S^T.  Rows are keys
// key0 and key0 + 8, columns queries q0 + 8 j + cq (+ 1).
template <bool ALIBI, bool EDGE, int BQ>
__device__ __forceinline__ void dkv_probs(float (&s)[BQ / 2], const float (&lse2)[BQ / 4],
                                          int q0, int key0, int cq, const Args& a,
                                          float scale2, float slope2) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int lq = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const int qi = q0 + lq + (e & 1);
      const int key = key0 + 8 * (e >> 1);
      float x = fmaf(s[i], scale2, -lse2[2 * j + (e & 1)]);
      if (ALIBI) x -= slope2 * (float)(qi - key);
      float p = ex2(x);
      if (EDGE && !(qi < a.Sq && key < a.Sk && (!a.causal || qi >= key))) p = 0.f;
      s[i] = p;
    }
  }
}

// dS^T (unscaled) = P^T (dP^T - delta), in place of dP^T
template <int BQ>
__device__ __forceinline__ void dkv_dscores(float (&dp)[BQ / 2], const float (&p)[BQ / 2],
                                            const float (&dl)[BQ / 4]) {
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) dp[i] = p[i] * (dp[i] - dl[2 * (i >> 2) + (i & 1)]);
}

// P of one 64-query x 64-key tile of A', in place of S.  Rows are queries
// row0 and row0 + 8, columns keys k0 + 8 j + cq (+ 1).
template <bool ALIBI, bool EDGE>
__device__ __forceinline__ void dq_probs(float (&s)[32], const float* lse2, int row0, int k0,
                                         int cq, const Args& a, float scale2, float slope2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const int qi = row0 + 8 * (e >> 1);
      const int key = k0 + 8 * j + cq + (e & 1);
      float x = fmaf(s[i], scale2, -lse2[e >> 1]);
      if (ALIBI) x -= slope2 * (float)(qi - key);
      float p = ex2(x);
      if (EDGE && !(key < a.Sk && (!a.causal || qi >= key))) p = 0.f;
      s[i] = p;
    }
  }
}

template <int D>
struct DkvCfg {
  static constexpr int BK = 128;                // keys per block, 64 per consumer
  static constexpr int BQ = D <= 96 ? 64 : 32;  // queries per pipeline step
  static constexpr int K_BYTES = BK * D * 2;    // one of K, V
  static constexpr int Q_BYTES = BQ * D * 2;    // one of Q, dO (per stage)
  static constexpr int STAGES = ring_stages(2 * K_BYTES, 2 * Q_BYTES + 2 * BQ * 4);
  static constexpr int AHEAD = ring_ahead(STAGES);
  static constexpr size_t smem =
      128 + 2 * K_BYTES + STAGES * (2 * Q_BYTES + 2 * BQ * 4) + (1 + 2 * STAGES) * 8;
};

template <typename T, int D, bool kTwoTerms>
__global__ void __launch_bounds__(kThreadsWg, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo, const Args a) {
  using C = DkvCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, kStages = C::STAGES, kAhead = C::AHEAD;
  constexpr int DO = out_cols<D>();  // the gradient columns of this block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  T* Ks = reinterpret_cast<T*>(base);  // [D/8][BK][8]
  T* Vs = Ks + BK * D;                 // [D/8][BK][8]
  T* Qs = Vs + BK * D;                 // [kStages][D/8][BQ][8]
  T* dOs = Qs + kStages * BQ * D;      // [kStages][D/8][BQ][8]
  float* lse_s = reinterpret_cast<float*>(dOs + kStages * BQ * D);  // [kStages][BQ]
  float* dl_s = lse_s + kStages * BQ;                               // [kStages][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + kStages * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int BH = a.B * a.KVH;
  const int kb = blockIdx.x / BH;  // heaviest key tiles (most query tiles) first
  const int b = (blockIdx.x % BH) / a.KVH, kvh = (blockIdx.x % BH) % a.KVH;
  const int group = a.NH / a.KVH;
  const int k0 = kb * BK;
  // query tiles wholly before this key tile see none of it when causal
  const int first = a.causal ? k0 / BQ : 0;
  const int per_head = max((a.Sq + BQ - 1) / BQ - first, 0);
  const int total = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreadsWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a ragged last tile's bulk copies stop at Sq: the rest of its lse and
  // delta rows keeps earlier (finite) values, masked out with p = 0
  for (int i = threadIdx.x; i < 2 * kStages * BQ; i += kThreadsWg) lse_s[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the copies land
  __syncthreads();

  // warpgroup c holds keys [kw, kw + 64)
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x - 128 * c;
  const int lane = tid & 31;
  // thread 0 keeps the ring kAhead tiles ahead: for tile t it waits until
  // both warpgroups are done with the stage's previous tile (t - kStages)
  // and issues the copies of Q and dO, and of the rows' lse and delta
  const bool issuer = threadIdx.x == 0;
  const bool bulk = a.lse_bulk != 0;
  auto issue = [&](int t) {
    const int st = t % kStages;
    if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
    const int h = kvh * group + t / per_head;
    const int q0 = (first + t % per_head) * BQ;
    const uint32_t nb = bulk ? 4u * min(BQ, a.Sq - q0) : 0u;
    mbar_arrive_tx(&full[st], 2 * C::Q_BYTES + 2 * nb);
    tma_tile(Qs + st * BQ * D, &tq, q0, h, b, &full[st]);
    tma_tile(dOs + st * BQ * D, &tdo, q0, h, b, &full[st]);
    if (bulk) {
      const long long row = ((long long)b * a.NH + h) * a.Sq + q0;
      bulk_copy(lse_s + st * BQ, a.lse + row, nb, &full[st]);
      bulk_copy(dl_s + st * BQ, a.delta + row, nb, &full[st]);
    }
  };
  if (issuer) {
    mbar_arrive_tx(kv_full, 2 * C::K_BYTES);
    tma_tile(Ks, &tk, k0, kvh, b, kv_full);
    tma_tile(Vs, &tv, k0, kvh, b, kv_full);
    for (int t = 0; t < min(total, kAhead); ++t) issue(t);
  }
  const int kw = k0 + 64 * c;
  const int key0 = kw + 16 * (tid >> 5) + (lane >> 2);  // this lane's keys: key0, key0 + 8
  const int cq = (lane & 3) * 2;                        // and its column pair
  const float scale2 = a.sm_scale * kLog2e;
  const T* Kw = Ks + 64 * c * 8;
  const T* Vw = Vs + 64 * c * 8;

  // this block's columns [col0, col0 + DO) of dK and dV, as panel offsets
  const int col0 = DO < D ? (int)blockIdx.y * DO : 0;
  const int pan0 = col0 / 8 * BQ * 8;
  float dk[DO / 2], dv[DO / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
  // P^T and dS^T as A operands; fp16, and bf16 past a group of 4
  // (kTwoTerms), add their second terms pl, dsl
  constexpr bool SPLIT = kSplitA<T> || kTwoTerms;
  uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
  uint32_t pl[SPLIT ? BQ / 16 : 1][4], dsl[SPLIT ? BQ / 16 : 1][4];
  mbar_wait(kv_full, 0);

  for (int it = 0; it < total; ++it) {
    if (issuer && it + kAhead < total) issue(it + kAhead);
    const int stage = it % kStages;
    const int h = kvh * group + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    // a tile wholly before this warpgroup's first key is masked out whole
    const bool active = kw < a.Sk && !(a.causal && q0 + BQ - 1 < kw);
    // this thread's columns' lse * log2(e) and delta: from the stage's bulk
    // copies, or (Sq off a multiple of 4) loaded here while the tile lands
    float lse2[BQ / 4], dl[BQ / 4];
    if (active && !bulk) {
      const long long rowbase = ((long long)b * a.NH + h) * a.Sq;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * j + cq + e;
          lse2[2 * j + e] = qi < a.Sq ? __ldg(a.lse + rowbase + qi) * kLog2e : 0.f;
          dl[2 * j + e] = qi < a.Sq ? __ldg(a.delta + rowbase + qi) : 0.f;
        }
    }
    mbar_wait(&full[stage], (it / kStages) & 1);
    if (active && bulk) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + stage * BQ + 8 * j + cq);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + stage * BQ + 8 * j + cq);
        lse2[2 * j] = l2.x * kLog2e;
        lse2[2 * j + 1] = l2.y * kLog2e;
        dl[2 * j] = d2.x;
        dl[2 * j + 1] = d2.y;
      }
    }
    const T* Qc = Qs + stage * BQ * D;
    const T* dOc = dOs + stage * BQ * D;
    if (active) {
      // S^T = K Q^T, then dP^T = V dO^T (64 keys x BQ queries): P is
      // formed while dP^T is still on the tensor cores
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<T, BQ>::run(s, gmma_desc(Kw + kk * 2 * BK * 8, BK * 16, 128),
                            gmma_desc(Qc + kk * 2 * BQ * 8, BQ * 16, 128), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<T, BQ>::run(dp, gmma_desc(Vw + kk * 2 * BK * 8, BK * 16, 128),
                            gmma_desc(dOc + kk * 2 * BQ * 8, BQ * 16, 128), kk > 0);
      wg_commit();
    }
    if (active) {
      wg_wait<1>();
      pin(s);
      const bool edge = (a.causal && q0 < kw + 63) || q0 + BQ > a.Sq || kw + 64 > a.Sk;
      if (a.slopes != nullptr) {
        const float slope2 = a.slopes[h] * kLog2e;
        if (edge)
          dkv_probs<true, true, BQ>(s, lse2, q0, key0, cq, a, scale2, slope2);
        else
          dkv_probs<true, false, BQ>(s, lse2, q0, key0, cq, a, scale2, slope2);
      } else if (edge) {
        dkv_probs<false, true, BQ>(s, lse2, q0, key0, cq, a, scale2, 0.f);
      } else {
        dkv_probs<false, false, BQ>(s, lse2, q0, key0, cq, a, scale2, 0.f);
      }
      pack_a<T, BQ>(pf, s);
      if constexpr (SPLIT) pack_a_lo<T, BQ>(pl, s);
      wg_wait<0>();
      pin(dp);
      // dV += P^T dO (dO read MN-major) runs while dS^T is formed
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq)
        WgmmaRS<T, DO>::run(dv, pf[kq], gmma_desc(dOc + pan0 + kq * 16 * 8, 128, BQ * 16));
      if constexpr (SPLIT) {
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq)
          WgmmaRS<T, DO>::run(dv, pl[kq], gmma_desc(dOc + pan0 + kq * 16 * 8, 128, BQ * 16));
      }
      wg_commit();
      dkv_dscores<BQ>(dp, s, dl);
      pack_a<T, BQ>(dsf, dp);
      if constexpr (SPLIT) pack_a_lo<T, BQ>(dsl, dp);
      // dK += dS^T Q, Q read MN-major
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq)
        WgmmaRS<T, DO>::run(dk, dsf[kq], gmma_desc(Qc + pan0 + kq * 16 * 8, 128, BQ * 16));
      if constexpr (SPLIT) {
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq)
          WgmmaRS<T, DO>::run(dk, dsl[kq], gmma_desc(Qc + pan0 + kq * 16 * 8, 128, BQ * 16));
      }
      wg_commit();
      wg_wait<0>();
      pin(dv);
      pin(dk);
      pin(pf);
      pin(dsf);
      if constexpr (SPLIT) {
        pin(pl);
        pin(dsl);
      }
    }
    mbar_arrive(&empty[stage]);
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + key) * a.KVH + kvh) * D + col0;
#pragma unroll
    for (int j = 0; j < DO / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkp + off + 8 * j + cq) =
          Cvt<T>::pack(dk[4 * j + 2 * r] * a.sm_scale, dk[4 * j + 2 * r + 1] * a.sm_scale);
      *reinterpret_cast<uint32_t*>(dvp + off + 8 * j + cq) =
          Cvt<T>::pack(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
struct DqCfg {
  static constexpr int BQ = 128;              // queries per block, 64 per consumer
  static constexpr int BK = 64;               // keys per pipeline step
  static constexpr int Q_BYTES = BQ * D * 2;  // one of Q, dO
  static constexpr int K_BYTES = BK * D * 2;  // one of K, V (per stage)
  static constexpr int STAGES = ring_stages(2 * Q_BYTES, 2 * K_BYTES);
  static constexpr int AHEAD = ring_ahead(STAGES);
  static constexpr size_t smem = 128 + 2 * Q_BYTES + STAGES * 2 * K_BYTES + (1 + 2 * STAGES) * 8;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsWg, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo, const Args a) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, kStages = C::STAGES, kAhead = C::AHEAD;
  constexpr int DO = out_cols<D>();  // the dQ columns of this block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  T* Qs = reinterpret_cast<T*>(base);  // [D/8][BQ][8]
  T* dOs = Qs + BQ * D;                // [D/8][BQ][8]
  T* Ks = dOs + BQ * D;                // [kStages][D/8][BK][8]
  T* Vs = Ks + kStages * BK * D;       // [kStages][D/8][BK][8]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * BK * D);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int BH = a.B * a.NH;
  const int n_qb = (a.Sq + BQ - 1) / BQ;
  // heaviest query tiles (the most keys under causal attention) first
  const int qb = a.causal ? n_qb - 1 - (int)(blockIdx.x / BH) : (int)(blockIdx.x / BH);
  const int b = (blockIdx.x % BH) / a.NH, h = (blockIdx.x % BH) % a.NH;
  const int kvh = h / (a.NH / a.KVH);
  const int q0 = qb * BQ;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q0 + BQ);  // keys past the tile's last row
  const int n_kt = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreadsWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 keeps the ring kAhead key tiles ahead: for tile t it waits
  // until both warpgroups are done with the stage's previous tile
  const bool issuer = threadIdx.x == 0;
  auto issue = [&](int t) {
    const int st = t % kStages;
    if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
    mbar_arrive_tx(&full[st], 2 * C::K_BYTES);
    tma_tile(Ks + st * BK * D, &tk, t * BK, kvh, b, &full[st]);
    tma_tile(Vs + st * BK * D, &tv, t * BK, kvh, b, &full[st]);
  };
  if (issuer) {
    mbar_arrive_tx(q_full, 2 * C::Q_BYTES);
    tma_tile(Qs, &tq, q0, h, b, q_full);
    tma_tile(dOs, &tdo, q0, h, b, q_full);
    for (int t = 0; t < min(n_kt, kAhead); ++t) issue(t);
  }

  // warpgroup c holds queries [qw, qw + 64)
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x - 128 * c;
  const int lane = tid & 31;
  const int qw = q0 + 64 * c;
  const int row0 = qw + 16 * (tid >> 5) + (lane >> 2);  // this lane's rows: row0, row0 + 8
  const int cq = (lane & 3) * 2;
  const float scale2 = a.sm_scale * kLog2e;
  const long long rowbase = ((long long)b * a.NH + h) * a.Sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    lse2[r] = qi < a.Sq ? a.lse[rowbase + qi] * kLog2e : 0.f;
    dl[r] = qi < a.Sq ? a.delta[rowbase + qi] : 0.f;
  }
  const float slope2 = a.slopes != nullptr ? a.slopes[h] * kLog2e : 0.f;
  const T* Qw = Qs + 64 * c * 8;
  const T* dOw = dOs + 64 * c * 8;

  // this block's columns [col0, col0 + DO) of dQ, as a panel offset of K
  const int col0 = DO < D ? (int)blockIdx.y * DO : 0;
  const int pan0 = col0 / 8 * BK * 8;
  float dq[DO / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  // dS as the A operand; fp16 adds its second term dsl
  constexpr bool SPLIT = kSplitA<T>;
  uint32_t dsf[4][4], dsl[SPLIT ? 4 : 1][4];
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_kt; ++t) {
    if (issuer && t + kAhead < n_kt) issue(t + kAhead);
    const int stage = t % kStages;
    const int k0 = t * BK;
    mbar_wait(&full[stage], (t / kStages) & 1);
    // a key tile wholly past this warpgroup's last row is masked out whole
    const bool active = qw < a.Sq && !(a.causal && k0 > qw + 63);
    const T* Kc = Ks + stage * BK * D;
    const T* Vc = Vs + stage * BK * D;
    if (active) {
      // S = Q K^T, then dP = dO V^T (64 queries x 64 keys): P is formed
      // while dP is still on the tensor cores
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<T, 64>::run(s, gmma_desc(Qw + kk * 2 * BQ * 8, BQ * 16, 128),
                            gmma_desc(Kc + kk * 2 * BK * 8, BK * 16, 128), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<T, 64>::run(dp, gmma_desc(dOw + kk * 2 * BQ * 8, BQ * 16, 128),
                            gmma_desc(Vc + kk * 2 * BK * 8, BK * 16, 128), kk > 0);
      wg_commit();
    }
    if (active) {
      wg_wait<1>();
      pin(s);
      const bool edge = (a.causal && k0 + BK - 1 > qw) || k0 + BK > a.Sk;
      if (a.slopes != nullptr) {
        if (edge)
          dq_probs<true, true>(s, lse2, row0, k0, cq, a, scale2, slope2);
        else
          dq_probs<true, false>(s, lse2, row0, k0, cq, a, scale2, slope2);
      } else if (edge) {
        dq_probs<false, true>(s, lse2, row0, k0, cq, a, scale2, 0.f);
      } else {
        dq_probs<false, false>(s, lse2, row0, k0, cq, a, scale2, 0.f);
      }
      wg_wait<0>();
      pin(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
      pack_a<T, 64>(dsf, dp);
      if constexpr (SPLIT) pack_a_lo<64>(dsl, dp);
      // dQ += dS K, K read MN-major
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq)
        WgmmaRS<T, DO>::run(dq, dsf[kq], gmma_desc(Kc + pan0 + kq * 16 * 8, 128, BK * 16));
      if constexpr (SPLIT) {
#pragma unroll
        for (int kq = 0; kq < BK / 16; ++kq)
          WgmmaRS<T, DO>::run(dq, dsl[kq], gmma_desc(Kc + pan0 + kq * 16 * 8, 128, BK * 16));
      }
      wg_commit();
      wg_wait<0>();
      pin(dq);
      pin(dsf);
      if constexpr (SPLIT) pin(dsl);
    }
    mbar_arrive(&empty[stage]);
  }

  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= a.Sq) continue;
    T* row = dqp + (((long long)b * a.Sq + qi) * a.NH + h) * D + col0;
#pragma unroll
    for (int j = 0; j < DO / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + cq) =
          Cvt<T>::pack(dq[4 * j + 2 * r] * a.sm_scale, dq[4 * j + 2 * r + 1] * a.sm_scale);
  }
}

// ---------------------------------------------------------------------------
// runtime head dim (past 256), any of the three types: csrc/wide_head.cuh
// ---------------------------------------------------------------------------
// dQ: one block of 256 threads per (64-row query tile, b * NH + h, part of
// at most 128 columns of dQ).  For each key tile up to the causal diagonal,
// S = Q K^T and dP = dO V^T over the whole head in 32-column chunks, then
// dS = P (dP - delta) into shared memory and dQ += dS K for the part.
template <typename T>
__global__ void __launch_bounds__(kWideThreads) flash_bwd_dq_wide_kernel(const Args a, int D) {
  extern __shared__ float wsm[];
  float* As = wsm;                         // [64][kWideLd]
  float* Bs = As + kWideRows * kWideLd;    // [64][kWideLd]
  float* DS = Bs + kWideRows * kWideLd;    // [64][kWidePd]
  float* Ks = DS + kWideRows * kWidePd;    // [64][kWidePart]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int b = blockIdx.y / a.NH, h = blockIdx.y % a.NH;
  const int kvh = h / (a.NH / a.KVH);
  const int q_start = blockIdx.x * kWideRows;
  const int c0 = blockIdx.z * kWidePart;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dsb + h * a.dsh;
  const long long rowbase = ((long long)b * a.NH + h) * a.Sq;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  float lse[4], dl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_start + ty * 4 + r;
    lse[r] = qi < a.Sq ? a.lse[rowbase + qi] : 0.f;
    dl[r] = qi < a.Sq ? a.delta[rowbase + qi] : 0.f;
  }
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_start + kWideRows);
  const int n_tiles = (k_end + kWideRows - 1) / kWideRows;
  float dq[4][8] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kWideRows;
    float s[4][4] = {}, dp[4][4] = {};
    wide_dot(s, As, Bs, qb, a.qss, q_start, a.Sq, kb, a.kss, k0, a.Sk, D);
    wide_dot(dp, As, Bs, dob, a.dss, q_start, a.Sq, vb, a.vss, k0, a.Sk, D);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q_start + ty * 4 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float sv = s[r][j] * a.sm_scale;
        if (a.slopes != nullptr) sv -= slope * (float)(row - col);
        const bool vis = row < a.Sq && col < a.Sk && (!a.causal || row >= col);
        const float p = vis ? expf(sv - lse[r]) : 0.f;
        DS[(ty * 4 + r) * kWidePd + tx + 16 * j] = p * (dp[r][j] - dl[r]);
      }
    }
    wide_stage(Ks, kWidePart, kWidePart, kb, a.kss, k0, a.Sk, c0, D);
    __syncthreads();
    wide_pv(dq, DS, Ks);
  }
  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_start + ty * 4 + r;
    if (qi >= a.Sq) continue;
    T* row = dqp + (((long long)b * a.Sq + qi) * a.NH + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < D) wide_put(row + col, dq[r][c] * a.sm_scale);
    }
  }
}

// dK/dV: one block of 256 threads per (64-key tile, b * KVH + kv head, part
// of at most 128 columns); it walks every query head of the group and each
// of their query tiles at or below the causal diagonal, with the patch's
// rows keys and its columns queries: S^T = K Q^T and dP^T = V dO^T over the
// whole head, then P^T and dS^T into shared memory and dK += dS^T Q,
// dV += P^T dO for the part.
template <typename T>
__global__ void __launch_bounds__(kWideThreads) flash_bwd_dkv_wide_kernel(const Args a, int D) {
  extern __shared__ float wsm[];
  float* As = wsm;                         // [64][kWideLd]
  float* Bs = As + kWideRows * kWideLd;    // [64][kWideLd]
  float* PT = Bs + kWideRows * kWideLd;    // [64 keys][kWidePd]
  float* DST = PT + kWideRows * kWidePd;   // [64 keys][kWidePd]
  float* Qp = DST + kWideRows * kWidePd;   // [64 queries][kWidePart]
  float* dOp = Qp + kWideRows * kWidePart; // [64 queries][kWidePart]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;
  const int G = a.NH / a.KVH;
  const int k_start = blockIdx.x * kWideRows;
  const int c0 = blockIdx.z * kWidePart;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  float dk[4][8] = {}, dv[4][8] = {};
  // query tiles with a row at or past this key tile's first key (causal)
  const int qt0 = a.causal ? k_start / kWideRows : 0;
  const int n_qt = (a.Sq + kWideRows - 1) / kWideRows;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
    const T* dob = static_cast<const T*>(a.dout) + b * a.dsb + h * a.dsh;
    const long long rowbase = ((long long)b * a.NH + h) * a.Sq;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q_start = qt * kWideRows;
      float s[4][4] = {}, dp[4][4] = {};
      wide_dot(s, As, Bs, kb, a.kss, k_start, a.Sk, qb, a.qss, q_start, a.Sq, D);
      wide_dot(dp, As, Bs, vb, a.vss, k_start, a.Sk, dob, a.dss, q_start, a.Sq, D);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q_start + tx + 16 * j;
        const float lse = qi < a.Sq ? a.lse[rowbase + qi] : 0.f;
        const float dl = qi < a.Sq ? a.delta[rowbase + qi] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k_start + ty * 4 + r;
          float sv = s[r][j] * a.sm_scale;
          if (a.slopes != nullptr) sv -= slope * (float)(qi - key);
          const bool vis = qi < a.Sq && key < a.Sk && (!a.causal || qi >= key);
          const float p = vis ? expf(sv - lse) : 0.f;
          PT[(ty * 4 + r) * kWidePd + tx + 16 * j] = p;
          DST[(ty * 4 + r) * kWidePd + tx + 16 * j] = p * (dp[r][j] - dl);
        }
      }
      wide_stage(Qp, kWidePart, kWidePart, qb, a.qss, q_start, a.Sq, c0, D);
      wide_stage(dOp, kWidePart, kWidePart, dob, a.dss, q_start, a.Sq, c0, D);
      __syncthreads();
      wide_pv(dk, DST, Qp);
      wide_pv(dv, PT, dOp);
    }
  }
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k_start + ty * 4 + r;
    if (key >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + key) * a.KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < D) {
        wide_put(dkp + off + col, dk[r][c] * a.sm_scale);
        wide_put(dvp + off + col, dv[r][c]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_wide(bool dkv, int D, const Args& a, cudaStream_t stream) {
  const unsigned parts = (D + kWidePart - 1) / kWidePart;
  if (dkv) {
    constexpr size_t smem = sizeof(float) * (2 * kWideRows * kWideLd + 2 * kWideRows * kWidePd +
                                             2 * kWideRows * kWidePart);
    static const cudaError_t attr = opt_in(flash_bwd_dkv_wide_kernel<T>, smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((a.Sk + kWideRows - 1) / kWideRows, a.B * a.KVH, parts);
    flash_bwd_dkv_wide_kernel<T><<<grid, kWideThreads, smem, stream>>>(a, D);
  } else {
    constexpr size_t smem = wide_fwd_smem();  // As, Bs, dS, a K part
    static const cudaError_t attr = opt_in(flash_bwd_dq_wide_kernel<T>, smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((a.Sq + kWideRows - 1) / kWideRows, a.B * a.NH, parts);
    flash_bwd_dq_wide_kernel<T><<<grid, kWideThreads, smem, stream>>>(a, D);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// the four maps of q, k, v, dO: q and dO in boxes of rq rows, k and v of rk
template <typename T, int D>
cudaError_t make_maps(const Args& a, int rq, int rk, CUtensorMap* m) {
  cudaError_t e;
  if ((e = tile_map<T>(&m[0], a.q, D, D, a.Sq, a.NH, a.B, a.qsb, a.qss, a.qsh, rq)) != cudaSuccess ||
      (e = tile_map<T>(&m[1], a.k, D, D, a.Sk, a.KVH, a.B, a.ksb, a.kss, a.ksh, rk)) != cudaSuccess ||
      (e = tile_map<T>(&m[2], a.v, D, D, a.Sk, a.KVH, a.B, a.vsb, a.vss, a.vsh, rk)) != cudaSuccess ||
      (e = tile_map<T>(&m[3], a.dout, D, D, a.Sq, a.NH, a.B, a.dsb, a.dss, a.dsh, rq)) != cudaSuccess)
    return e;
  return cudaSuccess;
}

// fp32 on the FMA pipes, bf16/fp16 by wgmma
template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((a.Sq + kB - 1) / kB, a.B * a.NH);
    constexpr size_t smem = dq_smem_bytes<D>();
    static cudaError_t attr = opt_in(flash_bwd_dq_kernel<D>, smem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    using C = DqCfg<D>;
    CUtensorMap m[4];
    const cudaError_t e = make_maps<T, D>(a, C::BQ, C::BK, m);
    if (e != cudaSuccess) return e;
    static cudaError_t attr = opt_in(flash_bwd_dq_wgmma_kernel<T, D>, C::smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((unsigned)((a.Sq + C::BQ - 1) / C::BQ) * a.B * a.NH, D / out_cols<D>());
    flash_bwd_dq_wgmma_kernel<T, D><<<grid, kThreadsWg, C::smem, stream>>>(m[0], m[1], m[2],
                                                                           m[3], a);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool kTwoTerms>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((a.Sk + kB - 1) / kB, a.B * a.KVH);
    constexpr size_t smem = dkv_smem_bytes<D>();
    static cudaError_t attr = opt_in(flash_bwd_dkv_kernel<D>, smem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    using C = DkvCfg<D>;
    CUtensorMap m[4];
    const cudaError_t e = make_maps<T, D>(a, C::BQ, C::BK, m);
    if (e != cudaSuccess) return e;
    Args t = a;
    t.lse_bulk = a.Sq % 4 == 0 && reinterpret_cast<uintptr_t>(a.lse) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(a.delta) % 16 == 0;
    static cudaError_t attr = opt_in(flash_bwd_dkv_wgmma_kernel<T, D, kTwoTerms>, C::smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((unsigned)((a.Sk + C::BK - 1) / C::BK) * a.B * a.KVH, D / out_cols<D>());
    flash_bwd_dkv_wgmma_kernel<T, D, kTwoTerms>
        <<<grid, kThreadsWg, C::smem, stream>>>(m[0], m[1], m[2], m[3], t);
  }
  return cudaGetLastError();
}

template <typename T, bool kTwoTerms = false>
cudaError_t dispatch_d(bool dkv, int D, const Args& a, cudaStream_t st) {
  switch (D) {
#define DSTPU_BWD_CASE(d) \
  case d:                 \
    return dkv ? launch_dkv<T, d, kTwoTerms>(a, st) : launch_dq<T, d>(a, st);
    DSTPU_BWD_CASE(16)
    DSTPU_BWD_CASE(32)
    DSTPU_BWD_CASE(48)
    DSTPU_BWD_CASE(64)
    DSTPU_BWD_CASE(80)
    DSTPU_BWD_CASE(96)
    DSTPU_BWD_CASE(112)
    DSTPU_BWD_CASE(128)
    DSTPU_BWD_CASE(160)
    DSTPU_BWD_CASE(192)
    DSTPU_BWD_CASE(224)
    DSTPU_BWD_CASE(256)
#undef DSTPU_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(bool dkv, int dtype, int D, const Args& a, void* stream) {
  if (a.KVH <= 0 || a.NH % a.KVH != 0 || a.Sq <= 0 || a.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > 256) {  // the runtime-head-dim kernels, every type
    switch (dtype) {
      case 0: return (int)launch_wide<float>(dkv, D, a, st);
      case 1: return (int)launch_wide<__nv_bfloat16>(dkv, D, a, st);
      case 2: return (int)launch_wide<__half>(dkv, D, a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dtype) {
    case 0:
      return (int)dispatch_d<float>(dkv, D, a, st);
    case 1:
      return (int)dispatch_d<__nv_bfloat16>(dkv, D, a, st);
    case 2:
      return (int)dispatch_d<__half>(dkv, D, a, st);
    case 3:  // bf16, A'' with P and dS as two terms
      if (!dkv) return (int)cudaErrorInvalidValue;
      return (int)dispatch_d<__nv_bfloat16, true>(dkv, D, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16 (q, k, v, dO and the gradients); 3 =
// bf16 with A'' keeping P and dS as two bf16 terms (dK/dV only; the wrapper
// takes it past a query-to-KV group of 4, ops/flash_attention.dkv_two_terms).
// q and dO [B, Sq, NH, D], k and v [B, Sk, KVH, D], read through the given
// element strides (batch, sequence, head; the last dim contiguous; for
// bf16/fp16 each base and stride a multiple of 16 bytes).  lse and delta
// [B, NH, Sq] fp32 contiguous; slopes [NH] fp32 or null.  dq [B, Sq, NH, D]
// and dk, dv [B, Sk, KVH, D] contiguous, written whole.  D is a multiple of
// 16 to 128 or of 32 to 256, or any D past 256 (the runtime-head-dim
// kernels, rows read at D with any alignment).  Returns cudaGetLastError()
// after the launch.
#define DSTPU_BWD_PARAMS                                                                      \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,             \
      const void *delta, const void *slopes, int dtype, int B, int NH, int KVH, int Sq,       \
      int Sk, int D, int causal, float sm_scale, long long qsb, long long qss, long long qsh, \
      long long ksb, long long kss, long long ksh, long long vsb, long long vss,              \
      long long vsh, long long dsb, long long dss, long long dsh
#define DSTPU_BWD_ARGS(dq, dk, dv)                                                             \
  Args {                                                                                       \
    q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),          \
        static_cast<const float*>(slopes), dq, dk, dv, B, NH, KVH, Sq, Sk, causal, sm_scale,  \
        qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh                            \
  }

extern "C" int dstpu_flash_attention_bwd_dq(DSTPU_BWD_PARAMS, void* dq, void* stream) {
  return dispatch(false, dtype, D, DSTPU_BWD_ARGS(dq, nullptr, nullptr), stream);
}

extern "C" int dstpu_flash_attention_bwd_dkv(DSTPU_BWD_PARAMS, void* dk, void* dv,
                                             void* stream) {
  return dispatch(true, dtype, D, DSTPU_BWD_ARGS(nullptr, dk, dv), stream);
}
