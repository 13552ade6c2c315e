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
// outside the Pallas calls).  The TPU kernels cast every input to fp32;
// here fp32 inputs stay fp32 end to end, and bf16/fp16 inputs keep fp32
// sums but enter the tensor cores in their own type (below).
//
// What bounds it on the H100: the arithmetic.  At llama-1b training shapes
// (B = 4, S = 1024, 32 heads over 8 KV heads, D = 64, causal) the backward
// needs 10 * D flops per visible (query, key) pair, 43 GFLOP, against
// ~50 MB of q/k/v/o/dO/dq/dk/dv/lse/delta traffic: far above the ridge, so
// the tensor cores set the least time (43 us at 989 TFLOP/s).  Splitting it
// into a dQ kernel and a dK/dV kernel recomputes S and dP in both (14 * D
// flops per pair in all), which keeps each kernel free of atomics.
//
// Two designs per kernel, chosen by dtype:
//
// bf16 and fp16 (training): the four products of each kernel run on the
// tensor cores (mma.sync m16n8k16, fp32 accumulators), 4 warps of 16 rows
// each, with the forward kernel's fragment layouts.  S and dP stay fp32 in
// the accumulators; P and dS are rounded to the input type only as mma
// operands, taken straight from the accumulator registers; the second
// operand of dS K, P^T dO and dS^T Q comes from ldmatrix.trans on the
// row-major tile.  Tiles move by 16-byte cp.async, double-buffered: key
// tiles for dQ, query tiles (of every query head of the group in turn) for
// dK/dV.  lse and delta ride in registers (dQ: per row) or shared memory
// (dK/dV: per column).
//
// fp32 (tests and small references): the FMA pipes, fp32 throughout.
// dQ: one block of 256 threads per (b * NH + h, 64-row query tile),
// as the forward.  Q, dO, lse and delta of the tile are staged once in
// shared memory; the block walks the 64-key tiles up to the causal diagonal
// (tiles wholly above it are skipped), staging K and V, and each thread
// computes a 4 x 4 patch of s and dp (rows ty*4.., columns tx + 16 j), turns
// it into ds in shared memory, and accumulates its 4 rows x D/16 columns of
// dQ in registers.  One store per element at the end.
//
// dK/dV, both versions: the TPU kernel runs its grid over (KV head, key
// tile, query head of the group) in order and carries fp32 dK/dV scratch
// across the group axis.  Blocks on Hopper run in no order, so here one
// block per (b * KVH + kv head, 64-key tile) loops over the q_per_kv query
// heads of its group and over their query tiles itself (from the tile
// holding the diagonal on, when causal), keeping its keys' dK and dV in
// fp32 registers across the whole group: no atomics, no second pass, and
// one store in k's dtype at the end.  Rows past Sq and keys past Sk are
// masked here (JAX pads them).
//
// Shared-memory rows are padded (D + 1 floats on the FMA pipes, D + 8
// halves for the tensor cores) so that the lanes' column and fragment reads
// fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kB = 64;         // query-tile and key-tile size
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 patch each

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
};

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V tiles + dS
  return sizeof(float) * (4 * kB * (D + 1) + kB * (kB + 1));
}
template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO tiles + P^T, dS^T
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * (kB + 1));
}

// ---------------------------------------------------------------------------
// kernel A': dQ (fp32, FMA pipes)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;           // [kB][DP]
  float* dOs = Qs + kB * DP;  // [kB][DP]
  float* Ks = dOs + kB * DP;  // [kB][DP]
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

  stage_rows<D>(Qs, qb, a.qss, q_start, a.Sq);
  stage_rows<D>(dOs, ob, a.dss, q_start, a.Sq);
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
        qv[r] = Qs[(ty * 4 + r) * DP + d];
        ov[r] = dOs[(ty * 4 + r) * DP + d];
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
  extern __shared__ float smem[];
  float* Ks = smem;           // [kB][DP]
  float* Vs = Ks + kB * DP;   // [kB][DP]
  float* Qs = Vs + kB * DP;   // [kB][DP]
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

  stage_rows<D>(Ks, kb, a.kss, k_start, a.Sk);
  stage_rows<D>(Vs, vb, a.vss, k_start, a.Sk);

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
          kv[r] = Ks[(ty * 4 + r) * DP + d];
          vv[r] = Vs[(ty * 4 + r) * DP + d];
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
// tensor-core kernels (bf16, fp16)
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;

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
};

// 16-byte async copy; n = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// B fragment (16 rows x 8 columns) of a row-major [row][col] tile, transposed
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* row_addr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
// this lane's part of the A fragment (16 rows from r0 - lane/4, 16 columns)
// of a row-major tile: rows r0 and r0 + 8, columns c0, c0 + 1 and c0 + 8, c0 + 9
__device__ __forceinline__ void load_a(uint32_t* f, const uint16_t* tile, int RS, int r0, int c0) {
  const uint16_t* p = tile + r0 * RS + c0;
  f[0] = lds32(p);
  f[1] = lds32(p + 8 * RS);
  f[2] = lds32(p + 8);
  f[3] = lds32(p + 8 * RS + 8);
}

// rows [r0, r0 + nrows) of one head of a [B, S, H, D] tensor into a padded
// smem tile by 16-byte cp.async; rows at or past S are zero-filled
template <typename T, int D>
__device__ __forceinline__ void stage_async(T* dst, const T* src, long long row_stride, int r0,
                                            int nrows, int S) {
  constexpr int RS = D + 8, CPR = D / 8;
  for (int i = threadIdx.x; i < nrows * CPR; i += kMmaWarps * 32) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = r0 + r;
    cp_async16(dst + r * RS + c, src + (long long)min(row, S - 1) * row_stride + c,
               row < S ? 16 : 0);
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {  // Q, dO + 2 x (K, V)
  return sizeof(uint16_t) * 6 * kB * (D + 8);
}
// query rows per step of the dK/dV kernel: 32 at D = 128 to keep the fp32
// dK/dV accumulators and the S/dP tiles in registers
template <int D>
struct DkvTile {
  static constexpr int BQ = D == 128 ? 32 : 64;
};
template <int D>
constexpr size_t dkv_mma_smem_bytes() {  // K, V + 2 x (Q, dO)
  return sizeof(uint16_t) * (2 * kB + 4 * DkvTile<D>::BQ) * (D + 8);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32) flash_bwd_dq_mma_kernel(Args a) {
  constexpr int RS = D + 8, KT = D / 16, NT = kB / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kB][RS]
  T* dOs = Qs + kB * RS;                   // [kB][RS]
  T* Ks = dOs + kB * RS;                   // [2][kB][RS]
  T* Vs = Ks + 2 * kB * RS;                // [2][kB][RS]
  const uint16_t* Qh = reinterpret_cast<const uint16_t*>(Qs);
  const uint16_t* dOh = reinterpret_cast<const uint16_t*>(dOs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / a.NH, h = bh % a.NH;
  const int kvh = h / (a.NH / a.KVH);
  const int q_start = blockIdx.x * kB;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* ob = static_cast<const T*>(a.dout) + b * a.dsb + h * a.dsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  stage_async<T, D>(Qs, qb, a.qss, q_start, kB, a.Sq);
  stage_async<T, D>(dOs, ob, a.dss, q_start, kB, a.Sq);
  cp_async_commit();
  auto load_kv = [&](int buf, int k0) {
    stage_async<T, D>(Ks + buf * kB * RS, kb, a.kss, k0, kB, a.Sk);
    stage_async<T, D>(Vs + buf * kB * RS, vb, a.vss, k0, kB, a.Sk);
    cp_async_commit();
  };
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_start + kB);  // keys past the tile's last row
  const int n_tiles = (k_end + kB - 1) / kB;
  if (n_tiles > 0) {
    load_kv(0, 0);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2);  // this lane's rows: r0 and r0 + 8
  const int cq = (lane & 3) * 2;           // and its column pair
  const long long rowbase = ((long long)b * a.NH + h) * a.Sq;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q_start + r0 + 8 * i;
    lse_r[i] = row < a.Sq ? a.lse[rowbase + row] : 0.f;
    dl_r[i] = row < a.Sq ? a.delta[rowbase + row] : 0.f;
  }
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    const int k0 = t * kB;
    if (t + 1 < n_tiles) {
      load_kv(cur ^ 1, k0 + kB);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kc = Ks + cur * kB * RS;
    const T* Vc = Vs + cur * kB * RS;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t qa[4], oa[4];
      load_a(qa, Qh, RS, r0, kt * 16 + cq);
      load_a(oa, dOh, RS, r0, kt * 16 + cq);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* kr = Kc + (nt * 8 + (lane >> 2)) * RS + kt * 16 + cq;
        const T* vr = Vc + (nt * 8 + (lane >> 2)) * RS + kt * 16 + cq;
        const uint32_t bk[2] = {lds32(kr), lds32(kr + 8)};
        const uint32_t bv[2] = {lds32(vr), lds32(vr + 8)};
        Mma<T>::run(s[nt], qa, bk);
        Mma<T>::run(dp[nt], oa, bv);
      }
    }
    // dS = P (dP - delta) scale, P recomputed from lse; packed as A fragments
    uint32_t dsf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = q_start + r0 + 8 * i;
        const int col = k0 + nt * 8 + cq + (e & 1);
        float x = s[nt][e] * a.sm_scale;
        if (a.slopes != nullptr) x -= slope * (float)(row - col);
        const bool vis = row < a.Sq && col < a.Sk && (!a.causal || row >= col);
        const float p = vis ? expf(x - lse_r[i]) : 0.f;
        ds[e] = p * (dp[nt][e] - dl_r[i]) * a.sm_scale;
      }
      dsf[nt >> 1][(nt & 1) * 2] = Mma<T>::pack(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = Mma<T>::pack(ds[2], ds[3]);
    }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const T* kr = Kc + (j * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bk[2];
        ldmatrix_x2_trans(bk, kr + dt * 8);
        Mma<T>::run(acc[dt], dsf[j], bk);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is refilled
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q_start + r0 + 8 * i;
    if (qi >= a.Sq) continue;
    T* row = dq + (((long long)b * a.Sq + qi) * a.NH + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + cq) =
          Mma<T>::pack(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32) flash_bwd_dkv_mma_kernel(Args a) {
  constexpr int RS = D + 8, KT = D / 16, DT = D / 8;
  constexpr int BQ = DkvTile<D>::BQ, NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [kB][RS]
  T* Vs = Ks + kB * RS;                    // [kB][RS]
  T* Qs = Vs + kB * RS;                    // [2][BQ][RS]
  T* dOs = Qs + 2 * BQ * RS;               // [2][BQ][RS]
  __shared__ float lse_s[2][64], dl_s[2][64];
  const uint16_t* Kh = reinterpret_cast<const uint16_t*>(Ks);
  const uint16_t* Vh = reinterpret_cast<const uint16_t*>(Vs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bk = blockIdx.y;
  const int b = bk / a.KVH, kvh = bk % a.KVH;
  const int group = a.NH / a.KVH;
  const int k_start = blockIdx.x * kB;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  stage_async<T, D>(Ks, kb, a.kss, k_start, kB, a.Sk);
  stage_async<T, D>(Vs, vb, a.vss, k_start, kB, a.Sk);
  cp_async_commit();

  // the steps: every query head of the group, each over its query tiles
  // from the one holding this key tile's first key (when causal)
  const int first = a.causal ? k_start / BQ : 0;
  const int n_q = (a.Sq + BQ - 1) / BQ;
  const int per_head = max(n_q - first, 0);
  const int total = group * per_head;
  auto load_q = [&](int buf, int it) {
    const int h = kvh * group + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
    const T* ob = static_cast<const T*>(a.dout) + b * a.dsb + h * a.dsh;
    stage_async<T, D>(Qs + buf * BQ * RS, qb, a.qss, q0, BQ, a.Sq);
    stage_async<T, D>(dOs + buf * BQ * RS, ob, a.dss, q0, BQ, a.Sq);
    cp_async_commit();
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      const long long rowbase = ((long long)b * a.NH + h) * a.Sq;
      lse_s[buf][threadIdx.x] = qi < a.Sq ? a.lse[rowbase + qi] : 0.f;
      dl_s[buf][threadIdx.x] = qi < a.Sq ? a.delta[rowbase + qi] : 0.f;
    }
  };
  if (total > 0) {
    load_q(0, 0);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2);  // this lane's keys: r0 and r0 + 8
  const int cq = (lane & 3) * 2;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int cur = it & 1;
    if (it + 1 < total) {
      load_q(cur ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int h = kvh * group + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
    const T* Qc = Qs + cur * BQ * RS;
    const T* dOc = dOs + cur * BQ * RS;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t ka[4], va[4];
      load_a(ka, Kh, RS, r0, kt * 16 + cq);
      load_a(va, Vh, RS, r0, kt * 16 + cq);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* qr = Qc + (nt * 8 + (lane >> 2)) * RS + kt * 16 + cq;
        const T* orr = dOc + (nt * 8 + (lane >> 2)) * RS + kt * 16 + cq;
        const uint32_t bq[2] = {lds32(qr), lds32(qr + 8)};
        const uint32_t bo[2] = {lds32(orr), lds32(orr + 8)};
        Mma<T>::run(s[nt], ka, bq);
        Mma<T>::run(dp[nt], va, bo);
      }
    }
    // P^T and dS^T, packed as A fragments over the query (k) dimension
    uint32_t pf[NT / 2][4], dsf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k_start + r0 + 8 * (e >> 1);
        const int lq = nt * 8 + cq + (e & 1);
        const int row = q0 + lq;
        float x = s[nt][e] * a.sm_scale;
        if (a.slopes != nullptr) x -= slope * (float)(row - key);
        const bool vis = row < a.Sq && key < a.Sk && (!a.causal || row >= key);
        p[e] = vis ? expf(x - lse_s[cur][lq]) : 0.f;
        ds[e] = p[e] * (dp[nt][e] - dl_s[cur][lq]) * a.sm_scale;
      }
      pf[nt >> 1][(nt & 1) * 2] = Mma<T>::pack(p[0], p[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = Mma<T>::pack(p[2], p[3]);
      dsf[nt >> 1][(nt & 1) * 2] = Mma<T>::pack(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = Mma<T>::pack(ds[2], ds[3]);
    }
    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const T* orow = dOc + (j * 16 + (lane & 15)) * RS;
      const T* qrow = Qc + (j * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bo[2], bq[2];
        ldmatrix_x2_trans(bo, orow + dt * 8);
        Mma<T>::run(dv[dt], pf[j], bo);
        ldmatrix_x2_trans(bq, qrow + dt * 8);
        Mma<T>::run(dk[dt], dsf[j], bq);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is refilled
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k_start + r0 + 8 * i;
    if (key >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + key) * a.KVH + kvh) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dkp + off + dt * 8 + cq) =
          Mma<T>::pack(dk[dt][2 * i], dk[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvp + off + dt * 8 + cq) =
          Mma<T>::pack(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// fp32 on the FMA pipes, bf16/fp16 on the tensor cores
template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.B * a.NH);
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = dq_smem_bytes<D>();
    static cudaError_t attr = opt_in(flash_bwd_dq_kernel<D>, smem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    constexpr size_t smem = dq_mma_smem_bytes<D>();
    static cudaError_t attr = opt_in(flash_bwd_dq_mma_kernel<T, D>, smem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_dq_mma_kernel<T, D><<<grid, kMmaWarps * 32, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Sk + kB - 1) / kB, a.B * a.KVH);
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    static cudaError_t attr = opt_in(flash_bwd_dkv_kernel<D>, smem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    constexpr size_t smem = dkv_mma_smem_bytes<D>();
    static cudaError_t attr = opt_in(flash_bwd_dkv_mma_kernel<T, D>, smem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_dkv_mma_kernel<T, D><<<grid, kMmaWarps * 32, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(bool dkv, int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 16:
      return dkv ? launch_dkv<T, 16>(a, st) : launch_dq<T, 16>(a, st);
    case 32:
      return dkv ? launch_dkv<T, 32>(a, st) : launch_dq<T, 32>(a, st);
    case 64:
      return dkv ? launch_dkv<T, 64>(a, st) : launch_dq<T, 64>(a, st);
    case 128:
      return dkv ? launch_dkv<T, 128>(a, st) : launch_dq<T, 128>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(bool dkv, int dtype, int D, const Args& a, void* stream) {
  if (a.KVH <= 0 || a.NH % a.KVH != 0 || a.Sq <= 0 || a.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_d<float>(dkv, D, a, st);
    case 1:
      return (int)dispatch_d<__nv_bfloat16>(dkv, D, a, st);
    case 2:
      return (int)dispatch_d<__half>(dkv, D, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16 (q, k, v, dO and the gradients).
// q and dO [B, Sq, NH, D], k and v [B, Sk, KVH, D], read through the given
// element strides (batch, sequence, head; the last dim contiguous).  lse and
// delta [B, NH, Sq] fp32 contiguous; slopes [NH] fp32 or null.  dq
// [B, Sq, NH, D] and dk, dv [B, Sk, KVH, D] contiguous, written whole.  D is
// 16, 32, 64 or 128.  Returns cudaGetLastError() after the launch.
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
