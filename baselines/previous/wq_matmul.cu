// Weight-only quantized matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/wq_matmul.py
// :_wq_kernel (via wq_matmul): every projection and the LM head of the
// weight-only quantized serving engine (models/transformer.py _mm), seven
// launches per layer and one for the head on every prefill and decode call.
//
// What it computes, for x [M, K] and a weight stored as codes plus fp32
// scales per group of G rows along K:
//   out[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * q[k, n]
// with q int8 codes [Kp, N] (bits 8, |q| <= 127) or packed uint8 [Kp/2, N]
// (bits 4: row 2i in the low nibble, row 2i+1 in the high one, stored as
// q + 8), s fp32 [Kp/G, N], Kp = K rounded up to G; rows k >= K read x as 0.
// All sums are fp32; out has x's type.  The TPU kernel computes
// x_f32 @ (q * s) per group; taking the scale out of the group's sum is the
// same function and differs from it only in fp32 rounding.
//
// What bounds it on the H100: at decode (M = 8 slots) the bytes of the
// codes — a GEMV that reads each code once for 8 multiply-adds; llama-7b's
// 4096 x 11008 projection is 45 MB of int8 codes, 13.5 us at 3.35 TB/s.  At
// prefill (M ~ 1000) the tensor-core rate.
//
// Design, bf16 and fp16 x: one block of 4 warps per 64-column output tile
// of 16 rows for M <= 16 (decode) and 64 otherwise; each warp owns 16
// columns.  K is walked in stages of 32 rows, double-buffered through
// registers: while stage s runs on the tensor cores, stage s+1's x tile
// (16-byte loads) and codes (16 int8 or 8 packed int4 bytes a thread) are in
// flight; the codes are widened to x's type on the way into shared memory
// (exact: |q| <= 127).  The group's product x . q runs on mma.sync
// m16n8k16 with fp32 accumulators, B fragments from ldmatrix.trans on the
// row-major [k][n] tile; at the end of each group the accumulators are
// scaled by s[g, n] once and added to the running output.  When the output
// tiles alone would leave SMs idle (decode), K is split over blockIdx.z at
// group boundaries into an fp32 workspace, and a second kernel sums the
// splits in order (deterministic, no atomics) and rounds to x's type.
// Not yet: wgmma, TMA, warp specialisation (a later PR's work).
//
// Design, fp32 x (tests and references): the same tiles and split on the
// fp32 FMA pipes out of shared memory — 16 x 16 threads, BM/16 rows by 4
// columns each — so fp32 stays fp32 end to end (no TF32).
//
// Groups that are not a multiple of the 32-row stage (the reference takes
// any group that divides the padded K; the serving default is 128): a stage
// then holds rows of more than one group, so there is no group sum to scale
// once.  These take the FMA-pipe kernel for every x type, with each code
// multiplied by its own row's scale in fp32 as the stage is staged (q * s,
// the TPU kernel's own product), x widened to fp32, and the sums in fp32; K
// splits still fall on group boundaries, and a stage past its split's last
// row reads zeros.  They differ from the plain version by fp32 summation
// order only; the group-multiple path above is unchanged.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 32;  // rows of K per stage (groups off it: the ROWSCALE kernel)

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
  __device__ __forceinline__ static __nv_bfloat16 cvt(float f) { return __float2bfloat16_rn(f); }
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
  __device__ __forceinline__ static __half cvt(float f) { return __float2half_rn(f); }
};

__device__ __forceinline__ float to_float(float f) { return f; }
__device__ __forceinline__ float to_float(__nv_bfloat16 f) { return __bfloat162float(f); }
__device__ __forceinline__ float to_float(__half f) { return __half2float(f); }
__device__ __forceinline__ float to_out(float f, float*) { return f; }
__device__ __forceinline__ __nv_bfloat16 to_out(float f, __nv_bfloat16*) {
  return __float2bfloat16_rn(f);
}
__device__ __forceinline__ __half to_out(float f, __half*) { return __float2half_rn(f); }

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

__device__ __forceinline__ int8_t byte_of(uint32_t w, int i) {
  return static_cast<int8_t>((w >> (8 * i)) & 0xffu);
}
__device__ __forceinline__ float lo_nibble(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>((w >> (8 * i)) & 0xfu) - 8);
}
__device__ __forceinline__ float hi_nibble(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>((w >> (8 * i + 4)) & 0xfu) - 8);
}

// `nbytes` code bytes of one row starting at column n (n < N checked per
// byte unless the whole run is in range and aligned), packed little-endian
template <int NBYTES>
__device__ __forceinline__ void load_codes(uint32_t* w, const uint8_t* src, int n, int N,
                                           bool vec) {
#pragma unroll
  for (int i = 0; i < NBYTES / 4; ++i) w[i] = 0u;
  if (vec) {
    if (n < N) {  // N is a multiple of NBYTES: the run is all in or all out
      if constexpr (NBYTES == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else if constexpr (NBYTES == 8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        w[0] = v.x; w[1] = v.y;
      } else {
        w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NBYTES; ++j)
    if (n + j < N) w[j / 4] |= static_cast<uint32_t>(__ldg(src + j)) << (8 * (j % 4));
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16, fp16 x)
// ---------------------------------------------------------------------------
// A block of 4 warps computes a BM x 64 output tile, each warp BM x 16 of
// it in m16n8 pieces; each of the 128 threads moves one run of codes per
// stage (32 x 64 int8 bytes in 16-byte runs, or 16 x 64 int4 bytes in
// 8-byte runs).  A 128 x 128 tile of 8 warps (219 registers, one block per
// SM) was slower at llama-7b's prefill shapes on the H100 (PERF.md).
template <typename T, int BITS, int BM>
__global__ void __launch_bounds__(128)
wq_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
              const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ ws,
              int M, int K, int N, int group, int groups_per_split, int n_groups, int x_vec,
              int w_vec) {
  constexpr int BN = kBN;
  constexpr int THREADS = 128;
  constexpr int WM = BM, WN = BN / 4;               // a warp's tile
  constexpr int MT = WM / 16, NT = WN / 8;          // its m16 and n8 pieces
  constexpr int XS = kBK + 8;                       // padded rows: conflict-free ldmatrix
  constexpr int WS = BN + 8;
  constexpr int XCHUNKS = BM * kBK / 8;             // 16-byte chunks of the x tile
  constexpr int XPT = (XCHUNKS + THREADS - 1) / THREADS;
  constexpr int WBYTES = BITS == 8 ? 16 : 8;        // code bytes per thread per stage
  constexpr int WRUNS = BN / WBYTES;                // code runs per row
  __shared__ __align__(16) T sx[2][BM][XS];
  __shared__ __align__(16) T sw[2][kBK][WS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col0 = warp * WN;  // this warp's columns within the block's
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(g_begin + groups_per_split, n_groups);
  const int stages_per_group = group / kBK;
  const int n_stages = max(g_end - g_begin, 0) * stages_per_group;
  const int k_begin = g_begin * group;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);

  uint4 xr[XPT];
  uint32_t wr[WBYTES / 4];
  // this thread's code run: int8 16 bytes of K row w_row; int4 8 packed
  // bytes of packed row w_row (= K rows 2*w_row and 2*w_row + 1)
  const int w_row = tid / WRUNS;
  const int w_col = (tid % WRUNS) * WBYTES;

  auto load_stage = [&](int k0) {
#pragma unroll
    for (int c = 0; c < XPT; ++c) {
      const int idx = tid + c * THREADS;
      xr[c] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < XCHUNKS) {
        const int r = idx / (kBK / 8);
        const int k = k0 + (idx % (kBK / 8)) * 8;
        const int m = m0 + r;
        if (m < M) {
          const uint16_t* src = xs + (long long)m * K + k;
          if (x_vec) {
            if (k < K) xr[c] = *reinterpret_cast<const uint4*>(src);  // K % 8 == 0
          } else {
            uint32_t h[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (k + j < K) h[j / 2] |= static_cast<uint32_t>(src[j]) << (16 * (j % 2));
            xr[c] = make_uint4(h[0], h[1], h[2], h[3]);
          }
        }
      }
    }
    const long long row = BITS == 8 ? (long long)(k0 + w_row) : (long long)(k0 / 2 + w_row);
    load_codes<WBYTES>(wr, codes + row * N + n0 + w_col, n0 + w_col, N, w_vec != 0);
  };

  auto store_stage = [&](int buf) {
#pragma unroll
    for (int c = 0; c < XPT; ++c) {
      const int idx = tid + c * THREADS;
      if (idx < XCHUNKS)
        *reinterpret_cast<uint4*>(&sx[buf][idx / (kBK / 8)][(idx % (kBK / 8)) * 8]) = xr[c];
    }
    if constexpr (BITS == 8) {
      uint32_t p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = Mma<T>::pack(static_cast<float>(byte_of(wr[i / 2], 2 * (i % 2))),
                            static_cast<float>(byte_of(wr[i / 2], 2 * (i % 2) + 1)));
      *reinterpret_cast<uint4*>(&sw[buf][w_row][w_col]) = make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(&sw[buf][w_row][w_col + 8]) = make_uint4(p[4], p[5], p[6], p[7]);
    } else {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = wr[i / 2];
        const int b = 2 * (i % 2);
        lo[i] = Mma<T>::pack(lo_nibble(w, b), lo_nibble(w, b + 1));
        hi[i] = Mma<T>::pack(hi_nibble(w, b), hi_nibble(w, b + 1));
      }
      *reinterpret_cast<uint4*>(&sw[buf][2 * w_row][w_col]) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(&sw[buf][2 * w_row + 1][w_col]) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  };

  float acc[MT][NT][4], gacc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = gacc[mt][j][i] = 0.f;
  // this lane's output columns: n0 + col0 + j*8 + cq + {0, 1}
  const int cq = 2 * (lane & 3);
  float sc[NT][2];

  if (n_stages > 0) {
    load_stage(k_begin);
    store_stage(0);
  }
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) load_stage(k_begin + (s + 1) * kBK);
    const int gs = s % stages_per_group;
    if (gs == 0) {
      const long long g = g_begin + s / stages_per_group;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + col0 + j * 8 + cq + h;
          sc[j][h] = n < N ? __ldg(scale + g * N + n) : 0.f;
        }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[NT / 2][4];  // two n8 pieces per ldmatrix
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2)
        ldmatrix_x4_trans(b[j2], &sw[buf][kk + (lane & 15)][col0 + j2 * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, &sx[buf][mt * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          Mma<T>::run(gacc[mt][2 * j2], a, b[j2]);
          Mma<T>::run(gacc[mt][2 * j2 + 1], a, b[j2] + 2);
        }
      }
    }
    if (gs == stages_per_group - 1) {  // the group is done: scale it once
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][j][i] += gacc[mt][j][i] * sc[j][i & 1];
            gacc[mt][j][i] = 0.f;
          }
    }
    if (s + 1 < n_stages) store_stage(buf ^ 1);
    __syncthreads();
  }

  const bool pair_store = (N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + col0 + j * 8 + cq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + mt * 16 + (lane >> 2) + half * 8;
        if (m >= M || n >= N) continue;
        const float v0 = acc[mt][j][half * 2], v1 = acc[mt][j][half * 2 + 1];
        if (ws != nullptr) {
          float* dst = ws + (long long)blockIdx.z * M * N + (long long)m * N + n;
          dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        } else if (pair_store) {
          *reinterpret_cast<uint32_t*>(out + (long long)m * N + n) = Mma<T>::pack(v0, v1);
        } else {
          out[(long long)m * N + n] = Mma<T>::cvt(v0);
          if (n + 1 < N) out[(long long)m * N + n + 1] = Mma<T>::cvt(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// FMA-pipe kernel (fp32 x; any x with ROWSCALE, for groups off the stage)
// ---------------------------------------------------------------------------
template <typename T, int BITS, int BM, bool ROWSCALE>
__global__ void __launch_bounds__(256)
wq_fma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
              const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ ws,
              int M, int K, int N, int group, int groups_per_split, int n_groups, int w_vec) {
  constexpr int TM = BM / 16;          // rows per thread
  constexpr int XS = BM + 4;           // padded rows of the transposed x tile
  constexpr int XE = BM * kBK / 256;   // x elements per thread per stage
  constexpr int WBYTES = BITS == 8 ? 8 : 4;
  __shared__ __align__(16) float sx[2][kBK][XS];  // [k][m]
  __shared__ __align__(16) float sw[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4 .. +3
  const int ty = tid >> 4;  // rows ty*TM .. +TM-1
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(g_begin + groups_per_split, n_groups);
  const int stages_per_group = group / kBK;
  const int k_begin = g_begin * group;
  const int k_end = max(g_end, g_begin) * group;  // this split's rows: [k_begin, k_end)
  const int n_stages = ROWSCALE ? (k_end - k_begin + kBK - 1) / kBK
                                : max(g_end - g_begin, 0) * stages_per_group;
  const int w_row = BITS == 8 ? tid >> 3 : tid >> 4;
  const int w_col = BITS == 8 ? (tid & 7) * 8 : (tid & 15) * 4;
  // with ROWSCALE the last stage may run past the split: its rows read zeros
  const int k_lim = ROWSCALE ? min(K, k_end) : K;

  float xr[XE];
  uint32_t wr[WBYTES / 4];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int idx = tid + e * 256;
      const int m = m0 + idx / kBK, k = k0 + idx % kBK;
      xr[e] = (m < M && k < k_lim) ? to_float(x[(long long)m * K + k]) : 0.f;
    }
    const int k_first = BITS == 8 ? k0 + w_row : k0 + 2 * w_row;  // this run's first K row
    if (!ROWSCALE || k_first < k_end) {
      const long long row = BITS == 8 ? (long long)(k0 + w_row) : (long long)(k0 / 2 + w_row);
      load_codes<WBYTES>(wr, codes + row * N + n0 + w_col, n0 + w_col, N, w_vec != 0);
    } else {
#pragma unroll
      for (int i = 0; i < WBYTES / 4; ++i) wr[i] = 0u;
    }
  };
  // the code of K row k (local row r) and column n0 + w_col + j, times its
  // row's scale with ROWSCALE
  auto weight = [&](float q, int k, int j) {
    if constexpr (ROWSCALE) {
      const int n = n0 + w_col + j;
      return (k < k_end && n < N) ? q * __ldg(scale + (long long)(k / group) * N + n) : 0.f;
    } else {
      return q;
    }
  };
  auto store_stage = [&](int buf, int k0) {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int idx = tid + e * 256;
      sx[buf][idx % kBK][idx / kBK] = xr[e];
    }
    if constexpr (BITS == 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sw[buf][w_row][w_col + j] =
            weight(static_cast<float>(byte_of(wr[j / 4], j % 4)), k0 + w_row, j);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sw[buf][2 * w_row][w_col + j] = weight(lo_nibble(wr[0], j), k0 + 2 * w_row, j);
        sw[buf][2 * w_row + 1][w_col + j] = weight(hi_nibble(wr[0], j), k0 + 2 * w_row + 1, j);
      }
    }
  };

  float acc[TM][4], gacc[TM][4], sc[4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = gacc[i][j] = 0.f;

  if (n_stages > 0) {
    load_stage(k_begin);
    store_stage(0, k_begin);
  }
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) load_stage(k_begin + (s + 1) * kBK);
    const int gs = ROWSCALE ? 0 : s % stages_per_group;
    if (!ROWSCALE && gs == 0) {
      const long long g = g_begin + s / stages_per_group;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        sc[j] = n < N ? __ldg(scale + g * N + n) : 0.f;
      }
    }
    // with ROWSCALE the staged weights carry their scales: sum into acc
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(&sw[buf][k][tx * 4]);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xv = sx[buf][k][ty * TM + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ROWSCALE)
            acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          else
            gacc[i][j] = fmaf(xv, wv[j], gacc[i][j]);
        }
      }
    }
    if (!ROWSCALE && gs == stages_per_group - 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += gacc[i][j] * sc[j];
          gacc[i][j] = 0.f;
        }
    }
    if (s + 1 < n_stages) store_stage(buf ^ 1, k_begin + (s + 1) * kBK);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      if (ws != nullptr)
        ws[(long long)blockIdx.z * M * N + (long long)m * N + n] = acc[i][j];
      else
        out[(long long)m * N + n] = to_out(acc[i][j], out);
    }
  }
}

// out[i] = sum over the splits of ws[z][i], in split order, rounded once
template <typename T>
__global__ void __launch_bounds__(256)
wq_splitk_reduce(const float* __restrict__ ws, T* __restrict__ out, long long mn, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn; i += stride) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(long long)z * mn + i];
    out[i] = to_out(s, out);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

template <typename T, int BITS>
cudaError_t launch_mma(const void* x, const void* codes, const float* scale, void* out,
                       float* ws, int M, int K, int N, int group, int gps, int n_groups,
                       int splits, int tile_m, cudaStream_t st) {
  const int x_vec = (K % 8 == 0) && aligned(x, 16);
  const int w_vec = BITS == 8 ? (N % 16 == 0 && aligned(codes, 16))
                              : (N % 8 == 0 && aligned(codes, 8));
  const T* xt = static_cast<const T*>(x);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  T* o = static_cast<T*>(out);
  if (tile_m != 16 && tile_m != 64) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + tile_m - 1) / tile_m, splits);
  if (tile_m == 16)
    wq_mma_kernel<T, BITS, 16><<<grid, 128, 0, st>>>(xt, c, scale, o, ws, M, K, N, group, gps,
                                                     n_groups, x_vec, w_vec);
  else
    wq_mma_kernel<T, BITS, 64><<<grid, 128, 0, st>>>(xt, c, scale, o, ws, M, K, N, group, gps,
                                                     n_groups, x_vec, w_vec);
  return cudaGetLastError();
}

template <typename T, int BITS, bool ROWSCALE>
cudaError_t launch_fma(const void* x, const void* codes, const float* scale, void* out,
                       float* ws, int M, int K, int N, int group, int gps, int n_groups,
                       int splits, int tile_m, cudaStream_t st) {
  const int w_vec = BITS == 8 ? (N % 8 == 0 && aligned(codes, 8))
                              : (N % 4 == 0 && aligned(codes, 4));
  const T* xt = static_cast<const T*>(x);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  T* o = static_cast<T*>(out);
  if (tile_m != 16 && tile_m != 64) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + tile_m - 1) / tile_m, splits);
  if (tile_m == 16)
    wq_fma_kernel<T, BITS, 16, ROWSCALE><<<grid, 256, 0, st>>>(xt, c, scale, o, ws, M, K, N,
                                                                group, gps, n_groups, w_vec);
  else
    wq_fma_kernel<T, BITS, 64, ROWSCALE><<<grid, 256, 0, st>>>(xt, c, scale, o, ws, M, K, N,
                                                                group, gps, n_groups, w_vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const float* ws, void* out, long long mn, int splits, cudaStream_t st) {
  long long blocks = (mn + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  wq_splitk_reduce<T><<<(int)blocks, 256, 0, st>>>(ws, static_cast<T*>(out), mn, splits);
  return cudaGetLastError();
}

}  // namespace

// out [M, N] = x [M, K] @ dequant(codes, scale).  dtype: 0 fp32, 1 bf16,
// 2 fp16 (x and out); bits 8 (codes int8 [Kp, N]) or 4 (packed uint8
// [Kp/2, N]); scale fp32 [n_groups, N]; any group (even for bits 4), Kp =
// n_groups * group >= K; a group off the 32-row stage takes the FMA-pipe
// kernel with per-row scales.  Output tiles are tile_m (16 or 64) x 64.  K is
// split into `splits` runs of `groups_per_split` groups; with splits >
// 1, ws is an fp32 [splits, M, N] workspace and a second kernel sums it into
// out.  All tensors contiguous.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int dstpu_wq_matmul(const void* x, const void* codes, const void* scale, void* out,
                               void* ws, int dtype, int bits, int M, int K, int N, int group,
                               int n_groups, int splits, int groups_per_split, int tile_m,
                               void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || group <= 0 || (bits == 4 && group % 2) || n_groups <= 0 ||
      (long long)n_groups * group < K || splits < 1 || groups_per_split < 1 ||
      (long long)splits * groups_per_split < n_groups || (splits > 1 && ws == nullptr) ||
      (bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  cudaError_t err;
  const int gps = groups_per_split;
  // a group off the stage: the FMA-pipe kernel, codes scaled per row
  if (group % kBK != 0) {
    switch (dtype * 10 + bits) {
#define DSTPU_WQ_ROWSCALE(code, T, b)                                                      \
  case code:                                                                               \
    err = launch_fma<T, b, true>(x, codes, s, out, w, M, K, N, group, gps, n_groups, splits, \
                                 tile_m, st);                                              \
    break;
      DSTPU_WQ_ROWSCALE(8, float, 8)
      DSTPU_WQ_ROWSCALE(4, float, 4)
      DSTPU_WQ_ROWSCALE(18, __nv_bfloat16, 8)
      DSTPU_WQ_ROWSCALE(14, __nv_bfloat16, 4)
      DSTPU_WQ_ROWSCALE(28, __half, 8)
      DSTPU_WQ_ROWSCALE(24, __half, 4)
#undef DSTPU_WQ_ROWSCALE
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
  switch (dtype * 10 + bits) {
    case 8: err = launch_fma<float, 8, false>(x, codes, s, out, w, M, K, N, group, gps,
                                              n_groups, splits, tile_m, st); break;
    case 4: err = launch_fma<float, 4, false>(x, codes, s, out, w, M, K, N, group, gps,
                                              n_groups, splits, tile_m, st); break;
    case 18: err = launch_mma<__nv_bfloat16, 8>(x, codes, s, out, w, M, K, N, group, gps,
                                                n_groups, splits, tile_m, st); break;
    case 14: err = launch_mma<__nv_bfloat16, 4>(x, codes, s, out, w, M, K, N, group, gps,
                                                n_groups, splits, tile_m, st); break;
    case 28: err = launch_mma<__half, 8>(x, codes, s, out, w, M, K, N, group, gps, n_groups,
                                         splits, tile_m, st); break;
    case 24: err = launch_mma<__half, 4>(x, codes, s, out, w, M, K, N, group, gps, n_groups,
                                         splits, tile_m, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  switch (dtype) {
    case 0: return (int)launch_reduce<float>(w, out, mn, splits, st);
    case 1: return (int)launch_reduce<__nv_bfloat16>(w, out, mn, splits, st);
    default: return (int)launch_reduce<__half>(w, out, mn, splits, st);
  }
}
