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
// Design, bf16 and fp16 x, groups that are a multiple of the 64-row stage,
// rows and codes that TMA can read (K % 8 == 0, N % 16 == 0, 16-byte
// aligned bases) — the serving path:
//   Swapped operands.  The block computes out^T = W^T x^T: 64 of W's N
//   columns fill wgmma's 64-row M, and the tokens sit in wgmma's N (8, 16,
//   32, 64 or 128: the smallest that holds M, 128-token tiles past that), so
//   decode runs m64n8 with no padded rows.  One consumer warpgroup per 64
//   columns: one per block up to 32 tokens (3-4 blocks an SM), two past that
//   (one block an SM; 168 registers a thread beside the producer warp).
//   Raw codes ride the TMA.  A producer warp keeps a ring of up to 8 stages
//   full: a stage is one TMA box of the raw codes of 64 K rows (int8; 32
//   packed rows for int4) x the block's columns, and one box of x's 64 K
//   columns x the token tile with TMA's 128-byte swizzle, completing on an
//   mbarrier.  The copies spend no registers, and the codes stay 1 or 1/2
//   byte until they reach the SM: at decode 12-28 KB of codes are in flight
//   per block, 4 blocks an SM.  (Issued from a consumer thread instead, its
//   waits for its warpgroup's releases stalled the warpgroup on the card.)
//   Dequantized in their own layout.  Each warpgroup widens its 64 x 64
//   codes of a stage to x's type (exact: int8 by the 2^23 + q + 128 float
//   trick, int4 by OR-ing the nibble into 128.0 (bf16) or 1024.0 (fp16) and
//   subtracting), 16-byte chunks into a [64 k][64 n] tile with the 128-byte
//   swizzle, double-buffered.  That is W^T stored MN-major, which wgmma
//   reads as its A operand through the transpose bit; x is the K-major B
//   operand as TMA left it.  A stage is widened while the previous stage's
//   products are still on the tensor cores.
//   Group scales.  Each group's x . q sums in its own fp32 accumulators
//   (the first product of a group overwrites them); when the next group
//   starts, the finished sums are scaled once by s[g, n] (two scales per
//   thread: its rows are columns of W) and added to the output
//   accumulators.
//   K splits.  When the output tiles alone would not fill the SMs (decode),
//   K is split over blockIdx.z at group boundaries into as many splits as
//   one wave of blocks holds (a second, part-full wave left SMs idle), into
//   an fp32 workspace, and a second kernel sums the splits in order
//   (deterministic, no atomics) and rounds to x's type.  Tokens are the
//   fastest grid axis, so the blocks of one column tile run together and
//   share its codes in L2.
//   What the card gave (chip_smoke.py phase 10; PERF.md section 6 row 6): at
//   decode about half the byte bound, the SM waiting on its stages' codes
//   for much of it (stages of 128 rows, or 128 columns a block, changed
//   nothing); at M = 900 about a quarter of the tensor-core bound, twice
//   the mma.sync kernel this replaces.
//
// FMA-pipe kernel, the rest: fp32 x (tests and references), groups off the
// stage, and rows or codes TMA cannot read.  64-column tiles of 16 or 64
// rows, 16 x 16 threads, K in stages of 32 rows double-buffered through
// registers, fp32 end to end.  A group that is a multiple of 32 rows sums
// its codes and scales the group once, as above; any other group (the
// reference takes any group that divides the padded K) scales each code by
// its own row's scale in fp32 as the stage is staged (q * s, the TPU
// kernel's own product).  K splits still fall on group boundaries, and a
// stage past its split's last row reads zeros.

#include "hopper.cuh"

namespace {

constexpr int kBN = 64;   // FMA kernel: output columns per block
constexpr int kBK = 32;   // FMA kernel: rows of K per stage (groups off it: ROWSCALE)
constexpr int kWgK = 64;  // tensor-core kernel: rows of K per stage

__device__ __forceinline__ float to_float(float f) { return f; }
__device__ __forceinline__ float to_float(__nv_bfloat16 f) { return __bfloat162float(f); }
__device__ __forceinline__ float to_float(__half f) { return __half2float(f); }
__device__ __forceinline__ float to_out(float f, float*) { return f; }
__device__ __forceinline__ __nv_bfloat16 to_out(float f, __nv_bfloat16*) {
  return __float2bfloat16_rn(f);
}
__device__ __forceinline__ __half to_out(float f, __half*) { return __float2half_rn(f); }

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
// FMA-pipe kernel (fp32 x; groups off the 64-row stage; rows or codes TMA
// cannot read): ROWSCALE for groups off its own 32-row stage
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


// ---------------------------------------------------------------------------
// tensor-core kernel (bf16, fp16 x): TMA-fed raw codes, wgmma with A = W^T
// ---------------------------------------------------------------------------
// m64nNk16, fp32 accumulators, A MN-major (transposed) and B K-major, both in
// shared memory; d = A B when acc is 0, else d += A B
template <typename T, int N> struct WgmmaTS;
template <> struct WgmmaTS<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__nv_bfloat16, 16> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__nv_bfloat16, 32> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__nv_bfloat16, 64> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__nv_bfloat16, 128> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31,\n"
        "%32, %33, %34, %35, %36, %37, %38, %39,\n"
        "%40, %41, %42, %43, %44, %45, %46, %47,\n"
        "%48, %49, %50, %51, %52, %53, %54, %55,\n"
        "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__half, 8> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 {"
        "%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__half, 16> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__half, 32> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__half, 64> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct WgmmaTS<__half, 128> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31,\n"
        "%32, %33, %34, %35, %36, %37, %38, %39,\n"
        "%40, %41, %42, %43, %44, %45, %46, %47,\n"
        "%48, %49, %50, %51, %52, %53, %54, %55,\n"
        "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// exact widening of codes to x's type, as bf16x2/half2 pairs (low half the
// lower column)
template <typename T> struct Widen;
template <> struct Widen<__nv_bfloat16> {
  // four int8 codes -> columns (0, 1) and (2, 3): 2^23 + (q + 128) as a
  // float, less 2^23 + 128, rounded (exactly) to bf16
  __device__ __forceinline__ static void i8(uint32_t w, uint32_t& c01, uint32_t& c23) {
    const uint32_t u = w ^ 0x80808080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
    c01 = Cvt<__nv_bfloat16>::pack(f0, f1);
    c23 = Cvt<__nv_bfloat16>::pack(f2, f3);
  }
  // nibble pairs OR-ed into 128.0 (0x4300, mantissa step 1), less 136
  __device__ __forceinline__ static uint32_t nib(uint32_t v) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
    h = __hsub2(h, __floats2bfloat162_rn(136.f, 136.f));
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static constexpr uint32_t kMagic = 0x43004300u;
};
template <> struct Widen<__half> {
  // four int8 codes: 1024 + (q + 128) as fp16 bits, less 1152
  __device__ __forceinline__ static void i8(uint32_t w, uint32_t& c01, uint32_t& c23) {
    const uint32_t u = w ^ 0x80808080u;
    const __half2 k = __floats2half2_rn(1152.f, 1152.f);
    uint32_t a = __byte_perm(u, 0x64u, 0x4140), b = __byte_perm(u, 0x64u, 0x4342);
    __half2 ha = __hsub2(*reinterpret_cast<const __half2*>(&a), k);
    __half2 hb = __hsub2(*reinterpret_cast<const __half2*>(&b), k);
    c01 = *reinterpret_cast<uint32_t*>(&ha);
    c23 = *reinterpret_cast<uint32_t*>(&hb);
  }
  // nibble pairs OR-ed into 1024.0 (0x6400), less 1032
  __device__ __forceinline__ static uint32_t nib(uint32_t v) {
    __half2 h = *reinterpret_cast<const __half2*>(&v);
    h = __hsub2(h, __floats2half2_rn(1032.f, 1032.f));
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static constexpr uint32_t kMagic = 0x64006400u;
};

// four packed int4 bytes (columns 0-3) -> even K row (low nibbles) and odd
// K row (high nibbles), each as columns (0, 1) and (2, 3)
template <typename T>
__device__ __forceinline__ void widen_i4(uint32_t w, uint32_t* ev, uint32_t* od) {
  const uint32_t p = __byte_perm(w, 0u, 0x3120);  // bytes 0, 2, 1, 3: pairs in halves
  constexpr uint32_t m = Widen<T>::kMagic;
  ev[0] = Widen<T>::nib((p & 0x000F000Fu) | m);
  ev[1] = Widen<T>::nib(((p >> 8) & 0x000F000Fu) | m);
  od[0] = Widen<T>::nib(((p >> 4) & 0x000F000Fu) | m);
  od[1] = Widen<T>::nib(((p >> 12) & 0x000F000Fu) | m);
}

// 16-byte chunk c of row r of a [rows][64] 16-bit tile with TMA's 128-byte
// swizzle (the tile 1024-byte aligned)
__device__ __forceinline__ uint4* sw128(unsigned char* tile, int r, int c) {
  return reinterpret_cast<uint4*>(tile + r * 128 + ((c ^ (r & 7)) << 4));
}

// this warpgroup's codes of one stage (its 64 columns of rows BN bytes
// apart) widened into the [64 k][64 n] tile A
template <typename T, int BITS, int BN>
__device__ __forceinline__ void widen_stage(const unsigned char* codes, T* A, int tid) {
  unsigned char* a = reinterpret_cast<unsigned char*>(A);
  if constexpr (BITS == 8) {
#pragma unroll
    for (int it = 0; it < kWgK / 32; ++it) {
      const int c = tid + 128 * it;
      const int r = c >> 2, q = c & 3;  // K row r, columns 16 q .. 16 q + 15
      const uint4 v = *reinterpret_cast<const uint4*>(codes + r * BN + 16 * q);
      uint32_t o[8];
      Widen<T>::i8(v.x, o[0], o[1]);
      Widen<T>::i8(v.y, o[2], o[3]);
      Widen<T>::i8(v.z, o[4], o[5]);
      Widen<T>::i8(v.w, o[6], o[7]);
      *sw128(a, r, 2 * q) = make_uint4(o[0], o[1], o[2], o[3]);
      *sw128(a, r, 2 * q + 1) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  } else {
#pragma unroll
    for (int it = 0; it < kWgK / 64; ++it) {
      const int c = tid + 128 * it;
      const int r = c >> 2, q = c & 3;  // packed row r: K rows 2 r and 2 r + 1
      const uint4 v = *reinterpret_cast<const uint4*>(codes + r * BN + 16 * q);
      uint32_t ev[8], od[8];
      widen_i4<T>(v.x, ev, od);
      widen_i4<T>(v.y, ev + 2, od + 2);
      widen_i4<T>(v.z, ev + 4, od + 4);
      widen_i4<T>(v.w, ev + 6, od + 6);
      *sw128(a, 2 * r, 2 * q) = make_uint4(ev[0], ev[1], ev[2], ev[3]);
      *sw128(a, 2 * r, 2 * q + 1) = make_uint4(ev[4], ev[5], ev[6], ev[7]);
      *sw128(a, 2 * r + 1, 2 * q) = make_uint4(od[0], od[1], od[2], od[3]);
      *sw128(a, 2 * r + 1, 2 * q + 1) = make_uint4(od[4], od[5], od[6], od[7]);
    }
  }
}

__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// the tile of NT tokens and NWG x 64 columns: its ring and how many blocks
// an SM holds at once (decode tiles are small, so several blocks share an
// SM and keep more codes in flight)
template <int NT, int NWG, int BITS>
struct WqCfg {
  static constexpr int THREADS = 128 * NWG + 32;               // consumers + a producer warp
  static constexpr int BN = 64 * NWG;                          // output columns
  static constexpr int CROWS = BITS == 8 ? kWgK : kWgK / 2;    // code rows per stage
  static constexpr int X_BYTES = NT * kWgK * 2;
  static constexpr int C_BYTES = BN * CROWS;
  static constexpr int STAGE = X_BYTES + C_BYTES;
  static constexpr int A_BYTES = kWgK * 64 * 2;                // one widened tile
  static constexpr int CTAS = NWG == 2 ? 1 : NT <= 16 ? 4 : 3;
  static constexpr int BUDGET = 232448 / CTAS - 1024 - 1024 - 256;
  static constexpr int FIT = (BUDGET - 2 * NWG * A_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t smem = 1024 + 2 * NWG * A_BYTES + (size_t)STAGES * STAGE + 16 * STAGES;
  static_assert(STAGES >= 3, "ring");
  static_assert(X_BYTES % 1024 == 0 && C_BYTES % 1024 == 0, "1024-byte aligned tiles");
};

struct WqArgs {
  const float* scale;
  void* out;
  float* ws;  // K split: fp32 [splits][M][N], else null
  int M, K, N, group, n_groups, gps;
};

template <typename T, int BITS, int NT, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, WqCfg<NT, NWG, BITS>::CTAS)
    wq_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tc, const WqArgs a) {
  using C = WqCfg<NT, NWG, BITS>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: tiles start on that
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* As = reinterpret_cast<T*>(base);                    // [NWG][2][64 k][64 n]
  unsigned char* stages = base + 2 * NWG * C::A_BYTES;   // [ST][x tile | codes]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + ST * C::STAGE);
  uint64_t* empty = full + ST;

  const int m0 = blockIdx.x * NT;
  const int n0 = blockIdx.y * C::BN;
  const int g_begin = blockIdx.z * a.gps;
  const int g_end = min(g_begin + a.gps, a.n_groups);
  const int spg = a.group / kWgK;  // stages per group
  const int n_st = max(g_end - g_begin, 0) * spg;
  const int k_begin = g_begin * a.group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto xs = [&](int st) { return reinterpret_cast<T*>(stages + st * C::STAGE); };
  auto cs = [&](int st) { return stages + st * C::STAGE + C::X_BYTES; };
  if (threadIdx.x >= 128 * NWG) {
    // the producer warp: one lane keeps the ring full; stage t waits until
    // every consumer is done with the stage's previous use (released one
    // stage late, once its products are done)
    if (threadIdx.x == 128 * NWG)
      for (int t = 0; t < n_st; ++t) {
        const int st = t % ST;
        if (t >= ST) mbar_wait(&empty[st], (t / ST - 1) & 1);
        const int k = k_begin + t * kWgK;
        mbar_arrive_tx(&full[st], C::STAGE);
        tma_load_2d(xs(st), &tx, k, m0, &full[st]);
        tma_load_2d(cs(st), &tc, n0, BITS == 8 ? k : k / 2, &full[st]);
      }
    return;
  }

  const int w = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31;
  // this lane's accumulator rows are W's columns nrow and nrow + 8, its
  // columns the tokens m0 + 8 j + 2 (lane % 4) (+ 1)
  const int nrow = n0 + 64 * w + 16 * (tid >> 5) + (lane >> 2);
  float acc[NT / 2], gacc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = gacc[i] = 0.f;
  float sc[2] = {0.f, 0.f};

  for (int i = 0; i < n_st; ++i) {
    const int st = i % ST;
    mbar_wait(&full[st], (i / ST) & 1);
    // widened while the previous stage's products run; this buffer's last
    // reader (stage i - 2) finished before stage i - 1 was issued on
    T* A = As + (2 * w + (i & 1)) * (kWgK * 64);
    widen_stage<T, BITS, C::BN>(cs(st) + 64 * w, A, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    warpgroup_sync(w);
    const int gs = i % spg;
    if (gs == 0) {
      if (i > 0) {  // the previous group is summed: scale it once
        wg_wait<0>();
        pin(gacc);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) acc[j] = fmaf(gacc[j], sc[(j >> 1) & 1], acc[j]);
      }
      const long long g = g_begin + i / spg;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = nrow + 8 * r;
        sc[r] = n < a.N ? __ldg(a.scale + g * a.N + n) : 0.f;
      }
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk)
      WgmmaTS<T, NT>::run(gacc, gmma_desc_sw<64>(A + kk * 16 * 64, kWgK * 64 * 2, 1024),
                          gmma_desc_sw<64>(xs(st) + kk * 16, 16, 1024), gs > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();  // stage i - 1's products are done: its stage is free
    if (i > 0) mbar_arrive(&empty[(i - 1) % ST]);
  }
  wg_wait<0>();
  pin(gacc);
  if (n_st > 0) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) acc[j] = fmaf(gacc[j], sc[(j >> 1) & 1], acc[j]);
  }

  T* out = static_cast<T*>(a.out);
  const int mc = m0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nrow + 8 * r, m = mc + 8 * j + e;
        if (n >= a.N || m >= a.M) continue;
        const float v = acc[4 * j + 2 * r + e];
        if (a.ws != nullptr)
          a.ws[((long long)blockIdx.z * a.M + m) * a.N + n] = v;
        else
          out[(long long)m * a.N + n] = to_out(v, out);
      }
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

// the TMA map of the codes: uint8 [rows][N] in boxes of bc bytes x br rows
cudaError_t codes_map(CUtensorMap* m, const void* codes, int N, int rows, int bc, int br) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)bc, (cuuint32_t)br};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(codes), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int BITS, int NT, int NWG>
cudaError_t launch_wgmma(const void* x, const void* codes, const float* scale, void* out,
                         float* ws, int M, int K, int N, int group, int gps, int n_groups,
                         int splits, cudaStream_t st) {
  using C = WqCfg<NT, NWG, BITS>;
  // x as (K, M) in boxes of 64 x NT, swizzled; codes as (N, rows) in boxes
  // of the block's columns x one stage's rows; K past K and rows past M or
  // the codes arrive as zeros
  CUtensorMap m[2];
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {(cuuint32_t)kWgK, (cuuint32_t)NT};
  cudaError_t err;
  const int rows = BITS == 8 ? n_groups * group : n_groups * group / 2;
  if ((err = encode_map<T>(&m[0], x, 2, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = codes_map(&m[1], codes, N, rows, C::BN, C::CROWS)) != cudaSuccess)
    return err;
  static const cudaError_t attr = opt_in(wq_wgmma_kernel<T, BITS, NT, NWG>, C::smem);
  if (attr != cudaSuccess) return attr;
  const WqArgs a{scale, out, splits > 1 ? ws : nullptr, M, K, N, group, n_groups, gps};
  const dim3 grid((M + NT - 1) / NT, (N + C::BN - 1) / C::BN, splits);
  wq_wgmma_kernel<T, BITS, NT, NWG><<<grid, C::THREADS, C::smem, st>>>(m[0], m[1], a);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_tiles(int tile_m, const void* x, const void* codes, const float* scale,
                         void* out, float* ws, int M, int K, int N, int group, int gps,
                         int n_groups, int splits, cudaStream_t st) {
  switch (tile_m) {
#define DSTPU_WQ_TILE(nt, nwg)                                                                  \
  case nt:                                                                                      \
    return launch_wgmma<T, BITS, nt, nwg>(x, codes, scale, out, ws, M, K, N, group, gps,      \
                                          n_groups, splits, st);
    DSTPU_WQ_TILE(8, 1)
    DSTPU_WQ_TILE(16, 1)
    DSTPU_WQ_TILE(32, 1)
    DSTPU_WQ_TILE(64, 2)
    DSTPU_WQ_TILE(128, 2)
#undef DSTPU_WQ_TILE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out [M, N] = x [M, K] @ dequant(codes, scale).  dtype: 0 fp32, 1 bf16,
// 2 fp16 (x and out); bits 8 (codes int8 [Kp, N]) or 4 (packed uint8
// [Kp/2, N]); scale fp32 [n_groups, N]; any group (even for bits 4), Kp =
// n_groups * group >= K.  wgmma = 1: the tensor-core kernel, tile_m tokens
// (8, 16, 32, 64 or 128) per block; it takes bf16/fp16 x, groups that are a
// multiple of 64, K % 8 == 0, N % 16 == 0 and 16-byte aligned x and codes.
// wgmma = 0: the FMA-pipe kernel, tile_m 16 or 64 rows, any layout (a group
// off its 32-row stage scales each code by its row's scale).  K is split
// into `splits` runs of `groups_per_split` groups; with splits > 1, ws is an
// fp32 [splits, M, N] workspace and a second kernel sums it into out.  All
// tensors contiguous.  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int dstpu_wq_matmul(const void* x, const void* codes, const void* scale, void* out,
                               void* ws, int dtype, int bits, int M, int K, int N, int group,
                               int n_groups, int splits, int groups_per_split, int tile_m,
                               int wgmma, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || group <= 0 || (bits == 4 && group % 2) || n_groups <= 0 ||
      (long long)n_groups * group < K || splits < 1 || groups_per_split < 1 ||
      (long long)splits * groups_per_split < n_groups || (splits > 1 && ws == nullptr) ||
      (bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  if (wgmma && (dtype == 0 || group % kWgK != 0 || K % 8 != 0 || N % 16 != 0 ||
                !aligned(x, 16) || !aligned(codes, 16)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  cudaError_t err;
  const int gps = groups_per_split;
  if (wgmma) {
    switch (dtype * 10 + bits) {
      case 18: err = launch_tiles<__nv_bfloat16, 8>(tile_m, x, codes, s, out, w, M, K, N, group,
                                                    gps, n_groups, splits, st); break;
      case 14: err = launch_tiles<__nv_bfloat16, 4>(tile_m, x, codes, s, out, w, M, K, N, group,
                                                    gps, n_groups, splits, st); break;
      case 28: err = launch_tiles<__half, 8>(tile_m, x, codes, s, out, w, M, K, N, group, gps,
                                             n_groups, splits, st); break;
      case 24: err = launch_tiles<__half, 4>(tile_m, x, codes, s, out, w, M, K, N, group, gps,
                                             n_groups, splits, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    // the FMA-pipe kernel: a group off its stage scales each code by its row's scale
    const bool rowscale = group % kBK != 0;
    switch (dtype * 100 + bits * 10 + (rowscale ? 1 : 0)) {
#define DSTPU_WQ_FMA(code, T, b, rs)                                                           \
  case code:                                                                                   \
    err = launch_fma<T, b, rs>(x, codes, s, out, w, M, K, N, group, gps, n_groups, splits,     \
                               tile_m, st);                                                    \
    break;
      DSTPU_WQ_FMA(80, float, 8, false)
      DSTPU_WQ_FMA(81, float, 8, true)
      DSTPU_WQ_FMA(40, float, 4, false)
      DSTPU_WQ_FMA(41, float, 4, true)
      DSTPU_WQ_FMA(180, __nv_bfloat16, 8, false)
      DSTPU_WQ_FMA(181, __nv_bfloat16, 8, true)
      DSTPU_WQ_FMA(140, __nv_bfloat16, 4, false)
      DSTPU_WQ_FMA(141, __nv_bfloat16, 4, true)
      DSTPU_WQ_FMA(280, __half, 8, false)
      DSTPU_WQ_FMA(281, __half, 8, true)
      DSTPU_WQ_FMA(240, __half, 4, false)
      DSTPU_WQ_FMA(241, __half, 4, true)
#undef DSTPU_WQ_FMA
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
