// Grouped (block-diagonal) expert matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/grouped_matmul.py
// :_gmm_kernel (via grouped_matmul): the three expert matmuls of every
// dropless MoE layer (moe/sharded_moe.py _expert_ffn_blocks), three launches
// per layer on every prefill, prefill-chunk and decode call.
//
// What it computes, for x [P, H] (rows sorted by expert and padded so that
// every block of block_rows rows belongs to one expert), stacked expert
// weights w [E, H, F] and block_expert [P / block_rows] int32:
//   out[r, :] = x[r, :] @ w[block_expert[r / block_rows]]
// with fp32 sums rounded once to x's type, as the TPU kernel computes
// x_f32 @ w_f32 per block.  Products of bf16 or fp16 operands are exact in
// fp32, so the tensor-core path differs from it in summation order only.
// An expert index outside [0, E) is clamped (the router never makes one).
//
// What bounds it on the H100, at Mixtral-8x7b's widths (H 4096, F 14336):
// decode (P = 1152: 16 assignments padded into 9 blocks of 128 rows, most
// of them zero) is bound by the bytes of the expert weights, ~7-8 distinct
// 117 MB matrices per call, ~0.28 ms at 3.35 TB/s; prefill of a 1024-token
// bucket (P = 3072) by the tensor cores, 361 GFLOP, 0.365 ms at 989 TFLOP/s.
//
// Design, bf16 and fp16: one block of 8 warps per 128 x 128 output tile
// (a warp owns 64 x 32), or of 4 warps per 16 x 64 tile when block_rows is
// under 128.  A tile never spans two row blocks, so it reads its expert's
// index once (the TPU kernel's scalar prefetch); rows past the block's end
// are masked.  Row tiles run fastest in the grid, so the tiles of one column
// slab, which share each expert's weight columns, are resident together and
// meet those columns in L2.  K is walked in stages of 64 through a 3-stage
// cp.async ring (16-byte copies, zero-filled past the edges) in dynamic
// shared memory, 108 KB a block, two blocks an SM (registers capped at 128 a
// thread for that: uncapped, the compiler took 134 and only one fitted);
// mma.sync m16n8k16 with fp32 accumulators, A fragments by ldmatrix, B by
// ldmatrix.trans from the row-major [k][n] weight tile.  Ragged or unaligned
// H or F take per-element loads into the same ring.
// Not yet: wgmma, TMA, skipping all-padding blocks, sharing an expert's tiles
// across its consecutive blocks (later work, ROADMAP Queue 2 #1).
//
// Design, fp32 (tests and references): a 64 x 64 (or 16 x 64) tile on the
// fp32 FMA pipes out of shared memory, 16 x 16 threads, so fp32 stays fp32
// end to end (no TF32).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
};
__device__ __forceinline__ TileRows tile_rows(const int* __restrict__ block_expert, int P, int E,
                                              int block_rows, int tiles_per_block, int bm) {
  const int blk = blockIdx.x / tiles_per_block;
  TileRows t;
  t.m0 = blk * block_rows + (blockIdx.x % tiles_per_block) * bm;
  t.m_end = min(min(t.m0 + bm, (blk + 1) * block_rows), P);
  const int e = __ldg(block_expert + blk);
  t.e = e < 0 ? 0 : (e >= E ? E - 1 : e);
  return t;
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16, fp16)
// ---------------------------------------------------------------------------
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 2)
gmm_mma_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
               const int* __restrict__ block_expert, uint16_t* __restrict__ out, int P, int H,
               int F, int E, int block_rows, int tiles_per_block, int x_vec, int w_vec) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's tile
  constexpr int MT = WM / 16, NT = WN / 8;             // its m16 and n8 pieces
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  constexpr int XS = kBK + 8;                          // padded rows: conflict-free ldmatrix
  constexpr int WS = BN + 8;
  constexpr int X_ELEMS = BM * XS, W_ELEMS = kBK * WS;
  constexpr int XCHUNKS = BM * kBK / 8, WCHUNKS = kBK * BN / 8;  // 16-byte chunks per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sx = reinterpret_cast<uint16_t*>(smem_raw);  // [kStages][BM][XS]
  uint16_t* sw = sx + kStages * X_ELEMS;                  // [kStages][kBK][WS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr0 = (warp / WARPS_N) * WM;
  const int wc0 = (warp % WARPS_N) * WN;
  const TileRows tr = tile_rows(block_expert, P, E, block_rows, tiles_per_block, BM);
  const int n0 = blockIdx.y * BN;
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
      for (int j2 = 0; j2 < NT / 2; ++j2)
        ldmatrix_x4_trans(b[j2], bw + (kk + (lane & 15)) * WS + wc0 + j2 * 16 + (lane >> 4) * 8);
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
template <int BM>
__global__ void __launch_bounds__(256)
gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ block_expert, float* __restrict__ out, int P, int H, int F,
               int E, int block_rows, int tiles_per_block) {
  constexpr int BN = 64;
  constexpr int TM = BM / 16;                      // rows per thread
  constexpr int XS = BM + 4;                       // padded rows of the transposed x tile
  constexpr int XE = (BM * kBKF + 255) / 256;       // x elements per thread per stage
  __shared__ __align__(16) float sx[2][kBKF][XS];   // [k][m]
  __shared__ __align__(16) float sw[2][kBKF][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4 .. +3
  const int ty = tid >> 4;  // rows ty*TM .. +TM-1
  const TileRows tr = tile_rows(block_expert, P, E, block_rows, tiles_per_block, BM);
  const int n0 = blockIdx.y * BN;
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
    const int k = k0 + w_row;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + w_col + j;
      wr[j] = (k < H && n < F) ? __ldg(we + (long long)k * F + n) : 0.f;
    }
  };
  auto store_stage = [&](int buf) {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int idx = tid + e * 256;
      if (idx < BM * kBKF) sx[buf][idx % kBKF][idx / kBKF] = xr[e];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sw[buf][w_row][w_col + j] = wr[j];
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16u == 0; }

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
cudaError_t launch_mma(const void* x, const void* w, const int* be, void* out, int P, int H,
                       int F, int E, int block_rows, cudaStream_t st) {
  constexpr int XS = kBK + 8, WS = BN + 8;
  constexpr int SMEM = kStages * (BM * XS + kBK * WS) * 2;
  auto kern = gmm_mma_kernel<T, BM, BN, WARPS_M, WARPS_N>;
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
  const int w_vec = (F % 8 == 0) && aligned16(w);
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  kern<<<grid, WARPS_M * WARPS_N * 32, SMEM, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), be,
      static_cast<uint16_t*>(out), P, H, F, E, block_rows, tiles_per_block, x_vec, w_vec);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_fma(const void* x, const void* w, const int* be, void* out, int P, int H,
                       int F, int E, int block_rows, cudaStream_t st) {
  const int tiles_per_block = (block_rows + BM - 1) / BM;
  const long long row_tiles = (long long)(P / block_rows) * tiles_per_block;
  const int col_tiles = (F + 63) / 64;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  gmm_fma_kernel<BM><<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                            static_cast<const float*>(w), be,
                                            static_cast<float*>(out), P, H, F, E, block_rows,
                                            tiles_per_block);
  return cudaGetLastError();
}

}  // namespace

// out [P, F] = x [P, H] @ w[block_expert[r / block_rows]] for every row r.
// dtype: 0 fp32, 1 bf16, 2 fp16 (x, w and out); w [E, H, F]; block_expert
// [P / block_rows] int32; P a multiple of block_rows.  big_tile 1 takes the
// 128-row tile (bf16/fp16; 64 rows in fp32), 0 the 16-row one.  All tensors
// contiguous.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dstpu_grouped_matmul(const void* x, const void* w, const void* block_expert,
                                    void* out, int dtype, int P, int H, int F, int E,
                                    int block_rows, int big_tile, void* stream) {
  if (P < 0 || H <= 0 || F <= 0 || E <= 0 || block_rows <= 0 || P % block_rows != 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  switch (dtype * 2 + (big_tile ? 1 : 0)) {
    case 0: return (int)launch_fma<16>(x, w, be, out, P, H, F, E, block_rows, st);
    case 1: return (int)launch_fma<64>(x, w, be, out, P, H, F, E, block_rows, st);
    case 2: return (int)launch_mma<__nv_bfloat16, 16, 64, 1, 4>(x, w, be, out, P, H, F, E,
                                                                 block_rows, st);
    case 3: return (int)launch_mma<__nv_bfloat16, 128, 128, 2, 4>(x, w, be, out, P, H, F, E,
                                                                   block_rows, st);
    case 4: return (int)launch_mma<__half, 16, 64, 1, 4>(x, w, be, out, P, H, F, E, block_rows,
                                                          st);
    case 5: return (int)launch_mma<__half, 128, 128, 2, 4>(x, w, be, out, P, H, F, E,
                                                            block_rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
