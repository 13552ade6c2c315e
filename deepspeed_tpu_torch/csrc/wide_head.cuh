// The runtime-head-dim path of the attention kernels (flash forward A, flash
// backward A' and A'', block-sparse S): building blocks for heads past the
// widest compile-time instantiation (256).  The JAX kernels take any head
// dim, because a Pallas block spans the whole head; here D is an argument,
// so one build covers every width.
//
// A block of 16 x 16 threads owns a 64-row tile; each thread a 4-row x
// 4-column patch of a 64 x 64 score tile (rows ty * 4 .., columns tx + 16 j).
// A score tile sums over the whole head dim in chunks of 32 columns staged
// as fp32 in shared memory; each block writes one part of at most 128
// output columns (a grid axis over the parts), so the registers and shared
// memory a block needs do not grow with D.  Everything runs on the FMA
// pipes in fp32, from inputs of any of the three types: no public model has
// such a head, so this path is simple rather than fast.
//
// Included by csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu and
// csrc/sparse_attention.cu; each is its own library, so everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWideRows = 64;      // query and key tile
constexpr int kWideThreads = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int kWideChunk = 32;     // head-dim columns per staged chunk
constexpr int kWideLd = kWideChunk + 1;   // padded chunk row: conflict-free column reads
constexpr int kWidePart = 128;     // output columns per block
constexpr int kWidePd = kWideRows + 1;    // padded row of a 64 x 64 probability tile

__device__ __forceinline__ float wide_f(float x) { return x; }
__device__ __forceinline__ float wide_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float wide_f(__half x) { return __half2float(x); }
__device__ __forceinline__ void wide_put(float* p, float x) { *p = x; }
__device__ __forceinline__ void wide_put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void wide_put(__half* p, float x) { *p = __float2half_rn(x); }

// rows [r0, r0 + 64) x columns [c0, c0 + w) of one head (rows rs elements
// apart, columns contiguous) as fp32 into dst [64][ld]; rows at or past n
// and columns at or past D are zeros.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void wide_stage(float* dst, int ld, int w, const T* src, long long rs,
                                           int r0, int n, int c0, int D) {
  for (int i = threadIdx.x; i < kWideRows * w; i += kWideThreads) {
    const int r = i / w, c = i % w;
    const int row = r0 + r, col = c0 + c;
    dst[r * ld + c] = row < n && col < D ? wide_f(src[(long long)row * rs + col]) : 0.f;
  }
}

// acc[r][j] += a[ar0 + ty * 4 + r] . b[br0 + tx + 16 j] over the whole head
// dim D, for rows of a and b rs elements apart (rows at or past an / bn are
// zeros), staged kWideChunk columns at a time through As and Bs [64][kWideLd].
// Every thread of the block calls it; it synchronises the block.
template <typename T>
__device__ void wide_dot(float (&acc)[4][4], float* As, float* Bs, const T* a, long long ars,
                         int ar0, int an, const T* b, long long brs, int br0, int bn, int D) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int c0 = 0; c0 < D; c0 += kWideChunk) {
    __syncthreads();  // the previous chunk's readers are done
    wide_stage(As, kWideLd, kWideChunk, a, ars, ar0, an, c0, D);
    wide_stage(Bs, kWideLd, kWideChunk, b, brs, br0, bn, c0, D);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kWideChunk; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[(ty * 4 + r) * kWideLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * kWideLd + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
    }
  }
}

// acc[r][c] += sum_k P[ty * 4 + r][k] V[k][tx + 16 c] over a 64-key tile:
// P [64][kWidePd], V [64][kWidePart] (this block's part of the columns)
__device__ __forceinline__ void wide_pv(float (&acc)[4][8], const float* P, const float* V) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < kWideRows; ++k) {
    float pv[4], vv[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = P[(ty * 4 + r) * kWidePd + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) vv[c] = V[k * kWidePart + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
  }
}

// shared memory of the forward kernels: As, Bs, P, V
constexpr size_t wide_fwd_smem() {
  return sizeof(float) * (2 * kWideRows * kWideLd + kWideRows * kWidePd + kWideRows * kWidePart);
}

}  // namespace
