// Block-wise symmetric int8 quantization for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/pallas/quantization.py
// :_quant_kernel (via quantize_int8) and :_dequant_kernel (via
// dequantize_int8): the codec of InferenceEngine.module_quantize (every
// stacked leaf of two or more dimensions is quantized and dequantized in
// place) and of the int8 base of linear/optimized_linear.py.
//
// What they compute, on a flat tensor of n elements viewed as rows of 128
// (zero-padded to a whole row):
//   quantize:   scale[r] = max(max_i |x[r, i]|, 1e-12) * (1/127)
//               q[r, i]  = clip(rint(x[r, i] / scale[r]), -127, 127)   (int8)
//   dequantize: y[i]     = (float(q[i]) * scale[i / 128]) in the output type
// in fp32.  The scale is a product with the fp32 constant 1/127, because
// XLA compiles the TPU kernel's division by the literal 127 into that
// product; x / scale is an IEEE division (no reciprocal: the build has no
// fast-math), and rintf rounds ties to even, as jnp.round.  Codes, scales
// and dequantized values are bit-equal to the plain version.
//
// What bounds them on the H100: memory.  Quantize reads n elements and
// writes n bytes plus 4 bytes a row; dequantize the reverse.  A few flops
// per byte, far below any ridge: llama-1b's 65.5M-element bf16 embedding
// is 197 MB each way, 59 us at 3.35 TB/s.
//
// Design: one warp per 128-wide row (the TPU kernel's block row), 4
// consecutive elements a lane with one 8- or 16-byte access where the row is
// whole and aligned, the row's absmax by a shuffle reduction; 8 rows per
// 256-thread block.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f(float v, __half* p) { *p = __float2half_rn(v); }

// four consecutive elements in one access (8 bytes for 16-bit types, 16 for fp32)
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };
template <> struct Vec4<__half> { using type = uint2; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                     long long n, long long rows, int vec) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long base = row * kRow + lane * 4;
  alignas(16) T e[4];
  if (vec && row * kRow + kRow <= n) {
    *reinterpret_cast<typename Vec4<T>::type*>(e) =
        *reinterpret_cast<const typename Vec4<T>::type*>(x + base);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) from_f(0.f, &e[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < n) e[j] = x[base + j];
  }
  float v[4];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = to_f(e[j]);
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-12f) * (1.0f / 127.0f);
  char4 c;
  c.x = static_cast<signed char>(fminf(fmaxf(rintf(v[0] / scale), -127.f), 127.f));
  c.y = static_cast<signed char>(fminf(fmaxf(rintf(v[1] / scale), -127.f), 127.f));
  c.z = static_cast<signed char>(fminf(fmaxf(rintf(v[2] / scale), -127.f), 127.f));
  c.w = static_cast<signed char>(fminf(fmaxf(rintf(v[3] / scale), -127.f), 127.f));
  *reinterpret_cast<char4*>(q + base) = c;
  if (lane == 0) s[row] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                       T* __restrict__ out, long long n, long long rows, int vec) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long base = row * kRow + lane * 4;
  const float scale = s[row];
  const char4 c = *reinterpret_cast<const char4*>(q + base);
  alignas(16) T e[4];
  from_f(static_cast<float>(c.x) * scale, &e[0]);
  from_f(static_cast<float>(c.y) * scale, &e[1]);
  from_f(static_cast<float>(c.z) * scale, &e[2]);
  from_f(static_cast<float>(c.w) * scale, &e[3]);
  if (vec && base + 4 <= n) {
    *reinterpret_cast<typename Vec4<T>::type*>(out + base) =
        *reinterpret_cast<const typename Vec4<T>::type*>(e);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < n) out[base + j] = e[j];
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

template <typename T>
cudaError_t launch_quant(const void* x, void* q, void* s, long long n, cudaStream_t st) {
  const long long rows = (n + kRow - 1) / kRow;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int vec = aligned(x, 4 * sizeof(T));
  quantize_int8_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), n, rows, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequant(const void* q, const void* s, void* out, long long n,
                           cudaStream_t st) {
  const long long rows = (n + kRow - 1) / kRow;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int vec = aligned(out, 4 * sizeof(T));
  dequantize_int8_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<T*>(out), n,
      rows, vec);
  return cudaGetLastError();
}

}  // namespace

// x: n contiguous elements (dtype 0 fp32, 1 bf16, 2 fp16) -> q int8
// [ceil(n/128), 128] (4-byte aligned) and s fp32 [ceil(n/128)].  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dstpu_quantize_int8(const void* x, void* q, void* s, long long n, int dtype,
                                   void* stream) {
  if (n < 0 || !aligned(q, 4)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_quant<float>(x, q, s, n, st);
    case 1: return (int)launch_quant<__nv_bfloat16>(x, q, s, n, st);
    case 2: return (int)launch_quant<__half>(x, q, s, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q int8 [>= ceil(n/128), 128] (4-byte aligned), s fp32 [>= ceil(n/128)] ->
// the first n values in dtype (0 fp32, 1 bf16, 2 fp16).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dstpu_dequantize_int8(const void* q, const void* s, void* out, long long n,
                                     int dtype, void* stream) {
  if (n < 0 || !aligned(q, 4)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dequant<float>(q, s, out, n, st);
    case 1: return (int)launch_dequant<__nv_bfloat16>(q, s, out, n, st);
    case 2: return (int)launch_dequant<__half>(q, s, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
