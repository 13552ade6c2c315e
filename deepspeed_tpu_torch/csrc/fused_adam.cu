// Fused Adam / AdamW for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/fused_adam.py
// :_adam_kernel (via fused_adam_update), which the fused-kernel optimizer
// (runtime/optimizers.py pallas_fused_adam) calls once per parameter leaf.
//
// What it computes, per element of one flat leaf of n elements (any n):
//   g  += wd * p                          (Adam mode, wd != 0: L2 into the grad)
//   m   = b1 * m + (1 - b1) * g
//   v   = b2 * v + (1 - b2) * g * g
//   u   = (m / bc1) / (sqrt(v / bc2) + eps)   bc = 1 - exp(step * log(beta))
//         or m / (sqrt(v) + eps) without bias correction
//   u  += wd * p                          (AdamW mode, wd != 0: decoupled decay)
//   p  -= lr * u
// in fp32, with p, v fp32 and m fp32 or bf16 (the optimizer's mu_dtype; the
// update reads the fp32 m before it is rounded for storage).  p, m and v are
// updated IN PLACE (the TPU kernel returns new arrays).  step (1-based) and
// lr are read from a two-float device tensor, as the TPU kernel reads them
// from SMEM, so a schedule's lr never enters the launch and no value crosses
// to the host.  The bias correction keeps the TPU kernel's exp/log form; the
// constants (1 - beta) and log(beta) are computed in double on the host and
// rounded once, as the JAX kernel's Python floats are.
//
// What bounds it on the H100: memory.  Each element reads p, g, m, v and
// writes p, m, v: 28 bytes with an fp32 m (24 with bf16) for ~20 flops, far
// below the ~20 flop/byte ridge of the fp32 pipes; the 65.5M-element
// embedding of llama-1b moves 1.83 GB, 0.55 ms at 3.35 TB/s.
//
// Design: one grid-stride pass, each thread takes four consecutive elements
// with 16-byte loads and stores (8-byte for a bf16 m) when every pointer is
// aligned for it, then the ragged tail one element at a time; otherwise the
// scalar loop throughout.  The grid is capped so that each thread walks
// several vectors (enough blocks in flight to cover the memory latency, no
// tail of tiny blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Hyper {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay;
  float log_beta1, log_beta2;
  int adam_w_mode, bias_correction;
};

struct Step {
  float lr, bc1, bc2;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, const Hyper& h,
                                          const Step& s) {
  if (h.weight_decay != 0.f && !h.adam_w_mode) g = g + h.weight_decay * p;
  m = h.beta1 * m + h.one_minus_beta1 * g;
  v = h.beta2 * v + h.one_minus_beta2 * g * g;
  float u = h.bias_correction ? (m / s.bc1) / (sqrtf(v / s.bc2) + h.eps)
                              : m / (sqrtf(v) + h.eps);
  if (h.weight_decay != 0.f && h.adam_w_mode) u = u + h.weight_decay * p;
  p = p - s.lr * u;
}

__device__ __forceinline__ float m_load(const float* m, long long i) { return m[i]; }
__device__ __forceinline__ float m_load(const __nv_bfloat16* m, long long i) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ void m_store(float* m, long long i, float x) { m[i] = x; }
__device__ __forceinline__ void m_store(__nv_bfloat16* m, long long i, float x) {
  m[i] = __float2bfloat16_rn(x);
}

// four consecutive moments: one 16-byte (fp32) or 8-byte (bf16) access
__device__ __forceinline__ float4 m_load4(const float* m, long long i4) {
  return reinterpret_cast<const float4*>(m)[i4];
}
__device__ __forceinline__ float4 m_load4(const __nv_bfloat16* m, long long i4) {
  const uint2 raw = reinterpret_cast<const uint2*>(m)[i4];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void m_store4(float* m, long long i4, float4 x) {
  reinterpret_cast<float4*>(m)[i4] = x;
}
__device__ __forceinline__ void m_store4(__nv_bfloat16* m, long long i4, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  reinterpret_cast<uint2*>(m)[i4] = raw;
}

template <typename M, bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g, M* __restrict__ m,
                  float* __restrict__ v, const float* __restrict__ scalars, long long n,
                  Hyper h) {
  Step s;
  const float step = scalars[0];
  s.lr = scalars[1];
  s.bc1 = 1.f;
  s.bc2 = 1.f;
  if (h.bias_correction) {
    s.bc1 = 1.f - expf(step * h.log_beta1);
    s.bc2 = 1.f - expf(step * h.log_beta2);
  }
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long i = first; i < n4; i += stride) {
      float4 pv = reinterpret_cast<const float4*>(p)[i];
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      float4 mv = m_load4(m, i);
      float4 vv = reinterpret_cast<const float4*>(v)[i];
      adam_elem(pv.x, gv.x, mv.x, vv.x, h, s);
      adam_elem(pv.y, gv.y, mv.y, vv.y, h, s);
      adam_elem(pv.z, gv.z, mv.z, vv.z, h, s);
      adam_elem(pv.w, gv.w, mv.w, vv.w, h, s);
      reinterpret_cast<float4*>(p)[i] = pv;
      m_store4(m, i, mv);
      reinterpret_cast<float4*>(v)[i] = vv;
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    float pe = p[i], me = m_load(m, i), ve = v[i];
    adam_elem(pe, g[i], me, ve, h, s);
    p[i] = pe;
    m_store(m, i, me);
    v[i] = ve;
  }
}

template <typename M>
cudaError_t launch(float* p, const float* g, M* m, float* v, const float* scalars, long long n,
                   int vec, const Hyper& h, cudaStream_t stream) {
  const long long work = vec ? (n + 3) / 4 : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
  if (vec)
    fused_adam_kernel<M, true><<<blocks, kThreads, 0, stream>>>(p, g, m, v, scalars, n, h);
  else
    fused_adam_kernel<M, false><<<blocks, kThreads, 0, stream>>>(p, g, m, v, scalars, n, h);
  return cudaGetLastError();
}

}  // namespace

// One Adam/AdamW step over a flat leaf of n elements, in place.  p, g, v fp32;
// m fp32 (m_dtype 0) or bf16 (m_dtype 1); scalars = {step (1-based), lr} fp32
// on the device.  vec = 1 only when p, g, v (and m, for fp32) are 16-byte
// aligned and a bf16 m is 8-byte aligned.  The (1 - beta) and log(beta)
// constants come from the caller, rounded from double.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dstpu_fused_adam(void* p, const void* g, void* m, void* v, const void* scalars,
                                long long n, int m_dtype, int vec, float beta1,
                                float one_minus_beta1, float beta2, float one_minus_beta2,
                                float eps, float weight_decay, float log_beta1, float log_beta2,
                                int adam_w_mode, int bias_correction, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Hyper h{beta1,  one_minus_beta1, beta2,     one_minus_beta2, eps,
                weight_decay, log_beta1, log_beta2, adam_w_mode,     bias_correction};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* vf = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scalars);
  switch (m_dtype) {
    case 0:
      return (int)launch<float>(pf, gf, static_cast<float*>(m), vf, sc, n, vec, h, st);
    case 1:
      return (int)launch<__nv_bfloat16>(pf, gf, static_cast<__nv_bfloat16*>(m), vf, sc, n, vec,
                                        h, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
