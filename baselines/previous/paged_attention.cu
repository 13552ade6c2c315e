// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py
// :_decode_kernel (via paged_decode_attention), the attention of the paged
// decode program: one query token per sequence attends over that sequence's
// KV pages in place, through its page table.
//
// What it computes, for sequence b and query head h = kvh * G + g:
//   s[slot] = (q[h] * scale) . k[page_table[b, slot / ps], slot % ps, kvh]
//             - slope[h] * (positions[b] - slot)                   (ALiBi)
//   masked  : slot > positions[b]  ->  s = -1e30
//   out[h]  = sum softmax(s)[slot] v[...]            (online softmax, fp32)
// With int8 pools, k and v are codes times the fp32 scale of their
// (page, slot, kv head): the K scale multiplies the code dot product, the V
// scale the probability, both in fp32.
//
// Design (flash-decoding).  Each sequence's pages are split into runs of
// pages_per_split pages; one block of up to 8 warps takes one run of one
// (b, kv head), holding that head's G = NH / KVH query rows, so every K/V
// byte of the head is read once for the whole GQA group.  The block reads
// its own page indices from the table and visits pages up to
// positions[b] / ps only: pages past the position (trash or stale) are never
// loaded, so garbage there, NaN included, cannot reach the output — the TPU
// kernel visits all MP pages and masks them instead; blocks whose run starts
// past the position exit at once.  Warp w of a block takes pages w, w + W,
// ... of its run.  Each page's K and V rows of this head are copied into the
// warp's shared memory with 16-byte cp.async copies, double-buffered (the
// next page is in flight while the current one is scored), scored as G x ps
// (row, slot) dot products with 16-byte vector reads, and folded into the
// warp's running (m, l, acc) per row.  Slots past the position inside the
// last page are copied but never read.  The warps' states merge in the
// block; with one run per sequence the block writes the output, otherwise
// it writes its (m, l, acc) and a second kernel merges the runs.
//
// Head dims: the kernel runs at D rounded up to a multiple of 16 (32 past
// 128) and reads the pools at their own width Dt: a chunk of a row that lies
// wholly inside Dt and is 16-byte aligned is a cp.async copy, the rest of a
// row (the tail of D = 72, every chunk of an odd D) is loaded element by
// element with zeros past Dt, so q . k is unchanged, the extra output
// columns are not stored, and the cache is read in place at its own width.
//
// Head dims past 256: the runtime-head-dim kernel below, the same split of
// the pages with the output columns in parts of 128 over a grid axis, the
// pages read from device memory as they are (no staging), fp32 throughout.
//
// What bounds it on the H100: bytes.  Decode at B = 8 x 1024 tokens reads
// 16.8 MB of bf16 KV per layer and does ~2 FLOP per byte, so the least time
// is the KV traffic over 3.35 TB/s (~5 us).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemBudget = 200 * 1024;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// the raw bits of one KT, for copies that zero-fill past the head dim
template <int N> struct RawOf;
template <> struct RawOf<1> { using T = uint8_t; };
template <> struct RawOf<2> { using T = uint16_t; };
template <> struct RawOf<4> { using T = uint32_t; };

// 16 bytes of KT from shared memory as floats.
template <typename KT> struct Vec {
  static constexpr int N = 16 / sizeof(KT);
  __device__ __forceinline__ static void load(const KT* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) & ~size_t(15); }

// Per-warp shared memory, in bytes, each part 16-byte aligned:
//   kbuf[2][ps][D + pad] KT (rows padded by 16 bytes: conflict-free vector
//   reads across slots) | vbuf[2][ps][D] KT | sc[G][ps] | ms, ls, al [G] |
//   acc[G][D] (fp32).
struct WarpLayout {
  size_t krow, kbuf, vbuf, sc, stats, acc, total;
  __host__ __device__ WarpLayout(int G, int D, int ps, int kt_size) {
    krow = (size_t)D * kt_size + 16;
    kbuf = 0;
    vbuf = kbuf + up16(2 * ps * krow);
    sc = vbuf + up16((size_t)2 * ps * D * kt_size);
    stats = sc + up16((size_t)G * ps * 4);
    acc = stats + up16((size_t)3 * G * 4);
    total = acc + up16((size_t)G * D * 4);
  }
};

// T: q/out dtype; KT: pool dtype (T, or int8_t with fp32 scales).
template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ page_table,
                    const int* __restrict__ positions, const float* __restrict__ slopes,
                    T* __restrict__ out, float* __restrict__ part, int NH, int KVH, int Dt,
                    int ps, int MP, int pages_per_split, float scale) {
  constexpr int VN = Vec<KT>::N;       // elements per 16-byte copy
  constexpr int VPR = D / VN;          // copies per K/V row
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = NH / KVH;
  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const int pos = positions[b];
  const int n_pages = min(pos / ps + 1, MP);
  // this block's pages: [p0, p1) of the sequence's table
  const int p0 = blockIdx.y * pages_per_split;
  const int p1 = min(p0 + pages_per_split, n_pages);
  // partial state of this (b, kv head, split): [G][D acc | m | l]
  float* pb = part == nullptr ? nullptr
                              : part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * G * (D + 2);
  if (p0 >= p1) {  // the sequence ends before this run: an empty partial
    if (pb != nullptr)
      for (int idx = threadIdx.x; idx < G * (D + 2); idx += blockDim.x)
        pb[idx] = idx % (D + 2) == D ? kNegInf : 0.f;
    return;
  }
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const WarpLayout L(G, D, ps, sizeof(KT));
  const size_t krow = L.krow / sizeof(KT);  // padded row, in elements

  float* qs = reinterpret_cast<float*>(smem);                          // [G][D]
  unsigned char* wbase = smem + up16((size_t)G * D * 4) + warp * L.total;
  KT* kbuf = reinterpret_cast<KT*>(wbase + L.kbuf);
  KT* vbuf = reinterpret_cast<KT*>(wbase + L.vbuf);
  float* sc = reinterpret_cast<float*>(wbase + L.sc);
  float* ms = reinterpret_cast<float*>(wbase + L.stats);
  float* ls = ms + G;
  float* al = ls + G;
  float* acc = reinterpret_cast<float*>(wbase + L.acc);

  const T* qb = q + ((long long)b * NH + (long long)kvh * G) * Dt;
  for (int idx = tid; idx < G * D; idx += blockDim.x)
    qs[idx] = idx % D < Dt ? to_f(qb[(idx / D) * Dt + idx % D]) * scale : 0.f;
  for (int idx = lane; idx < G * D; idx += 32) acc[idx] = 0.f;
  for (int g = lane; g < G; g += 32) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  __syncthreads();

  const int* table = page_table + (long long)b * MP;
  const long long row_stride = (long long)KVH * Dt;  // between slots of a page

  // copy page jp's K/V rows of this head into buffer buf (one commit group)
  auto fetch = [&](int buf, int jp) {
    const long long slot0 = (long long)table[jp] * ps;
    KT* kd = kbuf + (size_t)buf * ps * krow;
    KT* vd = vbuf + (size_t)buf * ps * D;
    for (int i = lane; i < ps * VPR; i += 32) {
      const int s = i / VPR, c = (i % VPR) * VN;
      const long long off = (slot0 + s) * row_stride + (long long)kvh * Dt + c;
      const KT* ks = k_pool + off;
      const KT* vs = v_pool + off;
      if (c + VN <= Dt &&
          ((reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)) & 15) == 0) {
        cp_async16(kd + s * krow + c, ks);
        cp_async16(vd + s * D + c, vs);
      } else {  // the row's tail past Dt (or an unaligned row): zeros there
        using R = typename RawOf<sizeof(KT)>::T;
        R* kr = reinterpret_cast<R*>(kd + s * krow + c);
        R* vr = reinterpret_cast<R*>(vd + s * D + c);
#pragma unroll
        for (int j = 0; j < VN; ++j) {
          kr[j] = c + j < Dt ? reinterpret_cast<const R*>(ks)[j] : R(0);
          vr[j] = c + j < Dt ? reinterpret_cast<const R*>(vs)[j] : R(0);
        }
      }
    }
    cp_async_commit();
  };

  if (p0 + warp < p1) fetch(0, p0 + warp);
  int it = 0;
  for (int jp = p0 + warp; jp < p1; jp += n_warps, ++it) {
    const int cur = it & 1;
    if (jp + n_warps < p1) {
      fetch(cur ^ 1, jp + n_warps);
      cp_async_wait<1>();  // the current page has landed; the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const KT* kc = kbuf + (size_t)cur * ps * krow;
    const KT* vc = vbuf + (size_t)cur * ps * D;
    const long long slot0 = (long long)table[jp] * ps;
    const int n_valid = min(ps, pos - jp * ps + 1);  // live slots of this page

    for (int pair = lane; pair < G * ps; pair += 32) {
      const int g = pair / ps, s = pair % ps;
      float dot = kNegInf;
      if (s < n_valid) {
        const float* qr = qs + g * D;
        const KT* kr = kc + s * krow;
        dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += VN) {
          float kv[VN];
          Vec<KT>::load(kr + c, kv);
#pragma unroll
          for (int j = 0; j < VN; ++j) dot = fmaf(qr[c + j], kv[j], dot);
        }
        if (k_scale != nullptr) dot *= k_scale[(slot0 + s) * KVH + kvh];
        if (slopes != nullptr) dot -= slopes[kvh * G + g] * (float)(pos - (jp * ps + s));
      }
      sc[pair] = dot;
    }
    __syncwarp();

    for (int g = 0; g < G; ++g) {
      float mt = kNegInf;
      for (int s = lane; s < n_valid; s += 32) mt = fmaxf(mt, sc[g * ps + s]);
      mt = warp_max(mt);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mt);
      float psum = 0.f;
      for (int s = lane; s < n_valid; s += 32) {
        const float p = expf(sc[g * ps + s] - m_new);
        psum += p;
        // the V scale rides on the probability (l keeps the unscaled sum)
        sc[g * ps + s] = v_scale != nullptr ? p * v_scale[(slot0 + s) * KVH + kvh] : p;
      }
      psum = warp_sum(psum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + psum;
        ms[g] = m_new;
      }
      __syncwarp();
    }

    for (int idx = lane; idx < G * D; idx += 32) {
      const int g = idx / D, d = idx % D;
      const float* pr = sc + g * ps;
      float a = acc[idx] * al[g];
      for (int s = 0; s < n_valid; ++s) a = fmaf(pr[s], to_f(vc[s * D + d]), a);
      acc[idx] = a;
    }
    __syncwarp();  // this buffer is refilled two pages on
  }
  __syncthreads();

  // merge the warps' partial softmax states: into the output, or into
  // this split's partial for paged_merge_kernel
  T* ob = out + ((long long)b * NH + (long long)kvh * G) * Dt;
  const unsigned char* w0 = smem + up16((size_t)G * D * 4);
  for (int idx = tid; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    float m = kNegInf;
    for (int w = 0; w < n_warps; ++w)
      m = fmaxf(m, reinterpret_cast<const float*>(w0 + w * L.total + L.stats)[g]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float* wms = reinterpret_cast<const float*>(w0 + w * L.total + L.stats);
      const float* wacc = reinterpret_cast<const float*>(w0 + w * L.total + L.acc);
      const float f = expf(wms[g] - m);
      l += wms[G + g] * f;
      a += wacc[idx] * f;
    }
    if (pb == nullptr) {
      if (idx % D < Dt) ob[g * Dt + idx % D] = from_f<T>(a / fmaxf(l, 1e-30f));
    } else {
      float* pg = pb + g * (D + 2);
      pg[idx % D] = a;
      if (idx % D == 0) {
        pg[D] = m;
        pg[D + 1] = l;
      }
    }
  }
}

// Merge the splits of each (b, kv head): out = sum_s e^(m_s - m) acc_s /
// sum_s e^(m_s - m) l_s, with m the largest m_s.
template <typename T, int D>
__global__ void paged_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                                   int NH, int KVH, int Dt, int n_split) {
  const int G = NH / KVH;
  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const float* pb = part + (size_t)blockIdx.x * n_split * G * (D + 2);
  T* ob = out + ((long long)b * NH + (long long)kvh * G) * Dt;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    if (d >= Dt) continue;
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, pb[(s * G + g) * (D + 2) + D]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps_ = pb + (s * G + g) * (D + 2);
      const float f = expf(ps_[D] - m);
      l += ps_[D + 1] * f;
      a += ps_[d] * f;
    }
    ob[g * Dt + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// runtime head dim (past 256)
// ---------------------------------------------------------------------------
// One block of 8 warps per (b, kv head, run of pages, part of at most 128
// output columns), the GQA group's G query rows together.  For each page:
// the (row, slot) dot products over the whole head, one per warp at a time
// with the lanes striding D, from the query and the page in device memory;
// the online softmax per row; then acc += p v for the part's columns.  The
// scores and the softmax state are the same in every part (each part
// recomputes them); the part's columns go to the output, or to the run's
// partial for paged_merge_wide_kernel, part 0 writing m and l.
constexpr int kWidePart = 128;
constexpr int kWideWarps = 8;

template <typename T, typename KT>
__global__ void __launch_bounds__(kWideWarps * 32)
paged_decode_wide_kernel(const T* __restrict__ q, const KT* __restrict__ k_pool,
                         const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, const int* __restrict__ page_table,
                         const int* __restrict__ positions, const float* __restrict__ slopes,
                         T* __restrict__ out, float* __restrict__ part, int NH, int KVH, int D,
                         int ps, int MP, int pages_per_split, float scale) {
  extern __shared__ float wsm[];
  const int G = NH / KVH;
  float* sc = wsm;           // [G][ps]: scores, then probabilities
  float* acc = sc + G * ps;  // [G][kWidePart]
  float* ms = acc + G * kWidePart;
  float* ls = ms + G;
  float* al = ls + G;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int c0 = blockIdx.z * kWidePart;
  const int pw = min(kWidePart, D - c0);  // this part's columns
  const int pos = positions[b];
  const int n_pages = min(pos / ps + 1, MP);
  const int p0 = blockIdx.y * pages_per_split;
  const int p1 = min(p0 + pages_per_split, n_pages);
  float* pb = part == nullptr ? nullptr
                              : part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * G * (D + 2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (p0 >= p1) {  // the sequence ends before this run: an empty partial
    if (pb != nullptr)
      for (int i = tid; i < G * pw; i += blockDim.x) {
        const int g = i / pw;
        pb[g * (D + 2) + c0 + i % pw] = 0.f;
        if (blockIdx.z == 0 && i % pw == 0) {
          pb[g * (D + 2) + D] = kNegInf;
          pb[g * (D + 2) + D + 1] = 0.f;
        }
      }
    return;
  }
  for (int i = tid; i < G * kWidePart; i += blockDim.x) acc[i] = 0.f;
  for (int g = tid; g < G; g += blockDim.x) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  const int* table = page_table + (long long)b * MP;
  const T* qb = q + ((long long)b * NH + (long long)kvh * G) * D;
  __syncthreads();

  for (int jp = p0; jp < p1; ++jp) {
    const long long slot0 = (long long)table[jp] * ps;
    const int n_valid = min(ps, pos - jp * ps + 1);  // live slots of this page
    for (int pair = warp; pair < G * n_valid; pair += kWideWarps) {
      const int g = pair / n_valid, s = pair % n_valid;
      const T* qr = qb + (long long)g * D;
      const KT* kr = k_pool + ((slot0 + s) * KVH + kvh) * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot = fmaf(to_f(qr[d]) * scale, to_f(kr[d]), dot);
      dot = warp_sum(dot);
      if (k_scale != nullptr) dot *= k_scale[(slot0 + s) * KVH + kvh];
      if (slopes != nullptr) dot -= slopes[kvh * G + g] * (float)(pos - (jp * ps + s));
      if (lane == 0) sc[g * ps + s] = dot;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWideWarps) {
      float mt = kNegInf;
      for (int s = lane; s < n_valid; s += 32) mt = fmaxf(mt, sc[g * ps + s]);
      mt = warp_max(mt);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mt);
      float psum = 0.f;
      for (int s = lane; s < n_valid; s += 32) {
        const float p = expf(sc[g * ps + s] - m_new);
        psum += p;
        // the V scale rides on the probability (l keeps the unscaled sum)
        sc[g * ps + s] = v_scale != nullptr ? p * v_scale[(slot0 + s) * KVH + kvh] : p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * pw; i += blockDim.x) {
      const int g = i / pw, c = c0 + i % pw;
      const float* pr = sc + g * ps;
      float a = acc[g * kWidePart + i % pw] * al[g];
      for (int s = 0; s < n_valid; ++s)
        a = fmaf(pr[s], to_f(v_pool[((slot0 + s) * KVH + kvh) * D + c]), a);
      acc[g * kWidePart + i % pw] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * NH + (long long)kvh * G) * D;
  for (int i = tid; i < G * pw; i += blockDim.x) {
    const int g = i / pw, c = c0 + i % pw;
    const float a = acc[g * kWidePart + i % pw];
    if (pb == nullptr) {
      ob[g * D + c] = from_f<T>(a / fmaxf(ls[g], 1e-30f));
    } else {
      pb[g * (D + 2) + c] = a;
      if (blockIdx.z == 0 && i % pw == 0) {
        pb[g * (D + 2) + D] = ms[g];
        pb[g * (D + 2) + D + 1] = ls[g];
      }
    }
  }
}

// paged_merge_kernel at a runtime head dim
template <typename T>
__global__ void paged_merge_wide_kernel(const float* __restrict__ part, T* __restrict__ out,
                                        int NH, int KVH, int D, int n_split) {
  const int G = NH / KVH;
  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const float* pb = part + (size_t)blockIdx.x * n_split * G * (D + 2);
  T* ob = out + ((long long)b * NH + (long long)kvh * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, pb[((size_t)s * G + g) * (D + 2) + D]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps_ = pb + ((size_t)s * G + g) * (D + 2);
      const float f = expf(ps_[D] - m);
      l += ps_[D + 1] * f;
      a += ps_[d] * f;
    }
    ob[g * D + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_table, *positions, *slopes;
  void *out, *part;
  int B, NH, KVH, Dt, ps, MP, pages_per_split;
  float scale;
};

template <typename T, typename KT, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.NH / a.KVH;
  const size_t per_warp = WarpLayout(G, D, a.ps, sizeof(KT)).total;
  const size_t head = up16((size_t)G * D * 4);
  int warps = min(kMaxWarps, a.pages_per_split);  // a warp per page at most
  while (warps > 1 && head + warps * per_warp > kSmemBudget) --warps;
  const size_t smem = head + warps * per_warp;
  if (smem > kSmemBudget) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, KT, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_split = (a.MP + a.pages_per_split - 1) / a.pages_per_split;
  float* part = n_split > 1 ? static_cast<float*>(a.part) : nullptr;
  paged_decode_kernel<T, KT, D><<<dim3(a.B * a.KVH, n_split), warps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.positions), static_cast<const float*>(a.slopes),
      static_cast<T*>(a.out), part, a.NH, a.KVH, a.Dt, a.ps, a.MP, a.pages_per_split, a.scale);
  if (part != nullptr) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    paged_merge_kernel<T, D><<<a.B * a.KVH, 128, 0, stream>>>(part, static_cast<T*>(a.out),
                                                            a.NH, a.KVH, a.Dt, n_split);
  }
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t launch_wide(const Args& a, cudaStream_t stream) {
  const int G = a.NH / a.KVH;
  const size_t smem = sizeof(float) * ((size_t)G * a.ps + (size_t)G * kWidePart + 3 * G);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(paged_decode_wide_kernel<T, KT>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)smem);
  if (attr != cudaSuccess) return attr;
  const int n_split = (a.MP + a.pages_per_split - 1) / a.pages_per_split;
  float* part = n_split > 1 ? static_cast<float*>(a.part) : nullptr;
  const dim3 grid(a.B * a.KVH, n_split, (a.Dt + kWidePart - 1) / kWidePart);
  paged_decode_wide_kernel<T, KT><<<grid, kWideWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.positions), static_cast<const float*>(a.slopes),
      static_cast<T*>(a.out), part, a.NH, a.KVH, a.Dt, a.ps, a.MP, a.pages_per_split, a.scale);
  if (part != nullptr) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    paged_merge_wide_kernel<T><<<a.B * a.KVH, 128, 0, stream>>>(part, static_cast<T*>(a.out),
                                                                a.NH, a.KVH, a.Dt, n_split);
  }
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  if (D > 256) return launch_wide<T, KT>(a, stream);  // runtime head dim
  switch (D <= 128 ? (D + 15) / 16 * 16 : (D + 31) / 32 * 32) {  // the kernel's head dim
#define DSTPU_PAGED_CASE(d) \
  case d:                   \
    return launch<T, KT, d>(a, stream);
    DSTPU_PAGED_CASE(16)
    DSTPU_PAGED_CASE(32)
    DSTPU_PAGED_CASE(48)
    DSTPU_PAGED_CASE(64)
    DSTPU_PAGED_CASE(80)
    DSTPU_PAGED_CASE(96)
    DSTPU_PAGED_CASE(112)
    DSTPU_PAGED_CASE(128)
    DSTPU_PAGED_CASE(160)
    DSTPU_PAGED_CASE(192)
    DSTPU_PAGED_CASE(224)
    DSTPU_PAGED_CASE(256)
#undef DSTPU_PAGED_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_quant(int quant, int D, const Args& a, cudaStream_t stream) {
  return quant ? dispatch_d<T, int8_t>(D, a, stream) : dispatch_d<T, T>(D, a, stream);
}

}  // namespace

// dtype (of q and out; of the pools unless quant): 0 = fp32, 1 = bf16, 2 = fp16.
// q [B, NH, D]; pools [P, ps, KVH, D] (int8 when quant, with fp32 scales
// [P, ps, KVH]), 16-byte aligned; page_table [B, MP] int32; positions [B]
// int32; slopes [NH] fp32 or null; out [B, NH, D].  All contiguous.  D >= 1;
// up to 256 the kernel runs at Dk, D rounded up to 16 (to 32 past 128), past
// 256 the runtime-head-dim kernel at Dk = D.  Each sequence's pages are
// split across blocks of pages_per_split pages; when MP > pages_per_split,
// part is fp32 scratch of B * KVH * ceil(MP / pages_per_split) * (NH / KVH) *
// (Dk + 2) floats.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int dstpu_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* k_scale,
                                            const void* v_scale, const void* page_table,
                                            const void* positions, const void* slopes,
                                            void* out, void* part, int dtype, int quant, int B,
                                            int NH, int KVH, int D, int ps, int MP,
                                            int pages_per_split, float scale, void* stream) {
  if (KVH <= 0 || NH % KVH != 0 || ps <= 0 || MP <= 0 || pages_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (MP > pages_per_split && part == nullptr) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0) return (int)cudaSuccess;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const Args a{q,   k_pool, v_pool, quant ? k_scale : nullptr, quant ? v_scale : nullptr,
               page_table, positions, slopes, out, part, B, NH, KVH, D, ps, MP,
               pages_per_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_quant<float>(quant, D, a, st);
    case 1:
      return (int)dispatch_quant<__nv_bfloat16>(quant, D, a, st);
    case 2:
      return (int)dispatch_quant<__half>(quant, D, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
