// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// :_fwd_kernel (via _fwd / flash_attention), the attention of the paged
// prefill programs (whole-prompt and chunked prefill with a runtime
// q_offset).
//
// What it computes, per query head h of batch b (query head h reads KV head
// h / q_per_kv, so GQA never materialises the repeat):
//   s[i, j]  = sm_scale * (q[i] . k[j])  - slope[h] * (row_i - j)    (ALiBi)
//   row_i    = q_offset + i   (query i sits at global position q_offset + i;
//                              key j sits at its buffer index j)
//   masked   : j >= valid_k, or (causal and row_i < j)  ->  s = -1e30
//   o[i]     = sum_j softmax(s[i])_j v[j]      (online softmax, fp32)
//   lse[i]   = m_i + log(max(l_i, 1e-30))
// exactly the finite-NEG_INF semantics of the TPU kernel: a fully masked row
// gives a finite value, never NaN, and l is clamped to 1e-30.
//
// What bounds it on the H100: the arithmetic.  Causal attention at S = 1024,
// 32 heads over 8 KV heads, D = 64 is 4.3 GFLOP against 10.6 MB of
// q/k/v/o/lse traffic, far above the ~295 FLOP/byte ridge, so the least
// time is the tensor-core rate (4.3 us at 989 TFLOP/s).
//
// Design, bf16 and fp16 (the serving path): one block of 4 warps per
// (b*NH + h, 64-row query tile); each warp owns 16 query rows.  Q is staged
// once through shared memory into mma.sync A fragments held in registers.
// K/V tiles of 64 keys are copied into shared memory with 16-byte cp.async,
// double-buffered (tile t+1 in flight while tile t is computed).  S = QK^T
// and O += PV run on the tensor cores (mma.sync m16n8k16, fp32
// accumulators); P is rounded to the input type only as the PV operand,
// straight from the S accumulators' register layout; V's B fragments come
// from ldmatrix.trans.  The running (m, l) of each row stay in registers and
// reduce over the 4 lanes that share a row.  Key tiles wholly above the
// causal diagonal or past valid_k are skipped.  Not yet: wgmma, TMA, warp
// specialisation (later work).
//
// Design, fp32 (tests and small references): the same tiling on the fp32 FMA
// pipes out of shared memory — a 16x16 thread grid, 4 rows x 4 strided
// columns per thread — so fp32 stays fp32 end to end (no TF32).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool visible(int row, int col, int valid_k, int causal) {
  return col < valid_k && (!causal || row >= col);
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16, fp16)
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
// B fragment (16 keys x 8 dims) of a row-major [key][dim] tile, transposed
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* row_addr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(uint16_t) * 5 * kBQ * (D + 8);  // Q + 2 x (K, V) tiles, padded rows
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse,
                     const float* __restrict__ slopes, int NH, int KVH, int Sq, int Sk,
                     int valid_k, int q_offset, int causal, float sm_scale,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh) {
  constexpr int RS = D + 8;   // padded row (+16 bytes): conflict-free fragment reads
  constexpr int KT = D / 16;  // k-steps of QK^T over the head dim
  constexpr int NT = kBK / 8; // 8-key n-tiles of S
  constexpr int DT = D / 8;   // 8-dim n-tiles of O
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][RS]
  T* Ks = Qs + kBQ * RS;                   // [2][BK][RS]
  T* Vs = Ks + 2 * kBK * RS;               // [2][BK][RS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / NH;
  const int h = bh % NH;
  const int kvh = h / (NH / KVH);
  const int q_start = blockIdx.x * kBQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < kBQ * CPR; i += kMmaWarps * 32) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int qi = q_start + r;
    cp_async16(Qs + r * RS + c, qb + (long long)min(qi, Sq - 1) * qss + c, qi < Sq ? 16 : 0);
  }
  cp_async_commit();

  auto load_kv = [&](int buf, int k0) {
    T* kd = Ks + buf * kBK * RS;
    T* vd = Vs + buf * kBK * RS;
    for (int i = tid; i < kBK * CPR; i += kMmaWarps * 32) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int kj = k0 + r;
      const int n = kj < Sk ? 16 : 0;
      const long long row = kj < Sk ? kj : 0;
      cp_async16(kd + r * RS + c, kb + row * kss + c, n);
      cp_async16(vd + r * RS + c, vb + row * vss + c, n);
    }
    cp_async_commit();
  };

  // keys past this tile's last row are above the diagonal for every row
  int k_end = valid_k;
  if (causal) k_end = min(k_end, q_offset + q_start + kBQ);
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  if (n_tiles > 0) {
    load_kv(0, 0);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2);  // this lane's rows: r0 and r0 + 8
  const int cq = (lane & 3) * 2;           // and its column pair
  uint32_t qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const T* p = Qs + r0 * RS + kt * 16 + cq;
    qf[kt][0] = lds32(p);
    qf[kt][1] = lds32(p + 8 * RS);
    qf[kt][2] = lds32(p + 8);
    qf[kt][3] = lds32(p + 8 * RS + 8);
  }

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const int row_g = q_offset + q_start + r0;  // global position of row r0

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    const int k0 = t * kBK;
    if (t + 1 < n_tiles) {
      load_kv(cur ^ 1, k0 + kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kc = Ks + cur * kBK * RS;
    const T* Vc = Vs + cur * kBK * RS;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const T* kr = Kc + (nt * 8 + (lane >> 2)) * RS + cq;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t bk[2] = {lds32(kr + kt * 16), lds32(kr + kt * 16 + 8)};
        Mma<T>::run(s[nt], qf[kt], bk);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_g + (e >> 1) * 8;
        const int col = k0 + nt * 8 + cq + (e & 1);
        float x = s[nt][e] * sm_scale;
        if (slopes != nullptr) x -= slope * (float)(row - col);
        x = visible(row, col, valid_k, causal) ? x : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        oacc[dt][2 * i] *= alpha;
        oacc[dt][2 * i + 1] *= alpha;
      }
    }

    // P as A fragments: the S accumulators of n-tiles 2j and 2j+1 are the
    // A fragment of key k-step j
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(s[nt][0] - m[0]), p1 = expf(s[nt][1] - m[0]);
      const float p2 = expf(s[nt][2] - m[1]), p3 = expf(s[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2] = Mma<T>::pack(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = Mma<T>::pack(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const T* vr = Vc + (j * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bv[2];
        ldmatrix_x2_trans(bv, vr + dt * 8);
        Mma<T>::run(oacc[dt], pf[j], bv);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l[i]), 1e-30f);
    const int qi = q_start + r0 + 8 * i;
    if (qi >= Sq) continue;
    T* orow = o + (((long long)b * Sq + qi) * NH + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + cq) =
          Mma<T>::pack(oacc[dt][2 * i] / lc, oacc[dt][2 * i + 1] / lc);
    if ((lane & 3) == 0) lse[((long long)b * NH + h) * Sq + qi] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// fp32 kernel (FMA pipes)
// ---------------------------------------------------------------------------
constexpr int kFmaThreads = 256;

template <int D>
constexpr size_t fma_smem_bytes() {
  // Qs[BQ][D+1] + Ks[BK][D+1] + Vs[BK][D] + Ps[BQ][BK+1], fp32
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ slopes, int NH,
                     int KVH, int Sq, int Sk, int valid_k, int q_offset, int causal,
                     float sm_scale, long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh) {
  constexpr int DP = D + 1;       // padded row: conflict-free column reads
  constexpr int PP = kBK + 1;
  constexpr int NC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][DP]
  float* Ks = Qs + kBQ * DP;      // [BK][DP]
  float* Vs = Ks + kBK * DP;      // [BK][D]
  float* Ps = Vs + kBK * D;       // [BQ][PP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;        // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 15;        // column lane
  const int bh = blockIdx.y;
  const int b = bh / NH;
  const int h = bh % NH;
  const int kvh = h / (NH / KVH);
  const int q_start = blockIdx.x * kBQ;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  for (int idx = tid; idx < kBQ * D; idx += kFmaThreads) {
    const int r = idx / D, d = idx % D;
    const int qi = q_start + r;
    Qs[r * DP + d] = qi < Sq ? qb[qi * qss + d] : 0.f;
  }

  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  int k_end = valid_k;
  if (causal) k_end = min(k_end, q_offset + q_start + kBQ);
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's readers are done with Ks/Vs/Ps
    for (int idx = tid; idx < kBK * D; idx += kFmaThreads) {
      const int r = idx / D, d = idx % D;
      const int kj = k0 + r;
      const bool in = kj < Sk;
      Ks[r * DP + d] = in ? kb[kj * kss + d] : 0.f;
      Vs[r * D + d] = in ? vb[kj * vss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q_offset + q_start + ty * 4 + r;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float sv = s[r][j] * sm_scale;
        if (slopes != nullptr) sv -= slope * (float)(row - col);
        s[r][j] = visible(row, col, valid_k, causal) ? sv : kNegInf;
        mt = fmaxf(mt, s[r][j]);
      }
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        Ps[(ty * 4 + r) * PP + tx + 16 * j] = p;
        psum += p;
      }
      psum = half_warp_sum(psum);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();  // a row group's Ps rows are written by its own half-warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_start + ty * 4 + r;
    if (qi >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    float* orow = o + (((long long)b * Sq + qi) * NH + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[r][c] / lc;
    if (tx == 0) lse[((long long)b * NH + h) * Sq + qi] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  const void* slopes;
  int B, NH, KVH, Sq, Sk, valid_k, q_offset, causal;
  float sm_scale;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, bool* done) {
  if (*done || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  *done = e == cudaSuccess;
  return e;
}

template <typename T, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  static bool attr_set = false;
  const cudaError_t e = opt_in(flash_fwd_mma_kernel<T, D>, smem, &attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.NH);
  flash_fwd_mma_kernel<T, D><<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.lse), static_cast<const float*>(a.slopes),
      a.NH, a.KVH, a.Sq, a.Sk, a.valid_k, a.q_offset, a.causal, a.sm_scale, a.qsb, a.qss,
      a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<D>();
  static bool attr_set = false;
  const cudaError_t e = opt_in(flash_fwd_fma_kernel<D>, smem, &attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.NH);
  flash_fwd_fma_kernel<D><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), static_cast<float*>(a.lse),
      static_cast<const float*>(a.slopes), a.NH, a.KVH, a.Sq, a.Sk, a.valid_k, a.q_offset,
      a.causal, a.sm_scale, a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const Args& a, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fma<D>(a, stream);
    case 1:
      return launch_mma<__nv_bfloat16, D>(a, stream);
    case 2:
      return launch_mma<__half, D>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16.  q [B, Sq, NH, D] and k/v [B, Sk, KVH, D]
// with the given element strides (the last dim contiguous; for bf16/fp16 every
// row 16-byte aligned); o [B, Sq, NH, D] contiguous in q's dtype; lse
// [B, NH, Sq] fp32; slopes [NH] fp32 or null.  D is a multiple of 16 from 16
// to 128.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dstpu_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* slopes,
    int dtype, int B, int NH, int KVH, int Sq, int Sk, int D, int valid_k, int q_offset,
    int causal, float sm_scale, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    void* stream) {
  if (KVH <= 0 || NH % KVH != 0 || valid_k > Sk || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, slopes, B, NH, KVH, Sq, Sk, valid_k, q_offset, causal,
               sm_scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return (int)dispatch_dtype<16>(dtype, a, st);
    case 32:
      return (int)dispatch_dtype<32>(dtype, a, st);
    case 48:
      return (int)dispatch_dtype<48>(dtype, a, st);
    case 64:
      return (int)dispatch_dtype<64>(dtype, a, st);
    case 80:
      return (int)dispatch_dtype<80>(dtype, a, st);
    case 96:
      return (int)dispatch_dtype<96>(dtype, a, st);
    case 112:
      return (int)dispatch_dtype<112>(dtype, a, st);
    case 128:
      return (int)dispatch_dtype<128>(dtype, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
