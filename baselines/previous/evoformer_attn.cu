// Evoformer attention for Hopper (sm_90a), plain C interface for ctypes:
// forward (kernel E), dQ + dbias1 (kernel E') and dK/dV + dbias2 (kernel E'').
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/pallas/evoformer_attn.py
// :_fwd_kernel (E), :_bwd_dq_kernel (E') and :_bwd_dkv_kernel (E''), the
// custom VJP behind DS4Sci_EvoformerAttention.  q, k, v, dO are
// [B, S, N, H, D] (batch, MSA rows, residues, heads, head dim), read through
// their strides; attention runs over N for each (b, s, h):
//   x[i, j]  = (q[i] . k[j]) * sm_scale + bias1[b, s, j] + bias2[b, h, i, j]
//              (added in this order, fp32; either bias may be absent)
//   o[i]     = sum_j softmax(x[i])_j v[j],  lse[i] = m_i + log l_i
//   p[i, j]  = exp(x[i, j] - lse[i]),  dp = dO[i] . v[j]
//   ds[i, j] = p (dp - delta[i]),  delta = rowsum(o * dO) (computed outside)
//   dq = sm_scale ds k,  dk = sm_scale ds^T q,  dv = p^T dO
//   dbias1[b, s, j]    = sum over (h, i) of ds      (E')
//   dbias2[b, h, i, j] = sum over s of ds           (E'')
// Keys j >= K are masked (NEG_INF = -1e30 in the forward, p = 0 after) and
// rows i >= Q are never stored: the tails are masked here, where JAX pads
// them in memory.  The [B, S, H, Q, K] scores (2.42 GB in fp32 at
// AlphaFold 2's MSA row attention, B=1 S=512 N=384 H=8) are never written.
//
// Bias gradients are sums across what the TPU grid runs in order (dbias1
// over (h, q-block), dbias2 over s, the fastest grid axis).  Hopper runs
// blocks in parallel and in no order, and the port's gradients must repeat
// bit for bit, so no float atomics are used:
//   E'  one block per (b, s, chunk) walks its heads' query rows (bf16/
//       fp16: a chunk is a range of heads, cut only while the grid would
//       not cover the SMs once; fp32: a range of (h, q-tile) units); each
//       warp sums its 16 rows of ds per column by a fixed shuffle tree into
//       its own row of shared memory, and the block adds the warps' rows in
//       order at the end.  With more than one chunk the chunks' fp32
//       partials are added in chunk order by a second pass.  The key axis
//       is one range while the per-warp fp32 dbias1 rows fit a block beside
//       the tiles (K up to ~5,000 in bf16 at D = 32, ~20,000 in fp32); past
//       that it is cut into the fewest ranges that fit, a grid axis of
//       their own: each range's blocks sum dbias1 for its own keys (disjoint
//       columns) and write fp32 partials of their dQ rows, which a second
//       pass adds in range order and rounds once.  So E' takes any K, with
//       no atomics.
//   E'' one block per (b, h, 64-key tile, chunk of s, query range) loops s
//       and, for each, the query tiles of its range: dK/dV of (b, s, h, key
//       tile) sum in registers over those tiles, and dbias2[range, key tile]
//       sums over the chunk's s in shared memory ([range rows][64 + 4] fp32,
//       each element owned by one lane).  The s chunks (sized so the grid
//       covers the SMs four times; 48 blocks at the main shape without
//       them) write fp32 partials that the second pass adds in chunk order.
//       The query axis is one range while its accumulator fits a block
//       (AlphaFold 2's N = 384 does: up to 384 residues at D <= 32 in
//       bf16/fp16, 512 in fp32); past that it is cut into the fewest ranges
//       that fit, and each range writes fp32 dK/dV partials that a second
//       pass adds in range order and rounds once.  So E'' takes any query
//       length, with no atomics.
//
// What bounds it on the H100: at the main shape (D = 32, bf16) the forward
// moves q, k, v and o (100.7 MB each) for 77 GFLOP: 0.12 ms of bytes
// against 0.08 ms of tensor-core time, so the bytes bound it.  In practice
// the per-score work (scale, two bias adds, mask, exp) sets all three
// kernels: 6.04e8 scores, ~0.16 ms of exponentials alone at 16 a clock per
// SM.  bias2 [B, H, Q, K] fp32 (4.7 MB) is read once per s by a kernel that
// stages it per tile (2.4 GB of L2 reads at the main shape).
//
// Kernel E, bf16 and fp16, while a 64-query tile's pair-bias rows fit a
// block beside the rings (K up to 512 at D = 32; any K up to ~10,000 without
// bias2):
//   Work.  One block of two consumer warpgroups and a producer warp per
//   (b, h, 64-query tile, chunk of up to 16 MSA rows s); warpgroup c takes
//   the chunk's s of parity c, so one warpgroup's softmax runs under the
//   other's products.  The block loads its bias2 rows [64][K] once, times
//   log2(e), into shared memory and keeps them for every s of the chunk:
//   0.15 GB of L2 reads at the main shape instead of 2.4 GB.
//   Copies.  One 5-D TMA map per operand over [B, S, N, H, D] with the real
//   strides (one request per tile instead of four per row), tiles swizzled
//   at W = 16, 32 or 64 columns, key tiles of 128 rows up to D = 64 (64
//   past it).  One lane of the producer warp walks each warpgroup's
//   (s, key tile) pairs as one stream through its ring of up to 4 stages,
//   so the ring never drains at an s boundary, and the next s's Q tile and
//   bias1 row (a bulk copy when K % 4 == 0) land in the second buffer
//   under the current s; the consumers only wait and release.  (With the
//   copies issued by a consumer thread, that thread's waits for its
//   warpgroup's releases stalled the whole warpgroup.)
//   Products.  S = Q K^T by wgmma m64nBKk16 (both K-major in shared
//   memory), P V by m64nDk16 with P from registers and V MN-major; S of
//   tile t and P V of tile t - 1 are issued together and tile t's softmax
//   runs under P V.
//   Per score.  x = fma(s, sm_scale * log2(e), bias2' + bias1 * log2(e)),
//   bias2' resident and pre-scaled, bias1 read once per column pair, exp2
//   by ex2.approx, the K tail masked on the edge tile only; lse is written
//   in natural-log units.  O is zeroed once: each s starts from m = -1e30,
//   whose rescale factor 0 clears the last s's sums, so no instruction but
//   wgmma and that rescale writes the accumulators inside the loop (zeroing
//   them there serialized every wgmma).
// Past the pair bias that fits, and for fp32: the tile kernel below.
//
// Kernel E'', bf16 and fp16: two consumer warpgroups on wgmma fed by TMA,
// the structure of the flash backward's dK/dV kernel (A'') with E's 5-D
// maps (see evo_bwd_dkv_wgmma_kernel).  What held the mma.sync kernel it
// replaces to 26x its bound: its pipeline drained at every s (K/V re-staged
// behind a wait and a barrier before any query tile), it staged bias2 by
// cp.async per (s, query tile), took accurate expf of a sum through
// pointers that might be null for every score, and ran one warpgroup a
// block.  Here one stream of (s, query step) pairs runs through a TMA ring
// with the next s's K/V landing under the current s; bias2 arrives as one
// swizzled TMA tile a step (L2 reads, ~2.4 GB at the main shape: shared
// memory holds the [384][68] fp32 dbias2 accumulator, not the pair bias
// too); a score costs an fma, an add, a subtract, a multiply and
// ex2.approx, the mask only on the edge tile; and two warpgroups split each
// step's query rows.
//
// Kernel E', bf16 and fp16: two consumer warpgroups and a producer warp on
// wgmma fed by TMA (see evo_bwd_dq_wgmma_kernel), E's 5-D maps and E''s
// swizzled bias2 tiles.  A (b, s) block walks its heads' query rows in
// steps of 128; every step of a head reads the same K and V, so a head's
// K/V tiles are loaded once and kept for all its steps while they fit
// (AlphaFold 2's N = 384 does up to D = 64; else they stream through a
// ring), the next head's replacing them as the last step releases them.
// One producer lane keeps the Q, K/V and bias2 rings full across step and
// head boundaries, so no ring drains between units of work.  A score costs
// an fma, an add, a subtract, a multiply and ex2.approx, the mask only on
// ragged tiles.
//
// Tile kernel (E), bf16 and fp16: the flash-attention tiles
// (csrc/flash_attention_*.cu) — 4 warps of 16 rows, mma.sync m16n8k16 with
// fp32 accumulators, 16-byte cp.async tiles with padded rows (bias tiles
// staged with the operand tiles of the same step), P rounded to the input
// type only as the PV operand.  fp32: the same loops on the FMA pipes (16 x
// 16 threads, 4 x 4 patches), fp32 throughout, with accurate exponentials.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kB = 64;           // query and key tile
constexpr int kMmaWarps = 4;
constexpr int kFmaThreads = 256;
constexpr int kDbPad = kB + 4;   // dbias2 accumulator row: conflict-free lane updates
constexpr int kMaxSmem = 232448; // a block's shared memory on the H100 (227 KB)

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta, *b1, *b2;
  void *o, *dq, *dk, *dv;
  float *lse, *db1, *db2, *part;
  int B, S, Q, K, H, chunks;
  float sm_scale;
  long long qsb, qss, qsn, qsh, ksb, kss, ksn, ksh, vsb, vss, vsn, vsh, dsb, dss, dsn, dsh;
  int qranges;     // E'': query ranges (1: the whole axis)
  float* kv_part;  // E'' with qranges > 1: fp32 [qranges][2][B, S, K, H, D] dK/dV partials
  int kranges;     // E': key ranges (1: the whole axis)
  float* dq_part;  // E' with kranges > 1: fp32 [kranges][B, S, Q, H, D] dQ partials
  int fwd_stages;  // E, bf16/fp16: the resident-bias kernel's ring (0: the tile kernel)
  int dkv_stages;  // E'', bf16/fp16: the wgmma kernel's ring stages
  int ldb, ldq;    // E'', bf16/fp16: bias rows padded to ldb floats, lse/delta rows to ldq
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// staged bias2 rows: [q][k] for E and E' (lanes read column pairs: a row
// of 64 + 8 floats keeps them conflict-free), [q][key] for E'' (lanes read
// down a column: 64 + 4)
constexpr int kB2Ld = kB + 8;
constexpr int kB2LdT = kB + 4;

// the scaled score plus the staged bias tiles (local row and column), in
// the TPU kernel's order; a null tile is an absent bias
__device__ __forceinline__ float add_bias(float x, const float* b1s, const float* b2s, int ld,
                                          int lr, int lc) {
  if (b1s) x += b1s[lc];
  if (b2s) x += b2s[lr * ld + lc];
  return x;
}

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// rows [r0, r0 + nrows) x columns [c0, c0 + 64) of a row-major fp32 matrix
// with n_rows x n_cols valid entries into smem (row stride ld_dst) by
// cp.async, zero outside; 16 bytes at a time when every row starts 16-byte
// aligned and n_cols % 4 == 0 (vec), else 4.  The bias tiles go with the
// operand tiles of the same step, so their loads are in flight while the
// previous step computes.
__device__ __forceinline__ void stage_window(float* dst, int ld_dst, const float* src,
                                             long long ld_src, int r0, int nrows, int n_rows,
                                             int c0, int n_cols, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nrows * (kB / 4); i += blockDim.x) {
      const int r = i / (kB / 4), c = (i % (kB / 4)) * 4;
      const int row = r0 + r, col = c0 + c;
      const bool ok = row < n_rows && col < n_cols;
      cp_async16(dst + r * ld_dst + c, ok ? src + row * ld_src + col : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * kB; i += blockDim.x) {
      const int r = i / kB, c = i % kB;
      const int row = r0 + r, col = c0 + c;
      const bool ok = row < n_rows && col < n_cols;
      cp_async4(dst + r * ld_dst + c, ok ? src + row * ld_src + col : src, ok ? 4 : 0);
    }
  }
}

// the biases of one (b, s, h) in device memory: bias1's row and bias2's
// [Q, K] matrix, null when absent
struct BiasSrc {
  const float* b1;
  const float* b2;
  int Q, K;
  bool vec;
  __device__ BiasSrc(const Args& a, int b, int s, int h)
      : b1(a.b1 ? a.b1 + ((long long)b * a.S + s) * a.K : nullptr),
        b2(a.b2 ? a.b2 + ((long long)b * a.H + h) * a.Q * a.K : nullptr),
        Q(a.Q), K(a.K), vec(a.K % 4 == 0) {}
  // bias1 [c0, c0 + 64) into b1s and bias2 rows [r0, r0 + nrows) x columns
  // [c0, c0 + 64) into b2s with row stride ld
  __device__ __forceinline__ void stage(float* b1s, float* b2s, int ld, int r0, int nrows,
                                        int c0) const {
    if (b1) stage_window(b1s, 0, b1, 0, 0, 1, 1, c0, K, vec);
    if (b2) stage_window(b2s, ld, b2, K, r0, nrows, Q, c0, K, vec);
  }
};
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
// this lane's part of the A fragment (rows r0 and r0 + 8, columns c0, c0 + 1
// and c0 + 8, c0 + 9) of a row-major tile
__device__ __forceinline__ void load_a(uint32_t* f, const uint16_t* tile, int RS, int r0, int c0) {
  const uint16_t* p = tile + r0 * RS + c0;
  f[0] = lds32(p);
  f[1] = lds32(p + 8 * RS);
  f[2] = lds32(p + 8);
  f[3] = lds32(p + 8 * RS + 8);
}
// rows [r0, r0 + nrows) of one (b, s, h) into a padded smem tile by 16-byte
// cp.async; rows at or past n are zero-filled
template <typename T, int D>
__device__ __forceinline__ void stage_async(T* dst, const T* src, long long row_stride, int r0,
                                            int nrows, int n) {
  constexpr int RS = D + 8, CPR = D / 8;
  for (int i = threadIdx.x; i < nrows * CPR; i += kMmaWarps * 32) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = r0 + r;
    cp_async16(dst + r * RS + c, src + (long long)min(row, n - 1) * row_stride + c,
               row < n ? 16 : 0);
  }
}
// the same into an fp32 tile [kB][D + 1] by plain loads (FMA kernels)
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long row_stride,
                                           int r0, int n) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < kB * D; idx += kFmaThreads) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r;
    dst[r * DP + d] = row < n ? src[(long long)row * row_stride + d] : 0.f;
  }
}

// ===========================================================================
// kernel E: forward
// ===========================================================================
template <int D>
constexpr size_t fwd_mma_smem() {
  return sizeof(uint16_t) * 5 * kB * (D + 8);  // Q + 2 x (K, V); the bias tiles follow
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32) evo_fwd_mma_kernel(Args a) {
  constexpr int RS = D + 8, KT = D / 16, NT = kB / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kB][RS]
  T* Ks = Qs + kB * RS;                    // [2][kB][RS]
  T* Vs = Ks + 2 * kB * RS;                // [2][kB][RS]
  float* b1s = reinterpret_cast<float*>(Vs + 2 * kB * RS);  // [2][kB]
  float* b2s = b1s + 2 * kB;                                // [2][kB][kB2Ld]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = cdiv(a.Q, kB);
  const int qt = blockIdx.x % nq;
  const int bsh = blockIdx.x / nq;
  const int h = bsh % a.H, bs = bsh / a.H;
  const int s = bs % a.S, b = bs / a.S;
  const int q_start = qt * kB;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + s * a.qss + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + s * a.kss + h * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + s * a.vss + h * a.vsh;
  const BiasSrc bias(a, b, s, h);

  stage_async<T, D>(Qs, qb, a.qsn, q_start, kB, a.Q);
  cp_async_commit();
  auto load_kv = [&](int buf, int k0) {
    stage_async<T, D>(Ks + buf * kB * RS, kb, a.ksn, k0, kB, a.K);
    stage_async<T, D>(Vs + buf * kB * RS, vb, a.vsn, k0, kB, a.K);
    bias.stage(b1s + buf * kB, b2s + buf * kB * kB2Ld, kB2Ld, q_start, kB, k0);
    cp_async_commit();
  };
  const int n_tiles = cdiv(a.K, kB);
  load_kv(0, 0);
  cp_async_wait<1>();
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2);  // this lane's rows: r0 and r0 + 8
  const int cq = (lane & 3) * 2;           // and its column pair
  uint32_t qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) load_a(qf[kt], reinterpret_cast<const uint16_t*>(Qs), RS, r0, kt * 16 + cq);

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

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
    const float* b1c = bias.b1 ? b1s + cur * kB : nullptr;
    const float* b2c = bias.b2 ? b2s + cur * kB * kB2Ld : nullptr;

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const T* kr = Kc + (nt * 8 + (lane >> 2)) * RS + cq;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t bk[2] = {lds32(kr + kt * 16), lds32(kr + kt * 16 + 8)};
        Mma<T>::run(sc[nt], qf[kt], bk);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = r0 + (e >> 1) * 8, lc = nt * 8 + cq + (e & 1);
        // the K tail is masked; rows past Q read zeros and are not stored
        const float x = k0 + lc < a.K
                            ? add_bias(sc[nt][e] * a.sm_scale, b1c, b2c, kB2Ld, lr, lc)
                            : kNegInf;
        sc[nt][e] = x;
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
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(sc[nt][0] - m[0]), p1 = expf(sc[nt][1] - m[0]);
      const float p2 = expf(sc[nt][2] - m[1]), p3 = expf(sc[nt][3] - m[1]);
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
    if (qi >= a.Q) continue;
    T* orow = static_cast<T*>(a.o) + (((long long)bs * a.Q + qi) * a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + cq) =
          Mma<T>::pack(oacc[dt][2 * i] / lc, oacc[dt][2 * i + 1] / lc);
    if ((lane & 3) == 0) a.lse[((long long)bs * a.H + h) * a.Q + qi] = m[i] + logf(lc);
  }
}

template <int D>
constexpr size_t fwd_fma_smem() {
  // Qs[kB][D+1] + Ks[kB][D+1] + Vs[kB][D+1] + Ps[kB][kB+1], fp32
  return sizeof(float) * (3 * kB * (D + 1) + kB * (kB + 1));
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads) evo_fwd_fma_kernel(Args a) {
  constexpr int DP = D + 1, PP = kB + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;           // [kB][DP]
  float* Ks = Qs + kB * DP;   // [kB][DP]
  float* Vs = Ks + kB * DP;   // [kB][DP]
  float* Ps = Vs + kB * DP;   // [kB][PP]
  float* b1s = Ps + kB * PP;  // [kB]
  float* b2s = b1s + kB;      // [kB][kB2Ld]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nq = cdiv(a.Q, kB);
  const int qt = blockIdx.x % nq;
  const int bsh = blockIdx.x / nq;
  const int h = bsh % a.H, bs = bsh / a.H;
  const int s = bs % a.S, b = bs / a.S;
  const int q_start = qt * kB;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + s * a.qss + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + s * a.kss + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + s * a.vss + h * a.vsh;
  const BiasSrc bias(a, b, s, h);
  const float* b1c = bias.b1 ? b1s : nullptr;
  const float* b2c = bias.b2 ? b2s : nullptr;

  stage_rows<D>(Qs, qb, a.qsn, q_start, a.Q);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const int n_tiles = cdiv(a.K, kB);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    bias.stage(b1s, b2s, kB2Ld, q_start, kB, k0);
    cp_async_commit();
    stage_rows<D>(Ks, kb, a.ksn, k0, a.K);
    stage_rows<D>(Vs, vb, a.vsn, k0, a.K);
    cp_async_wait<0>();
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[r][j] = 0.f;
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
        for (int j = 0; j < 4; ++j) sc[r][j] = fmaf(qv[r], kv[j], sc[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lc = tx + 16 * j;
        const float x = k0 + lc < a.K
                            ? add_bias(sc[r][j] * a.sm_scale, b1c, b2c, kB2Ld, ty * 4 + r, lc)
                            : kNegInf;
        sc[r][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[r][j] - m_new);
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
    for (int kk = 0; kk < kB; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_start + ty * 4 + r;
    if (qi >= a.Q) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    float* orow = static_cast<float*>(a.o) + (((long long)bs * a.Q + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[r][c] / lc;
    if (tx == 0) a.lse[((long long)bs * a.H + h) * a.Q + qi] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// kernel E, bf16 and fp16: wgmma fed by TMA, the pair bias resident
// ---------------------------------------------------------------------------
constexpr int kEvoWgThreads = 256;  // two consumer warpgroups, alternate s (+ a producer warp)

struct FwdWgArgs {
  const float *b1, *b2;  // fp32 [B, S, K] and [B, H, Q, K], or null
  void* o;
  float* lse;
  int B, S, Q, K, H, nq, nkt, chunks, s_per, stages, ldb;
  float sm_scale;
};

// columns of a swizzled block of a D-wide tile: 16, 32 or 64 (rows of 32,
// 64 or 128 bytes)
template <int D>
__host__ __device__ constexpr int evo_w() {
  return D % 64 == 0 ? 64 : D;
}
// keys per tile: 128 up to D = 64 (half the per-tile waits and copies per
// key), 64 past it (the D-wide accumulators and S in registers)
template <int D>
__host__ __device__ constexpr int evo_bk() {
  return D <= 64 ? 128 : 64;
}

// the scores of one 64-query x BK-key tile in the log2 domain:
// s * sm_scale * log2(e) + (bias2' + bias1 * log2(e)), bias2' the resident
// pair bias (pre-scaled) and b1r the s's bias1 row at this tile (raw, zeros
// when absent), each bias column pair read once for both of the lane's rows;
// keys at or past K masked to -1e30 on the edge tile
template <bool B2, bool EDGE, int BK>
__device__ __forceinline__ void evo_scores(float (&s)[BK / 2], const float* b2r0,
                                           const float* b2r1, const float* b1r, int k0, int cq,
                                           int K, float scale2) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float2 p0 = make_float2(0.f, 0.f), p1 = make_float2(0.f, 0.f);
    if (B2) {
      p0 = *reinterpret_cast<const float2*>(b2r0 + 8 * j + cq);
      p1 = *reinterpret_cast<const float2*>(b2r1 + 8 * j + cq);
    }
    const float2 c = *reinterpret_cast<const float2*>(b1r + 8 * j + cq);
    const float bias[4] = {fmaf(c.x, kLog2e, p0.x), fmaf(c.y, kLog2e, p0.y),
                           fmaf(c.x, kLog2e, p1.x), fmaf(c.y, kLog2e, p1.y)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fmaf(s[4 * j + e], scale2, bias[e]);
      if (EDGE && k0 + 8 * j + cq + (e & 1) >= K) x = kNegInf;
      s[4 * j + e] = x;
    }
  }
}

template <typename T, int D, bool B2>
__global__ void __launch_bounds__(kEvoWgThreads + 32, 1)
    evo_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const FwdWgArgs a) {
  constexpr int W = evo_w<D>();
  constexpr int BK = evo_bk<D>();
  constexpr int TILE = kB * D;           // elements of one 64-row Q tile
  constexpr int KT = BK * D;             // elements of one BK-row K or V tile
  constexpr uint32_t SBO = 16 * W;       // an 8-row atom of a swizzled block
  const int ST = a.stages;
  extern __shared__ unsigned char smem_raw[];
  // swizzling repeats every 1024 bytes at most: tiles start on that
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int cols = a.nkt * BK;  // keys rounded up to the tile
  // per warpgroup: Q [2][D/W][64][W], then K and V [ST][2][D/W][BK][W]
  auto qs_of = [&](int c) { return reinterpret_cast<T*>(base) + c * (2 * TILE + 2 * ST * KT); };
  float* b2s =
      reinterpret_cast<float*>(base + (size_t)2 * (2 * TILE + 2 * ST * KT) * sizeof(T));
  // per warpgroup: the bias1 rows of its current and next s [2][cols]
  float* b1s_all = b2s + (B2 ? kB * a.ldb : 0);
  // per warpgroup: q_full[2], q_empty[2], full[ST], empty[ST]
  uint64_t* bars = reinterpret_cast<uint64_t*>(b1s_all + 2 * 2 * cols);
  auto bars_of = [&](int c) { return bars + c * (4 + 2 * ST); };

  // block -> (b, h, chunk of s, query tile), the query tile fastest: the
  // blocks of one (b, h, chunk) read the same K and V tiles
  const int qt = blockIdx.x % a.nq;
  const int rest = blockIdx.x / a.nq;
  const int chunk = rest % a.chunks;
  const int bh = rest / a.chunks;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = qt * kB;
  const int s0 = chunk * a.s_per, s1 = min(a.S, s0 + a.s_per);
  const int nkt = a.nkt;
  // warpgroup c takes s0 + c, s0 + c + 2, ...: one stream of ns(c) x nkt key tiles
  auto ns_of = [&](int c) { return s1 - s0 > c ? (s1 - s0 - c + 1) / 2 : 0; };
  // bias1 rows ride the Q tile's barrier when TMA's bulk copy can take them
  const bool b1_bulk = a.b1 != nullptr && a.K % 4 == 0;

  if (threadIdx.x == 0) {
    for (int c = 0; c < 2; ++c) {
      uint64_t* br = bars_of(c);
      for (int i = 0; i < 2; ++i) {
        mbar_init(&br[i], 1);          // q_full
        mbar_init(&br[2 + i], 128);    // q_empty
      }
      for (int i = 0; i < ST; ++i) {
        mbar_init(&br[4 + i], 1);      // full
        mbar_init(&br[4 + ST + i], 128);  // empty
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the pair bias rows of this query tile, once for every s of the chunk,
  // times log2(e); rows past Q and keys past K are zeros.  Each warp takes
  // rows, each lane 4 columns at a time (16-byte loads when K % 4 == 0).
  // (Left to the consumers alone, under the producer's first copies, the
  // load was slower on the card.)
  const int warp_id = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (B2) {
    const float* src = a.b2 + ((long long)b * a.H + h) * a.Q * a.K;
    const bool vec = a.K % 4 == 0;
#pragma unroll 2
    for (int r = warp_id; r < kB; r += n_warps) {
      const int q = q0 + r;
      const float* row = src + (long long)q * a.K;
      for (int c4 = 4 * wl; c4 < cols; c4 += 128) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < a.Q) {
          if (vec && c4 + 4 <= a.K) {
            v = __ldg(reinterpret_cast<const float4*>(row + c4));
          } else {
            float e[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) e[i] = c4 + i < a.K ? __ldg(row + c4 + i) : 0.f;
            v = make_float4(e[0], e[1], e[2], e[3]);
          }
        }
        *reinterpret_cast<float4*>(b2s + r * a.ldb + c4) =
            make_float4(v.x * kLog2e, v.y * kLog2e, v.z * kLog2e, v.w * kLog2e);
      }
    }
  }
  if (a.b1 == nullptr)  // no bias1: both warpgroups' rows are zeros
    for (int i = threadIdx.x; i < 2 * 2 * cols; i += blockDim.x) b1s_all[i] = 0.f;
  __syncthreads();

  if (threadIdx.x >= kEvoWgThreads) {
    // the producer warp: one lane walks both warpgroups' streams in turn,
    // each tile into its warpgroup's ring once that stage is released; the
    // first tile of an s also brings the s's Q tile (and bias1 row) into
    // the warpgroup's other Q buffer once that one is released
    if (wl != 0) return;
    auto issue = [&](int c, int t) {
      const int j = t / nkt, kt = t % nkt;
      const int s = s0 + c + 2 * j;
      uint64_t* br = bars_of(c);
      T* Qs = qs_of(c);
      if (kt == 0) {
        const int qb = j & 1;
        if (j >= 2) mbar_wait(&br[2 + qb], ((j >> 1) - 1) & 1);
        mbar_arrive_tx(&br[qb], TILE * sizeof(T) + (b1_bulk ? a.K * 4 : 0));
#pragma unroll
        for (int cb = 0; cb < D / W; ++cb)
          tma_load_5d(Qs + qb * TILE + cb * W * kB, &tq, cb * W, h, q0, s, b, &br[qb]);
        if (b1_bulk)
          bulk_copy(b1s_all + (c * 2 + qb) * cols, a.b1 + ((long long)b * a.S + s) * a.K,
                    a.K * 4, &br[qb]);
      }
      const int st = t % ST;
      if (t >= ST) mbar_wait(&br[4 + ST + st], (t / ST - 1) & 1);
      mbar_arrive_tx(&br[4 + st], 2 * KT * sizeof(T));
      T* Kd = Qs + 2 * TILE + st * 2 * KT;
#pragma unroll
      for (int cb = 0; cb < D / W; ++cb) {
        tma_load_5d(Kd + cb * W * BK, &tk, cb * W, h, kt * BK, s, b, &br[4 + st]);
        tma_load_5d(Kd + KT + cb * W * BK, &tv, cb * W, h, kt * BK, s, b, &br[4 + st]);
      }
    };
    const int n0 = ns_of(0) * nkt, n1 = ns_of(1) * nkt;
    for (int t = 0; t < max(n0, n1); ++t) {
      if (t < n0) issue(0, t);
      if (t < n1) issue(1, t);
    }
    return;
  }

  const int c = threadIdx.x / 128;  // this thread's warpgroup
  T* Qs = qs_of(c);
  T* KVs = Qs + 2 * TILE;
  float* b1s = b1s_all + c * 2 * cols;
  uint64_t* q_full = bars_of(c);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_full + 4;
  uint64_t* empty = full + ST;
  const int n = ns_of(c) * nkt;

  const int tid = threadIdx.x - 128 * c;
  const int lane = tid & 31;
  const int lrow = 16 * (tid >> 5) + (lane >> 2);  // this lane's rows: lrow, lrow + 8
  const int cq = (lane & 3) * 2;                   // and its column pair
  const float scale2 = a.sm_scale * kLog2e;
  const float* b2r0 = b2s + lrow * a.ldb;
  const float* b2r1 = b2r0 + 8 * a.ldb;

  // O is zeroed once: a new s starts from m = -1e30, whose alpha (0) clears
  // the previous s's sums on its first tile, so no instruction but wgmma
  // and that rescale defines the accumulators inside the loop
  float o[D / 2], s[BK / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // S = Q K^T of stream tile t, committed
  auto qk = [&](int t, const T* Qc) {
    const int stage = t % ST;
    mbar_wait(&full[stage], (t / ST) & 1);
    const T* Kc = KVs + stage * 2 * KT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk * 16 / W, off = kk * 16 % W;
      WgmmaSS<T, BK>::run(s, gmma_desc_sw<W>(Qc + cb * W * kB + off, 16, SBO),
                          gmma_desc_sw<W>(Kc + cb * W * BK + off, 16, SBO), kk > 0);
    }
    wg_commit();
  };
  // O += P V of stream tile t (P in pf), committed; V read MN-major
  auto pv = [&](int t) {
    const T* Vc = KVs + (t % ST) * 2 * KT + KT;
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq)
      WgmmaRS<T, D>::run(o, pf[kq], gmma_desc_sw<W>(Vc + kq * 16 * W, W * BK * 2, SBO));
    wg_commit();
  };

  for (int t = 0; t < n; ++t) {
    const int j = t / nkt, kt = t % nkt;
    const int qb = j & 1;
    const int sj = s0 + c + 2 * j;
    const int k0 = kt * BK;
    if (kt == 0) {  // a new s: its Q tile (and bias1 row), fresh statistics
      if (a.b1 != nullptr && !b1_bulk) {  // rows off 16 bytes: the warpgroup loads it
        const float* src = a.b1 + ((long long)b * a.S + sj) * a.K;
        for (int i = tid; i < a.K; i += 128) b1s[qb * cols + i] = __ldg(src + i);
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      }
      mbar_wait(&q_full[qb], (j >> 1) & 1);
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
    }
    qk(t, Qs + qb * TILE);
    if (kt > 0) {
      pv(t - 1);
      wg_wait<1>();  // S of tile t is done; P V of tile t - 1 runs on
    } else {
      wg_wait<0>();
    }
    pin(s);
    const float* b1r = b1s + qb * cols + k0;
    if (k0 + BK > a.K)
      evo_scores<B2, true, BK>(s, b2r0 + k0, b2r1 + k0, b1r, k0, cq, a.K, scale2);
    else
      evo_scores<B2, false, BK>(s, b2r0 + k0, b2r1 + k0, b1r, k0, cq, a.K, scale2);
    // online softmax of the lane's two rows (element i is row (i >> 1) & 1)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = ex2(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;
      s[i] = p;
    }
    wg_wait<0>();  // P V of tile t - 1: its stage is free, O may be rescaled
    pin(o);
    pin(pf);
    if (kt > 0) mbar_arrive(&empty[(t - 1) % ST]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_a<T, BK>(pf, s);
    if (kt == nkt - 1) {  // the s's last tile: its P V, then its output
      pv(t);
      wg_wait<0>();
      pin(o);
      pin(pf);
      mbar_arrive(&empty[t % ST]);
      mbar_arrive(&q_empty[qb]);
      const float lc[2] = {fmaxf(quad_sum(l[0]), 1e-30f), fmaxf(quad_sum(l[1]), 1e-30f)};
      const long long bs = (long long)b * a.S + sj;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + lrow + 8 * r;
        if (qi >= a.Q) continue;
        T* orow = static_cast<T*>(a.o) + ((bs * a.Q + qi) * a.H + h) * D;
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd)
          *reinterpret_cast<uint32_t*>(orow + 8 * jd + cq) =
              Cvt<T>::pack(o[4 * jd + 2 * r] / lc[r], o[4 * jd + 2 * r + 1] / lc[r]);
        if ((lane & 3) == 0) a.lse[(bs * a.H + h) * a.Q + qi] = m[r] * kLn2 + logf(lc[r]);
      }
    }
  }
}

// ===========================================================================
// kernel E': dQ and dbias1.  fp32: one block per (b, s, chunk) on the FMA
// pipes, the chunk's units (h, query tile) pairs, h major (with no bias1
// every unit is a chunk).  bf16/fp16: the wgmma kernel further down.
// ===========================================================================
__device__ __forceinline__ void unit_range(const Args& a, int chunk, int units, int* u0, int* u1) {
  const int per = cdiv(units, a.chunks);
  *u0 = min(units, chunk * per);
  *u1 = min(units, *u0 + per);
}

// the block's n_rows dbias1 rows (one, or one per warp) added in order, to
// db1 or to the chunk's partial row, by threads [0, threads): columns
// [k_lo, k_hi) of the key range held by rows of Kp floats
__device__ __forceinline__ void store_db1(const Args& a, const float* rows, int n_rows, int Kp,
                                          long long bs, int chunk, int k_lo, int k_hi,
                                          int threads) {
  float* dst = a.chunks > 1 ? a.part + (bs * a.chunks + chunk) * a.K : a.db1 + bs * a.K;
  for (int col = k_lo + threadIdx.x; col < k_hi; col += threads) {
    float v = rows[col - k_lo];
    for (int w = 1; w < n_rows; ++w) v += rows[w * Kp + col - k_lo];
    dst[col] = v;
  }
}

// E''s block: (b * S + s, chunk, key range), and the key tiles [t0, t1) of
// its range
struct DqBlock {
  int bs, chunk, t0, t1;
  __device__ DqBlock(const Args& a) {
    const int kr = blockIdx.x % a.kranges;
    const int x = blockIdx.x / a.kranges;
    chunk = x % a.chunks;
    bs = x / a.chunks;
    const int n_tiles = cdiv(a.K, kB), per = cdiv(n_tiles, a.kranges);
    t0 = min(n_tiles, kr * per);
    t1 = min(n_tiles, t0 + per);
  }
};

template <int D>
constexpr size_t dq_fma_tiles() {  // Q, dO, K, V tiles + dS, fp32
  return sizeof(float) * (4 * kB * (D + 1) + kB * (kB + 1));
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads) evo_bwd_dq_fma_kernel(Args a) {
  constexpr int DP = D + 1, PP = kB + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [kB][DP]
  float* dOs = Qs + kB * DP;   // [kB][DP]
  float* Ks = dOs + kB * DP;   // [kB][DP]
  float* Vs = Ks + kB * DP;    // [kB][DP]
  float* dSs = Vs + kB * DP;   // [kB][PP]
  float* b1s = dSs + kB * PP;  // [kB]
  float* b2s = b1s + kB;       // [kB][kB2Ld]
  float* db1s = b2s + kB * kB2Ld;  // [Kp]
  __shared__ float lse_s[kB], delta_s[kB];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const DqBlock blk(a);
  const int chunk = blk.chunk, bs = blk.bs;
  const int s = bs % a.S, b = bs / a.S;
  const int nq = cdiv(a.Q, kB), t0 = blk.t0, n_tiles = blk.t1, Kp = cdiv(cdiv(a.K, kB), a.kranges) * kB;
  const int k_lo = t0 * kB;
  const bool want_db1 = a.db1 != nullptr;
  int u0, u1;
  unit_range(a, chunk, a.H * nq, &u0, &u1);
  if (want_db1)
    for (int i = tid; i < Kp; i += kFmaThreads) db1s[i] = 0.f;

  for (int u = u0; u < u1; ++u) {
    const int h = u / nq, q_start = (u % nq) * kB;
    const float* qb = static_cast<const float*>(a.q) + b * a.qsb + s * a.qss + h * a.qsh;
    const float* ob = static_cast<const float*>(a.dout) + b * a.dsb + s * a.dss + h * a.dsh;
    const float* kb = static_cast<const float*>(a.k) + b * a.ksb + s * a.kss + h * a.ksh;
    const float* vb = static_cast<const float*>(a.v) + b * a.vsb + s * a.vss + h * a.vsh;
    const BiasSrc bias(a, b, s, h);
    const float* b1c = bias.b1 ? b1s : nullptr;
    const float* b2c = bias.b2 ? b2s : nullptr;
    const long long rowbase = ((long long)bs * a.H + h) * a.Q;
    __syncthreads();  // the previous unit is done with Qs/dOs/lse_s
    stage_rows<D>(Qs, qb, a.qsn, q_start, a.Q);
    stage_rows<D>(dOs, ob, a.dsn, q_start, a.Q);
    if (tid < kB) {
      const int qi = q_start + tid;
      lse_s[tid] = qi < a.Q ? a.lse_in[rowbase + qi] : 0.f;
      delta_s[tid] = qi < a.Q ? a.delta[rowbase + qi] : 0.f;
    }
    float acc[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

    for (int t = t0; t < n_tiles; ++t) {
      const int k0 = t * kB;
      __syncthreads();  // the previous tile's readers are done with Ks/Vs/dSs
      bias.stage(b1s, b2s, kB2Ld, q_start, kB, k0);
      cp_async_commit();
      stage_rows<D>(Ks, kb, a.ksn, k0, a.K);
      stage_rows<D>(Vs, vb, a.vsn, k0, a.K);
      cp_async_wait<0>();
      __syncthreads();
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[r][j] = dp[r][j] = 0.f;
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
            sc[r][j] = fmaf(qv[r], kv[j], sc[r][j]);
            dp[r][j] = fmaf(ov[r], vv[j], dp[r][j]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lr = ty * 4 + r, row = q_start + lr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lc = tx + 16 * j;
          float p = 0.f;
          if (row < a.Q && k0 + lc < a.K)
            p = expf(add_bias(sc[r][j] * a.sm_scale, b1c, b2c, kB2Ld, lr, lc) - lse_s[lr]);
          dSs[lr * PP + lc] = p * (dp[r][j] - delta_s[lr]);
        }
      }
      __syncthreads();  // dbias1 reads every row of dS
      if (want_db1 && tid < kB) {
        float v = 0.f;
        for (int r = 0; r < kB; ++r) v += dSs[r * PP + tid];
        db1s[k0 - k_lo + tid] += v;
      }
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
      if (qi >= a.Q) continue;
      const long long off = (((long long)bs * a.Q + qi) * a.H + h) * D;
      // this key range's partial when the key axis is cut
      float* row = a.kranges > 1
                       ? a.dq_part + (long long)(blockIdx.x % a.kranges) * a.B * a.S * a.Q * a.H * D + off
                       : dq + off;
#pragma unroll
      for (int c = 0; c < NC; ++c) row[tx + 16 * c] = acc[r][c] * a.sm_scale;
    }
  }
  if (want_db1) {
    __syncthreads();
    store_db1(a, db1s, 1, Kp, bs, chunk, k_lo, min(a.K, n_tiles * kB), kFmaThreads);
  }
}

// ===========================================================================
// kernel E'': dK, dV and dbias2.  One block per (b, h, 64-key tile, chunk of
// s, query range).  With no bias2 every s is a chunk.
// ===========================================================================
template <int D>
constexpr size_t dkv_fma_tiles() {  // K, V, Q, dO tiles + P^T, dS^T, fp32
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * (kB + 1));
}

// query tiles of bq rows per query range (the last range may hold fewer)
__host__ __device__ __forceinline__ int range_tiles(int Q, int bq, int qranges) {
  return cdiv(cdiv(Q, bq), qranges);
}

struct DkvBlock {
  int b, h, k_start, chunk, s0, s1;
  int range, it0, it1;  // the query tiles [it0, it1) of this block's range
  __device__ DkvBlock(const Args& a, int bq) {
    const int nk = cdiv(a.K, kB);
    range = blockIdx.x % a.qranges;
    const int x = blockIdx.x / a.qranges;
    chunk = x % a.chunks;
    const int r = x / a.chunks;
    k_start = (r % nk) * kB;
    const int bh = r / nk;
    h = bh % a.H;
    b = bh / a.H;
    const int per = cdiv(a.S, a.chunks);
    s0 = min(a.S, chunk * per);
    s1 = min(a.S, s0 + per);
    const int tiles = range_tiles(a.Q, bq, a.qranges);
    it0 = range * tiles;
    it1 = min(cdiv(a.Q, bq), it0 + tiles);
  }
};

// the block's dbias2 rows [it0 * bq, min(Q, it1 * bq)) x columns [k_start,
// k_start + 64), to db2 or to the chunk's partial; db2s holds the range's
// rows from local row 0
__device__ __forceinline__ void store_db2(const Args& a, const float* db2s, const DkvBlock& blk,
                                          int bq) {
  const long long bh = (long long)blk.b * a.H + blk.h;
  float* dst = a.chunks > 1 ? a.part + (bh * a.chunks + blk.chunk) * a.Q * a.K
                            : a.db2 + bh * a.Q * a.K;
  const int row0 = blk.it0 * bq, rows = min(a.Q, blk.it1 * bq) - row0;
  for (int i = threadIdx.x; i < rows * kB; i += blockDim.x) {
    const int row = i / kB, lk = i % kB;
    if (blk.k_start + lk < a.K)
      dst[(long long)(row0 + row) * a.K + blk.k_start + lk] = db2s[row * kDbPad + lk];
  }
}

// the fp32 dK (dv = false) or dV partial of query range `range`, when the
// query axis is cut into ranges
template <int D>
__device__ __forceinline__ float* kv_partial(const Args& a, int range, bool dv) {
  const long long n = (long long)a.B * a.S * a.K * a.H * D;
  return a.kv_part + (2LL * range + (dv ? 1 : 0)) * n;
}

// ---------------------------------------------------------------------------
// kernel E'', bf16 and fp16: wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int kDkvThreads = 256;  // two consumer warpgroups; thread 0 issues the copies

// query rows of a pipeline step, half to each warpgroup: 128 up to D = 32,
// 64 past it (the D-wide dK/dV accumulators in registers, the stage in
// shared memory beside the dbias2 accumulator)
template <int D>
__host__ __device__ constexpr int dkv_rows() {
  return D <= 32 ? 128 : 64;
}

// E''s dynamic shared memory: alignment slack | the K and V tiles of two s |
// the ring (per stage: the Q and dO tiles, the bias2 tile) | per stage: lse
// and delta rows | two bias1 rows | the dbias2 accumulator of acc_rows query
// rows | the barriers (full, empty per stage; K/V full and empty per buffer)
template <int D>
__host__ __device__ constexpr size_t dkv_wg_smem(int stages, bool b2, int acc_rows) {
  return 1024 + (size_t)2 * 2 * kB * D * 2 +
         (size_t)stages * (2 * dkv_rows<D>() * D * 2 + (b2 ? dkv_rows<D>() * kB * 4 : 0)) +
         (size_t)stages * 2 * dkv_rows<D>() * 4 + 2 * kB * 4 +
         (b2 ? (size_t)acc_rows * kDbPad * 4 : 0) + (size_t)(2 * stages + 4) * 8;
}

constexpr int kDkvMaxStages = 4;  // E''s deepest ring

// E''s plan in bf16/fp16: the fewest query ranges (whole steps each, none
// empty) whose dbias2 accumulator fits a block beside a ring of two stages,
// then the deepest ring (up to kDkvMaxStages) that fits beside it.  One
// range up to 384 residues at D <= 32 (AlphaFold 2's crops), 448 at D = 64
// and 192 at D = 128; past that each range writes fp32 dK/dV partials that
// the second pass adds in range order.  Returns the ranges; *stages the ring.
template <int D>
int dkv_wg_plan(int Q, bool b2, int* stages) {
  constexpr int R = dkv_rows<D>();
  const size_t limit = (size_t)kMaxSmem - 2048;
  const int nq = cdiv(Q, R);
  for (int r = 1; r <= nq; ++r) {
    const int qranges = cdiv(nq, range_tiles(Q, R, r));  // no empty range
    const int rows = range_tiles(Q, R, qranges) * R;
    if (dkv_wg_smem<D>(2, b2, rows) > limit) continue;
    int st = 2;
    while (st < kDkvMaxStages && dkv_wg_smem<D>(st + 1, b2, rows) <= limit) ++st;
    *stages = st;
    return qranges;
  }
  return 0;  // one step always fits
}

// P^T of one 64-key x BQ-query tile in place of S^T.  Element i = 4 jj + e
// is key key0 + 8 (e >> 1), query q0 + 8 jj + cq + (e & 1).  The score
// takes the biases and lse in the plain version's order, in natural-log
// units, before the one conversion to log2 units and ex2: a row masked by
// -1e9 then rounds as the plain version and the TPU kernel round it
// (ROADMAP Queue 3 #F3).  b2c: the warpgroup's rows of the stage's bias2
// tile, b2col the lane's swizzled columns per key and column parity.
template <bool B2, bool EDGE, int BQ>
__device__ __forceinline__ void dkv_wg_probs(float (&s)[BQ / 2], const float* b2c,
                                             const int (&b2col)[2][2], const float (&b1k)[2],
                                             const float (&lse)[BQ / 4], int q0, int key0, int cq,
                                             int Q, int K, float sm_scale) {
#pragma unroll
  for (int jj = 0; jj < BQ / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jj + e, r = e >> 1, par = e & 1;
      const int lq = 8 * jj + cq + par;
      float x = fmaf(s[i], sm_scale, b1k[r]);
      if (B2) x += b2c[lq * 32 + b2col[r][par]];
      float p = ex2((x - lse[2 * jj + par]) * kLog2e);
      if (EDGE && !(q0 + lq < Q && key0 + 8 * r < K)) p = 0.f;
      s[i] = p;
    }
  }
}

// One block of two consumer warpgroups per (b, h, 64-key tile, chunk of s,
// query range).  The block walks one stream of (s, query step) pairs; each
// step's R query rows are half for each warpgroup, which hold the same 64
// keys' dK and dV in fp32 registers over the s's steps.  Thread 0 keeps the
// ring kAhead steps ahead: the Q and dO tiles (5-D TMA maps, swizzled at W
// columns), the bias2 tile [R][64] (a 3-D TMA map over bias2, two boxes of
// 32 keys swizzled at 128 bytes) and the lse and delta rows (bulk copies);
// the next s's K and V tiles and bias1 row land in the other buffer under
// the current s, so the ring never drains at an s boundary.  Products:
// S^T = K Q^T and dP^T = V dO^T by wgmma m64nBQk16 (both operands K-major
// in shared memory), then dV += P^T dO and dK += dS^T Q by m64nDk16 with
// P^T and dS^T from registers (rounded to T only as tensor-core operands)
// and dO and Q read MN-major; the first product of an s starts the sums.
// dbias2: each dS^T element is added by the one thread that owns it into
// the range's [rows][64 + 4] fp32 accumulator, over the chunk's s in
// order.  At an s's last step warpgroup 1's dK (then dV) sums join
// warpgroup 0's through the s's K/V tiles, which are free by then, and
// warpgroup 0 stores them (fp32 partials when the query axis is cut).
template <typename T, int D, bool B2>
__global__ void __launch_bounds__(kDkvThreads, 1)
    evo_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tb2, const Args a) {
  constexpr int W = evo_w<D>();
  constexpr int R = dkv_rows<D>(), BQ = R / 2;
  constexpr int KVT = kB * D;  // elements of a K or V tile
  constexpr int QT = R * D;    // elements of a Q or dO tile
  constexpr int B2T = R * kB;  // floats of a bias2 tile
  constexpr uint32_t SBO = 16 * W;
  constexpr size_t kStage = 2 * QT * sizeof(T) + (B2 ? B2T * 4 : 0);
  const int ST = a.dkv_stages;
  extern __shared__ unsigned char smem_raw[];
  // swizzling repeats every 1024 bytes: tiles start on that
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* kvs = reinterpret_cast<T*>(base);  // [2][K, V][D/W][64][W]
  unsigned char* ring = base + (size_t)2 * 2 * KVT * sizeof(T);
  float* stats = reinterpret_cast<float*>(ring + ST * kStage);  // [ST][lse, delta][R]
  float* b1s = stats + ST * 2 * R;                               // [2][64]
  float* db2s = b1s + 2 * kB;                                    // [acc_rows][kDbPad]
  const int acc_rows = range_tiles(a.Q, R, a.qranges) * R;
  uint64_t* full = reinterpret_cast<uint64_t*>(db2s + (B2 ? acc_rows * kDbPad : 0));
  uint64_t* empty = full + ST;
  uint64_t* kv_full = empty + ST;
  uint64_t* kv_empty = kv_full + 2;

  const DkvBlock blk(a, R);
  const int b = blk.b, h = blk.h, k0 = blk.k_start;
  const int qr0 = blk.it0 * R;  // first row of this block's query range
  const int nqt = blk.it1 - blk.it0;
  const int n = (blk.s1 - blk.s0) * nqt;
  const int bh = b * a.H + h;
  // steps in flight ahead of the one computed: at most a stage short of the
  // ring, and at most an s's steps, so that thread 0 never waits on a
  // release that it gives itself later in the same step
  const int ahead = min(ST >= 4 ? ST - 2 : ST - 1, nqt);

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kDkvThreads);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], kDkvThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // lse, delta and bias1 entries that a ragged copy stops short of keep
  // finite values (their scores are masked)
  for (int i = threadIdx.x; i < ST * 2 * R + 2 * kB; i += kDkvThreads) stats[i] = 0.f;
  if (B2)
    for (int i = threadIdx.x; i < acc_rows * kDbPad; i += kDkvThreads) db2s[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the copies land
  __syncthreads();

  // bias1 keys [k0, k0 + nb1) of a row padded to ldb floats (a multiple of 4)
  const int nb1 = a.b1 != nullptr ? min(kB, a.ldb - k0) : 0;
  auto issue = [&](int t) {
    const int j = t / nqt, qi = t % nqt;
    const int s = blk.s0 + j;
    if (qi == 0) {  // an s's first step: its K and V tiles and bias1 row
      const int kb = j & 1;
      if (j >= 2) mbar_wait(&kv_empty[kb], ((j >> 1) - 1) & 1);
      mbar_arrive_tx(&kv_full[kb], 2 * KVT * sizeof(T) + nb1 * 4);
      T* Kd = kvs + kb * 2 * KVT;
#pragma unroll
      for (int cb = 0; cb < D / W; ++cb) {
        tma_load_5d(Kd + cb * W * kB, &tk, cb * W, h, k0, s, b, &kv_full[kb]);
        tma_load_5d(Kd + KVT + cb * W * kB, &tv, cb * W, h, k0, s, b, &kv_full[kb]);
      }
      if (nb1 > 0)
        bulk_copy(b1s + kb * kB, a.b1 + ((long long)b * a.S + s) * a.ldb + k0, nb1 * 4,
                  &kv_full[kb]);
    }
    const int st = t % ST;
    if (t >= ST) mbar_wait(&empty[st], (t / ST - 1) & 1);
    const int q0 = (blk.it0 + qi) * R;
    const int nst = min(R, a.ldq - q0);  // lse and delta floats (ldq a multiple of 4)
    unsigned char* sb = ring + st * kStage;
    T* Qd = reinterpret_cast<T*>(sb);
    mbar_arrive_tx(&full[st], 2 * QT * sizeof(T) + (B2 ? B2T * 4 : 0) + 2 * nst * 4);
#pragma unroll
    for (int cb = 0; cb < D / W; ++cb) {
      tma_load_5d(Qd + cb * W * R, &tq, cb * W, h, q0, s, b, &full[st]);
      tma_load_5d(Qd + QT + cb * W * R, &tdo, cb * W, h, q0, s, b, &full[st]);
    }
    if (B2) {
      float* b2d = reinterpret_cast<float*>(sb + 2 * QT * sizeof(T));
      tma_load_3d(b2d, &tb2, k0, q0, bh, &full[st]);
      tma_load_3d(b2d + R * 32, &tb2, k0 + 32, q0, bh, &full[st]);
    }
    const long long row = (((long long)b * a.S + s) * a.H + h) * a.ldq + q0;
    bulk_copy(stats + st * 2 * R, a.lse_in + row, nst * 4, &full[st]);
    bulk_copy(stats + st * 2 * R + R, a.delta + row, nst * 4, &full[st]);
  };

  const int c = threadIdx.x >> 7;  // this thread's warpgroup: rows [c BQ, (c + 1) BQ) of a step
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int krow = 16 * (tid >> 5) + (lane >> 2);  // the lane's keys: krow, krow + 8 of the tile
  const int cq = (lane & 3) * 2;                   // and its query column pair
  // the lane's bias2 entries in a stage's tile, swizzled at 128 bytes (a
  // row's 16-byte chunks XOR the row mod 8, here cq + parity): per key r
  // and column parity e, the offset from the row's start
  int b2col[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kl = krow + 8 * r;
      b2col[r][e] = (kl >> 5) * R * 32 + ((((kl & 31) >> 2) ^ (cq + e)) << 2) + (kl & 3);
    }

  float dk[D / 2], dv[D / 2], s[BQ / 2], dp[BQ / 2];
  uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
  if (threadIdx.x == 0)
    for (int t = 0; t < min(n, ahead); ++t) issue(t);
  float b1k[2] = {0.f, 0.f};

  for (int t = 0; t < n; ++t) {
    if (threadIdx.x == 0 && t + ahead < n) issue(t + ahead);
    const int j = t / nqt, qi = t % nqt, kb = j & 1;
    const int st = t % ST;
    const int q0 = (blk.it0 + qi) * R + c * BQ;  // this warpgroup's first query row
    const T* Kc = kvs + kb * 2 * KVT;
    const T* Vc = Kc + KVT;
    if (qi == 0) {  // a new s: its K/V tiles and the lane's two bias1 entries
      mbar_wait(&kv_full[kb], (j >> 1) & 1);
      b1k[0] = b1s[kb * kB + krow];
      b1k[1] = b1s[kb * kB + krow + 8];
    }
    mbar_wait(&full[st], (t / ST) & 1);
    const unsigned char* sb = ring + st * kStage;
    const T* Qc = reinterpret_cast<const T*>(sb);
    const T* dOc = Qc + QT;
    const float* b2c = reinterpret_cast<const float*>(sb + 2 * QT * sizeof(T)) + c * BQ * 32;
    const float* lsc = stats + st * 2 * R + c * BQ;
    float lse[BQ / 4], dl[BQ / 4];
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(lsc + 8 * jj + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(lsc + R + 8 * jj + cq);
      lse[2 * jj] = l2.x;
      lse[2 * jj + 1] = l2.y;
      dl[2 * jj] = d2.x;
      dl[2 * jj + 1] = d2.y;
    }

    // S^T = K Q^T, then dP^T = V dO^T (64 keys x BQ queries)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk * 16 / W, off = kk * 16 % W;
      WgmmaSS<T, BQ>::run(s, gmma_desc_sw<W>(Kc + cb * W * kB + off, 16, SBO),
                          gmma_desc_sw<W>(Qc + cb * W * R + c * BQ * W + off, 16, SBO), kk > 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk * 16 / W, off = kk * 16 % W;
      WgmmaSS<T, BQ>::run(dp, gmma_desc_sw<W>(Vc + cb * W * kB + off, 16, SBO),
                          gmma_desc_sw<W>(dOc + cb * W * R + c * BQ * W + off, 16, SBO), kk > 0);
    }
    wg_commit();
    wg_wait<1>();
    pin(s);
    if (q0 + BQ > a.Q || k0 + kB > a.K)  // the ragged edge: masked elements
      dkv_wg_probs<B2, true, BQ>(s, b2c, b2col, b1k, lse, q0, k0 + krow, cq, a.Q, a.K,
                                 a.sm_scale);
    else
      dkv_wg_probs<B2, false, BQ>(s, b2c, b2col, b1k, lse, q0, k0 + krow, cq, a.Q, a.K,
                                  a.sm_scale);
    pack_a<T, BQ>(pf, s);
    wg_wait<0>();
    pin(dp);
    const int more = qi > 0;  // 0: the s's first step starts the dK/dV sums
    // dV += P^T dO (dO read MN-major) runs while dS^T is formed
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq)
      WgmmaRS<T, D>::run(dv, pf[kq],
                          gmma_desc_sw<W>(dOc + c * BQ * W + kq * 16 * W, W * R * 2, SBO),
                          more | kq);
    wg_commit();
    // dS^T = P^T (dP^T - delta) in place of dP^T, and into dbias2
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) dp[i] = s[i] * (dp[i] - dl[2 * (i >> 2) + (i & 1)]);
    if (B2) {
      float* acc = db2s + (q0 - qr0 + cq) * kDbPad + krow;
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[(8 * jj + (e & 1)) * kDbPad + 8 * (e >> 1)] += dp[4 * jj + e];
    }
    pack_a<T, BQ>(dsf, dp);
    // dK += dS^T Q (Q read MN-major)
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq)
      WgmmaRS<T, D>::run(dk, dsf[kq],
                          gmma_desc_sw<W>(Qc + c * BQ * W + kq * 16 * W, W * R * 2, SBO),
                          more | kq);
    wg_commit();
    wg_wait<0>();
    pin(dv);
    pin(dk);
    pin(pf);
    pin(dsf);
    mbar_arrive(&empty[st]);

    if (qi == nqt - 1) {
      // the s's dK and dV: warpgroup 1's sums join warpgroup 0's through the
      // s's K and V tiles (256 D bytes: dK, then dV), free once both
      // warpgroups are past their products
      float* xb = reinterpret_cast<float*>(kvs + kb * 2 * KVT);
      __syncthreads();
      if (c == 1)
#pragma unroll
        for (int i = 0; i < D / 2; ++i) xb[i * 128 + tid] = dk[i];
      __syncthreads();
      if (c == 0)
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk[i] += xb[i * 128 + tid];
      __syncthreads();
      if (c == 1)
#pragma unroll
        for (int i = 0; i < D / 2; ++i) xb[i * 128 + tid] = dv[i];
      __syncthreads();
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dv[i] += xb[i * 128 + tid];
        const long long bs = (long long)b * a.S + blk.s0 + j;
        float* dkf = a.qranges > 1 ? kv_partial<D>(a, blk.range, false) : nullptr;
        float* dvf = a.qranges > 1 ? kv_partial<D>(a, blk.range, true) : nullptr;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = k0 + krow + 8 * r;
          if (key >= a.K) continue;
          const long long off = ((bs * a.K + key) * a.H + h) * D;
#pragma unroll
          for (int jd = 0; jd < D / 8; ++jd) {
            const float k0v = dk[4 * jd + 2 * r] * a.sm_scale;
            const float k1v = dk[4 * jd + 2 * r + 1] * a.sm_scale;
            const float v0 = dv[4 * jd + 2 * r], v1 = dv[4 * jd + 2 * r + 1];
            if (dkf != nullptr) {  // this query range's fp32 partials
              *reinterpret_cast<float2*>(dkf + off + 8 * jd + cq) = make_float2(k0v, k1v);
              *reinterpret_cast<float2*>(dvf + off + 8 * jd + cq) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<uint32_t*>(static_cast<T*>(a.dk) + off + 8 * jd + cq) =
                  Cvt<T>::pack(k0v, k1v);
              *reinterpret_cast<uint32_t*>(static_cast<T*>(a.dv) + off + 8 * jd + cq) =
                  Cvt<T>::pack(v0, v1);
            }
          }
        }
      }
      // the generic writes to the tiles before TMA refills them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&kv_empty[kb]);
    }
  }
  if (B2) {
    __syncthreads();
    store_db2(a, db2s, blk, R);
  }
}

// ---------------------------------------------------------------------------
// kernel E', bf16 and fp16: wgmma fed by TMA, K and V resident per head
// ---------------------------------------------------------------------------
constexpr int kDqThreads = 256;  // two consumer warpgroups (+ a producer warp)
constexpr int kDqRows = 128;     // query rows of a step, 64 per warpgroup
constexpr int kDqMaxB2Stages = 4;

// keys per tile: 64 up to D = 64, 32 at D = 128 (S, dP and the D-wide dQ
// accumulators in registers under the producer warp's 168-register cap)
template <int D>
__host__ __device__ constexpr int dq_bk() {
  return D <= 64 ? 64 : 32;
}

// E''s plan in bf16/fp16, the library's own: the key ranges and their tiles,
// the rings, and the chunks of heads a (b, s) is cut into
struct DqPlan {
  int kranges, chunks;
  int resident;   // 1: K/V tiles stay for every step of a head
  int kv_stages;  // resident: one or two heads' tiles of the range; else the ring
  int q_stages, b2_stages;
};

// E''s dynamic shared memory: alignment slack | the K/V tiles | the Q ring
// (per stage: Q and dO tiles, lse and delta rows) | the bias2 ring | the
// key range's bias1 row | 8 warps' dbias1 rows | the barriers
template <int D>
__host__ __device__ constexpr size_t dq_wg_smem(int kv_stages, int q_stages, int b2_stages,
                                                int Kp, bool db1) {
  return 1024 + (size_t)kv_stages * 2 * dq_bk<D>() * D * 2 +
         (size_t)q_stages * (2 * kDqRows * D * 2 + 2 * kDqRows * 4) +
         (size_t)b2_stages * kDqRows * dq_bk<D>() * 4 + (size_t)Kp * 4 +
         (db1 ? (size_t)8 * Kp * 4 : 0) + (size_t)(2 * (q_stages + kv_stages + b2_stages) + 1) * 8;
}

// The fewest key ranges (whole tiles each, none empty) whose smallest
// layout fits a block: K/V resident for a head (else a ring of two tiles),
// two Q stages, two bias2 stages.  Then, while they fit: a deeper bias2 ring
// (up to 4: a tile of it serves one key tile only), two heads of K/V
// resident (the next head's tiles land under the current head's steps),
// three Q stages.  The heads of a (b, s) are cut into chunks while the
// grid would not cover the SMs once.  One range up to ~5,500 keys at D = 32.
template <int D>
DqPlan dq_wg_plan(int B, int S, int K, int H, bool b2, bool db1, int sms) {
  constexpr int BK = dq_bk<D>();
  const size_t limit = (size_t)kMaxSmem - 2048;
  const int nk = cdiv(K, BK);
  for (int r = 1; r <= nk; ++r) {
    DqPlan p{};
    p.kranges = cdiv(nk, cdiv(nk, r));  // no empty range
    const int nt = cdiv(nk, p.kranges), Kp = nt * BK;
    auto fits = [&](int kv, int q, int b) { return dq_wg_smem<D>(kv, q, b, Kp, db1) <= limit; };
    p.q_stages = 2;
    p.b2_stages = b2 ? 2 : 0;
    if (fits(nt, 2, p.b2_stages)) {
      p.resident = 1;
      p.kv_stages = nt;
    } else if (fits(2, 2, p.b2_stages)) {
      p.kv_stages = 2;
    } else {
      continue;
    }
    while (b2 && p.b2_stages < kDqMaxB2Stages && fits(p.kv_stages, 2, p.b2_stages + 1))
      ++p.b2_stages;
    if (p.resident && fits(2 * nt, 2, p.b2_stages)) p.kv_stages = 2 * nt;
    if (!p.resident)
      while (p.kv_stages < 4 && fits(p.kv_stages + 1, 2, p.b2_stages)) ++p.kv_stages;
    if (fits(p.kv_stages, 3, p.b2_stages)) p.q_stages = 3;
    const long long blocks = (long long)B * S * p.kranges;
    p.chunks = blocks >= sms || blocks == 0 ? 1 : (int)min((long long)H, (sms + blocks - 1) / blocks);
    return p;
  }
  return DqPlan{};  // a tile always fits
}

// dS of one 64-query x BK-key tile in place of dP, S's P on the way, from
// the plain version's order of operations: x = s * sm_scale + bias1 +
// bias2, p = exp(x - lse) (taken as ex2((x - lse) log2 e), so a row masked
// by -1e9 rounds as the plain version's does: #F3), ds = p (dp - delta).
// Element i = 4 j + e is row lrow + 8 (e >> 1), key k0 + 8 j + cq + (e & 1);
// b2 is the stage's bias2 tile (boxes of 32 keys, 128-byte swizzled rows),
// b1 the bias1 row at k0.  EDGE: rows past Q and keys past K give 0.
template <bool B2, bool EDGE, int BK>
__device__ __forceinline__ void dq_ds(float (&s)[BK / 2], float (&dp)[BK / 2], const float* b2,
                                      const float* b1, const float (&lse)[2],
                                      const float (&dl)[2], int lrow, int q_row, int k0, int cq,
                                      int Q, int K, float sm_scale) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float2 c = *reinterpret_cast<const float2*>(b1 + 8 * j + cq);
    const int kl = 8 * j + cq;  // the pair's first key in the tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lrow + 8 * r;  // in the step's tile
      float2 bb = make_float2(0.f, 0.f);
      if (B2)
        bb = *reinterpret_cast<const float2*>(
            b2 + (kl >> 5) * kDqRows * 32 + row * 32 + (((((kl & 31) >> 2) ^ (row & 7))) << 2) +
            (kl & 3));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        float x = fmaf(s[i], sm_scale, e ? c.y : c.x);
        if (B2) x += e ? bb.y : bb.x;
        float p = ex2((x - lse[r]) * kLog2e);
        if (EDGE && !(q_row + 8 * r < Q && k0 + kl + e < K)) p = 0.f;
        dp[i] = p * (dp[i] - dl[r]);
      }
    }
  }
}

// One block of two consumer warpgroups and a producer warp per (b, s, chunk
// of heads, key range).  The block walks the chunk's heads and, for each,
// its steps of 128 query rows; each warpgroup takes 64 rows of a step and
// walks the range's key tiles: S = Q K^T and dP = dO V^T by wgmma m64nBKk16
// (both operands K-major in shared memory), dS formed in registers in
// wgmma's A layout, dQ += dS K by m64nDk16 with K read MN-major from the
// same tile, the first product of a step starting the sums.  S and dP of
// tile t are issued with dQ of tile t - 1.  Where a head's K/V tiles of the
// range fit (kv_stages >= the range's tiles) they are loaded once per head
// and kept for every step; else they stream through a ring once per step.
// One lane of the producer warp walks the same stream the consumers do:
// per step its Q and dO tiles and lse and delta rows (the Q ring), per key
// tile the K and V tiles when they are loaded and the bias2 tile [128][BK]
// (the bias2 ring), so no ring drains at a step or head boundary and a
// head's K/V tiles are replaced as the head's last step releases them.
// dbias1: each warp sums its 16 rows of dS per key by a fixed shuffle tree
// into its own row of shared memory; at the end the 8 rows are added in
// order, to db1 or to the chunk's partial.
template <typename T, int D, bool B2>
__global__ void __launch_bounds__(kDqThreads + 32, 1)
    evo_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tb2, const Args a,
                            const DqPlan plan) {
  constexpr int W = evo_w<D>();
  constexpr int BK = dq_bk<D>(), R = kDqRows;
  constexpr int KVT = BK * D;  // elements of a K or V tile
  constexpr int QT = R * D;    // elements of a Q or dO tile
  constexpr int B2T = R * BK;  // floats of a bias2 tile
  constexpr uint32_t SBO = 16 * W;
  const int KVS = plan.kv_stages, QST = plan.q_stages, BST = plan.b2_stages;
  const bool resident = plan.resident != 0;
  extern __shared__ unsigned char smem_raw[];
  // swizzling repeats every 1024 bytes: tiles start on that
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* kvs = reinterpret_cast<T*>(base);      // [KVS][K, V][D/W][BK][W]
  T* qring = kvs + (size_t)KVS * 2 * KVT;   // [QST][Q, dO][D/W][R][W]
  float* b2ring = reinterpret_cast<float*>(qring + (size_t)QST * 2 * QT);  // [BST][BK/32][R][32]
  float* stats = b2ring + (size_t)BST * B2T;  // [QST][lse, delta][R]

  // block -> (b * S + s, chunk of heads, key range), the key range fastest
  const int kr = blockIdx.x % a.kranges;
  const int chunk = (blockIdx.x / a.kranges) % a.chunks;
  const int bs = blockIdx.x / (a.kranges * a.chunks);
  const int s = bs % a.S, b = bs / a.S;
  const int hper = cdiv(a.H, a.chunks);
  const int h0 = min(a.H, chunk * hper), h1 = min(a.H, h0 + hper);
  const int nk = cdiv(a.K, BK), per = cdiv(nk, a.kranges);
  const int t0 = min(nk, kr * per), nt = min(nk, t0 + per) - t0;
  const int Kp = per * BK, k_lo = t0 * BK;
  const int nqs = cdiv(a.Q, R);
  const int n_steps = (h1 - h0) * nqs;
  float* b1s = stats + (size_t)QST * 2 * R;  // [Kp]: the key range's bias1 row
  float* db1w = b1s + Kp;                    // [8 warps][Kp]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(db1w + (a.db1 != nullptr ? 8 * Kp : 0));
  uint64_t* q_empty = q_full + QST;
  uint64_t* kv_full = q_empty + QST;
  uint64_t* kv_empty = kv_full + KVS;
  uint64_t* b2_full = kv_empty + KVS;
  uint64_t* b2_empty = b2_full + BST;
  uint64_t* b1_full = b2_empty + BST;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QST; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kDqThreads);
    }
    for (int i = 0; i < KVS; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], kDqThreads);
    }
    for (int i = 0; i < BST; ++i) {
      mbar_init(&b2_full[i], 1);
      mbar_init(&b2_empty[i], kDqThreads);
    }
    mbar_init(b1_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // lse, delta and bias1 entries that a ragged copy stops short of keep
  // finite values (their scores are masked); the dbias1 rows start at 0
  for (int i = threadIdx.x; i < QST * 2 * R + Kp + (a.db1 != nullptr ? 8 * Kp : 0);
       i += blockDim.x)
    stats[i] = 0.f;
  fence_proxy_async();  // the zeros, before the copies land
  __syncthreads();

  // the K/V load and the stage of key tile t at step j, and whether the
  // step releases it
  auto kv_load = [&](int j, int t) { return resident ? (j / nqs) * nt + t : j * nt + t; };

  if (threadIdx.x >= kDqThreads) {
    // the producer warp: one lane walks the consumers' stream
    if ((threadIdx.x & 31) != 0) return;
    const int nb1 = a.b1 != nullptr ? min(Kp, a.ldb - k_lo) : 0;
    mbar_arrive_tx(b1_full, nb1 * 4);
    if (nb1 > 0) bulk_copy(b1s, a.b1 + (long long)bs * a.ldb + k_lo, nb1 * 4, b1_full);
    for (int j = 0; j < n_steps; ++j) {
      const int h = h0 + j / nqs, q0 = (j % nqs) * R;
      const int qst = j % QST;
      if (j >= QST) mbar_wait(&q_empty[qst], (j / QST - 1) & 1);
      const int nst = min(R, a.ldq - q0);  // lse and delta floats (ldq a multiple of 4)
      T* Qd = qring + (size_t)qst * 2 * QT;
      mbar_arrive_tx(&q_full[qst], 2 * QT * sizeof(T) + 2 * nst * 4);
#pragma unroll
      for (int cb = 0; cb < D / W; ++cb) {
        tma_load_5d(Qd + cb * W * R, &tq, cb * W, h, q0, s, b, &q_full[qst]);
        tma_load_5d(Qd + QT + cb * W * R, &tdo, cb * W, h, q0, s, b, &q_full[qst]);
      }
      const long long row = ((long long)bs * a.H + h) * a.ldq + q0;
      bulk_copy(stats + qst * 2 * R, a.lse_in + row, nst * 4, &q_full[qst]);
      bulk_copy(stats + qst * 2 * R + R, a.delta + row, nst * 4, &q_full[qst]);
      for (int t = 0; t < nt; ++t) {
        const int k0 = k_lo + t * BK;
        if (!resident || j % nqs == 0) {
          const int n = kv_load(j, t), st = n % KVS;
          if (n >= KVS) mbar_wait(&kv_empty[st], (n / KVS - 1) & 1);
          mbar_arrive_tx(&kv_full[st], 2 * KVT * sizeof(T));
          T* Kd = kvs + (size_t)st * 2 * KVT;
#pragma unroll
          for (int cb = 0; cb < D / W; ++cb) {
            tma_load_5d(Kd + cb * W * BK, &tk, cb * W, h, k0, s, b, &kv_full[st]);
            tma_load_5d(Kd + KVT + cb * W * BK, &tv, cb * W, h, k0, s, b, &kv_full[st]);
          }
        }
        if (B2) {
          const int n = j * nt + t, st = n % BST;
          if (n >= BST) mbar_wait(&b2_empty[st], (n / BST - 1) & 1);
          mbar_arrive_tx(&b2_full[st], B2T * 4);
          float* b2d = b2ring + (size_t)st * B2T;
#pragma unroll
          for (int x = 0; x < BK / 32; ++x)
            tma_load_3d(b2d + x * R * 32, &tb2, k0 + 32 * x, q0, b * a.H + h, &b2_full[st]);
        }
      }
    }
    return;
  }

  const int c = threadIdx.x >> 7;  // this thread's warpgroup: rows [64 c, 64 c + 64) of a step
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int lrow = 64 * c + 16 * warp + (lane >> 2);  // the lane's rows in a step: lrow, lrow + 8
  const int cq = (lane & 3) * 2;                      // and its column pair
  const bool want_db1 = a.db1 != nullptr;
  float* db1r = db1w + (4 * c + warp) * Kp;  // this warp's dbias1 row
  float s_[BK / 2], dp[BK / 2], dq[D / 2];
  uint32_t dsf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s_[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(b1_full, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int h = h0 + j / nqs, q0 = (j % nqs) * R;
    const int qst = j % QST;
    const bool release_kv = !resident || j % nqs == nqs - 1;
    mbar_wait(&q_full[qst], (j / QST) & 1);
    const T* Qc = qring + (size_t)qst * 2 * QT + 64 * c * W;  // this warpgroup's rows
    const T* dOc = Qc + QT;
    const float* lsc = stats + qst * 2 * R;
    const float lse[2] = {lsc[lrow], lsc[lrow + 8]};
    const float dl[2] = {lsc[R + lrow], lsc[R + lrow + 8]};
    const bool ragged_rows = q0 + R > a.Q;

    // S = Q K^T and dP = dO V^T of tile t, committed
    auto sdp = [&](int t) {
      const int n = kv_load(j, t);
      mbar_wait(&kv_full[n % KVS], (n / KVS) & 1);
      const T* Kc = kvs + (size_t)(n % KVS) * 2 * KVT;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk * 16 / W, off = kk * 16 % W;
        WgmmaSS<T, BK>::run(s_, gmma_desc_sw<W>(Qc + cb * W * R + off, 16, SBO),
                            gmma_desc_sw<W>(Kc + cb * W * BK + off, 16, SBO), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk * 16 / W, off = kk * 16 % W;
        WgmmaSS<T, BK>::run(dp, gmma_desc_sw<W>(dOc + cb * W * R + off, 16, SBO),
                            gmma_desc_sw<W>(Kc + KVT + cb * W * BK + off, 16, SBO), kk > 0);
      }
      wg_commit();
    };
    // dQ += dS K of tile t (dS in dsf), committed; K read MN-major
    auto dsk = [&](int t) {
      const T* Kc = kvs + (size_t)(kv_load(j, t) % KVS) * 2 * KVT;
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq)
        WgmmaRS<T, D>::run(dq, dsf[kq], gmma_desc_sw<W>(Kc + kq * 16 * W, W * BK * 2, SBO),
                           (t > 0) | kq);
      wg_commit();
    };

    for (int t = 0; t < nt; ++t) {
      const int k0 = k_lo + t * BK;
      sdp(t);
      if (t > 0) {
        dsk(t - 1);
        wg_wait<1>();  // S and dP of tile t are done; dQ of tile t - 1 runs on
      } else {
        wg_wait<0>();
      }
      pin(s_);
      pin(dp);
      const int nb = j * nt + t;
      const float* b2c = b2ring + (size_t)(nb % BST) * B2T;
      if (B2) mbar_wait(&b2_full[nb % BST], (nb / BST) & 1);
      if (ragged_rows || k0 + BK > a.K)
        dq_ds<B2, true, BK>(s_, dp, b2c, b1s + k0 - k_lo, lse, dl, lrow, q0 + lrow, k0, cq, a.Q,
                            a.K, a.sm_scale);
      else
        dq_ds<B2, false, BK>(s_, dp, b2c, b1s + k0 - k_lo, lse, dl, lrow, q0 + lrow, k0, cq,
                             a.Q, a.K, a.sm_scale);
      if (B2) mbar_arrive(&b2_empty[nb % BST]);
      if (want_db1) {
        // column sums of this warp's 16 rows: a fixed shuffle tree
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          float c0 = dp[4 * jj] + dp[4 * jj + 2], c1 = dp[4 * jj + 1] + dp[4 * jj + 3];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            c0 += __shfl_xor_sync(0xffffffffu, c0, off);
            c1 += __shfl_xor_sync(0xffffffffu, c1, off);
          }
          if (lane < 4) {
            float* w = db1r + k0 - k_lo + 8 * jj + cq;
            w[0] += c0;
            w[1] += c1;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] *= a.sm_scale;
      wg_wait<0>();  // dQ of tile t - 1: its K tile and dS are free
      pin(dq);
      pin(dsf);
      if (t > 0 && release_kv) mbar_arrive(&kv_empty[kv_load(j, t - 1) % KVS]);
      pack_a<T, BK>(dsf, dp);
    }
    dsk(nt - 1);
    wg_wait<0>();
    pin(dq);
    pin(dsf);
    if (release_kv) mbar_arrive(&kv_empty[kv_load(j, nt - 1) % KVS]);
    mbar_arrive(&q_empty[qst]);

    // the step's dQ rows: rounded once, or this key range's fp32 partial
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + lrow + 8 * r;
      if (qi >= a.Q) continue;
      const long long off = (((long long)bs * a.Q + qi) * a.H + h) * D;
      if (a.kranges > 1) {
        float* row = a.dq_part + (long long)kr * a.B * a.S * a.Q * a.H * D + off;
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd)
          *reinterpret_cast<float2*>(row + 8 * jd + cq) =
              make_float2(dq[4 * jd + 2 * r], dq[4 * jd + 2 * r + 1]);
      } else {
        T* row = static_cast<T*>(a.dq) + off;
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd)
          *reinterpret_cast<uint32_t*>(row + 8 * jd + cq) =
              Cvt<T>::pack(dq[4 * jd + 2 * r], dq[4 * jd + 2 * r + 1]);
      }
    }
  }
  if (want_db1) {
    asm volatile("bar.sync 1, %0;\n" ::"r"(kDqThreads) : "memory");  // the consumers only
    store_db1(a, db1w, 8, Kp, bs, chunk, k_lo, min(a.K, k_lo + nt * BK), kDqThreads);
  }
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads) evo_bwd_dkv_fma_kernel(Args a) {
  constexpr int DP = D + 1, PP = kB + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;            // [kB][DP]
  float* Vs = Ks + kB * DP;    // [kB][DP]
  float* Qs = Vs + kB * DP;    // [kB][DP]
  float* dOs = Qs + kB * DP;   // [kB][DP]
  float* Pt = dOs + kB * DP;   // [kB keys][PP]
  float* dSt = Pt + kB * PP;   // [kB keys][PP]
  float* b1s = dSt + kB * PP;  // [kB] of this s
  float* b2s = b1s + kB;       // [kB][kB2LdT]
  float* db2s = b2s + kB * kB2LdT;  // [nq * kB][kDbPad]
  __shared__ float lse_s[kB], delta_s[kB];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const DkvBlock blk(a, kB);
  const int b = blk.b, h = blk.h, k_start = blk.k_start;
  const int qr0 = blk.it0 * kB;  // first row of this block's query range
  const bool want_db2 = a.db2 != nullptr;
  if (want_db2)
    for (int i = tid; i < (blk.it1 - blk.it0) * kB * kDbPad; i += kFmaThreads) db2s[i] = 0.f;

  for (int s = blk.s0; s < blk.s1; ++s) {
    const long long bs = (long long)b * a.S + s;
    const float* kb = static_cast<const float*>(a.k) + b * a.ksb + s * a.kss + h * a.ksh;
    const float* vb = static_cast<const float*>(a.v) + b * a.vsb + s * a.vss + h * a.vsh;
    const float* qb = static_cast<const float*>(a.q) + b * a.qsb + s * a.qss + h * a.qsh;
    const float* ob = static_cast<const float*>(a.dout) + b * a.dsb + s * a.dss + h * a.dsh;
    const long long rowbase = (bs * a.H + h) * a.Q;
    const BiasSrc bias(a, b, s, h);
    const float* b1c = bias.b1 ? b1s : nullptr;
    const float* b2c = bias.b2 ? b2s : nullptr;
    __syncthreads();  // the previous s is done with Ks/Vs/b1s
    if (bias.b1) stage_window(b1s, 0, bias.b1, 0, 0, 1, 1, k_start, a.K, bias.vec);
    cp_async_commit();
    stage_rows<D>(Ks, kb, a.ksn, k_start, a.K);
    stage_rows<D>(Vs, vb, a.vsn, k_start, a.K);
    float dk[4][NC], dv[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

    for (int it = blk.it0; it < blk.it1; ++it) {
      const int q0 = it * kB;
      __syncthreads();  // the previous tile's readers are done with Qs/dOs/Pt/dSt/b2s
      if (bias.b2)
        stage_window(b2s, kB2LdT, bias.b2, a.K, q0, kB, a.Q, k_start, a.K, bias.vec);
      cp_async_commit();
      stage_rows<D>(Qs, qb, a.qsn, q0, a.Q);
      stage_rows<D>(dOs, ob, a.dsn, q0, a.Q);
      if (tid < kB) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < a.Q ? a.lse_in[rowbase + qi] : 0.f;
        delta_s[tid] = qi < a.Q ? a.delta[rowbase + qi] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float* db2t = db2s + (q0 - qr0) * kDbPad;  // this tile's rows of the accumulator
      // s^T and dp^T: keys ty*4 + r against queries tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[r][j] = dp[r][j] = 0.f;
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
            sc[r][j] = fmaf(qv[j], kv[r], sc[r][j]);
            dp[r][j] = fmaf(ov[j], vv[r], dp[r][j]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lk = ty * 4 + r, key = k_start + lk;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lq = tx + 16 * j, row = q0 + lq;
          float p = 0.f;
          if (row < a.Q && key < a.K)
            p = expf(add_bias(sc[r][j] * a.sm_scale, b1c, b2c, kB2LdT, lq, lk) - lse_s[lq]);
          const float ds = p * (dp[r][j] - delta_s[lq]);
          if (want_db2) db2t[lq * kDbPad + lk] += ds;
          Pt[lk * PP + lq] = p;
          dSt[lk * PP + lq] = ds;
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
    // the outputs, or this query range's partials (fp32 either way)
    float* dkp = a.qranges > 1 ? kv_partial<D>(a, blk.range, false) : static_cast<float*>(a.dk);
    float* dvp = a.qranges > 1 ? kv_partial<D>(a, blk.range, true) : static_cast<float*>(a.dv);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = k_start + ty * 4 + r;
      if (key >= a.K) continue;
      const long long off = ((bs * a.K + key) * a.H + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dkp[off + tx + 16 * c] = dk[r][c] * a.sm_scale;
        dvp[off + tx + 16 * c] = dv[r][c];
      }
    }
  }
  if (want_db2) {
    __syncthreads();
    store_db2(a, db2s, blk, kB);
  }
}

// ===========================================================================
// the second pass: out[r, j] = sum over c, in order, of part[r, c, j]
// ===========================================================================
__global__ void reduce_chunks_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     long long rows, int chunks, long long len) {
  const long long n = rows * len;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / len, j = i % len;
    const float* p = part + r * chunks * len + j;
    float v = p[0];
    for (int c = 1; c < chunks; ++c) v += p[c * len];
    out[i] = v;
  }
}

// dK and dV from the query ranges' partials: out[i] = sum over r, in
// order, of part[r][which][i], rounded once to T
template <typename T>
__global__ void reduce_ranges_kernel(const float* __restrict__ part, T* __restrict__ dk,
                                     T* __restrict__ dv, int qranges, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < 2 * n;
       i += (long long)gridDim.x * blockDim.x) {
    const int which = i >= n;
    const long long j = i - which * n;
    const float* p = part + which * n + j;
    float v = p[0];
    for (int r = 1; r < qranges; ++r) v += p[2 * r * n];
    if constexpr (std::is_same<T, float>::value)
      (which ? dv : dk)[j] = v;
    else if constexpr (std::is_same<T, __half>::value)
      (which ? dv : dk)[j] = __float2half_rn(v);
    else
      (which ? dv : dk)[j] = __float2bfloat16_rn(v);
  }
}

// dQ from the key ranges' partials: out[i] = sum over r, in order, of
// part[r][i], rounded once to T
template <typename T>
__global__ void reduce_kranges_kernel(const float* __restrict__ part, T* __restrict__ dq,
                                      int kranges, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int r = 1; r < kranges; ++r) v += part[r * n + i];
    if constexpr (std::is_same<T, float>::value)
      dq[i] = v;
    else if constexpr (std::is_same<T, __half>::value)
      dq[i] = __float2half_rn(v);
    else
      dq[i] = __float2bfloat16_rn(v);
  }
}

cudaError_t reduce_chunks(const float* part, float* out, long long rows, int chunks,
                          long long len, cudaStream_t st) {
  const long long n = rows * len;
  const long long blocks = (n + 255) / 256;
  const int grid = blocks < 4096 ? (int)blocks : 4096;
  reduce_chunks_kernel<<<grid, 256, 0, st>>>(part, out, rows, chunks, len);
  return cudaGetLastError();
}

// ===========================================================================
// launch
// ===========================================================================
template <typename Kernel>
cudaError_t opt_in_max(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem - 2048);
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

// dynamic shared memory of each kernel; a shape that needs more than a
// block has is refused with cudaErrorInvalidConfiguration
template <int D>
size_t smem_bytes(Pass pass, bool fp32, const Args& a) {
  // E': the dbias1 accumulator spans one key range
  const int Kp = cdiv(cdiv(a.K, kB), a.kranges) * kB;
  const size_t nbuf = fp32 ? 1 : 2;  // bias tiles: single-buffered on the FMA pipes
  if (pass == kFwd || pass == kDq) {
    const size_t bias = sizeof(float) * nbuf * (kB + kB * kB2Ld);  // laid out always
    if (pass == kFwd) return (fp32 ? fwd_fma_smem<D>() : fwd_mma_smem<D>()) + bias;
    return dq_fma_tiles<D>() + (a.db1 ? sizeof(float) * Kp : 0) + bias;  // fp32 only
  }
  // E'' on the FMA pipes (fp32; bf16/fp16 take dkv_wg_smem)
  const size_t bias = sizeof(float) * (kB + kB * kB2LdT);
  const size_t db2 = a.db2 ? sizeof(float) * range_tiles(a.Q, kB, a.qranges) * kB * kDbPad : 0;
  return dkv_fma_tiles<D>() + bias + db2;
}

// the query ranges of E'' in fp32: 1 while the whole axis's dbias2
// accumulator fits a block, else the fewest ranges that let two blocks
// share an SM (or, failing that, fit one).  Ranges hold whole query tiles
// and none is empty.  (bf16/fp16: dkv_wg_plan.)
template <int D>
int dkv_qranges(int Q, bool db2) {
  Args a{};
  a.Q = Q;
  a.db2 = db2 ? reinterpret_cast<float*>(16) : nullptr;  // only tested for null
  a.qranges = 1;
  const size_t limit = (size_t)kMaxSmem - 2048;
  if (smem_bytes<D>(kDkv, true, a) <= limit) return 1;
  const int nq = cdiv(Q, kB);
  for (const size_t cap : {limit / 2 - 1024, limit}) {
    for (int r = 2; r <= nq; ++r) {
      a.qranges = cdiv(nq, range_tiles(Q, kB, r));  // no empty range
      if (smem_bytes<D>(kDkv, true, a) <= cap) return a.qranges;
    }
  }
  return nq;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 132;
    return v;
  }();
  return n;
}

// the key ranges of E' in fp32: 1 while the whole axis's dbias1
// accumulator fits a block, else the fewest that fit.  Ranges hold whole key
// tiles and none is empty.  (bf16/fp16: dq_wg_plan.)
template <int D>
int dq_kranges(int K, bool db1) {
  Args a{};
  a.K = K;
  a.db1 = db1 ? reinterpret_cast<float*>(16) : nullptr;  // only tested for null
  const int nk = cdiv(K, kB);
  for (int r = 1; r <= nk; ++r) {
    a.kranges = cdiv(nk, cdiv(nk, r));  // no empty range
    if (smem_bytes<D>(kDq, true, a) <= (size_t)kMaxSmem - 2048) return a.kranges;
  }
  return nk;
}

// E''s plan for a dtype and shape, the library's own: in fp32 the key
// ranges above and chunks of (h, query tile) units sized so that about two
// blocks per SM run (every unit its own chunk without bias1); in bf16/fp16
// dq_wg_plan.
template <int D>
DqPlan dq_plan(bool fp32, int B, int S, int Q, int K, int H, bool db1, bool b2) {
  if (!fp32) return dq_wg_plan<D>(B, S, K, H, b2, db1, sm_count());
  DqPlan p{};
  p.kranges = dq_kranges<D>(K, db1);
  const int units = H * cdiv(Q, kB);
  p.chunks = !db1 ? units : min(units, max(1, cdiv(2 * sm_count(), max(1, B * S))));
  return p;
}

// the TMA map of a [B, S, N, H, D] tensor read through its element strides
// in boxes of R rows (residues) x W columns of one (b, s, h), swizzled at W:
// dims (D, H, N, S, B), box (W, 1, R, 1, 1); rows past N arrive as zeros
template <typename T>
cudaError_t evo_map(CUtensorMap* m, const void* p, int D, int H, int N, int S, int B,
                    long long sh, long long sn, long long ss, long long sb, int W, int R) {
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {sh * e, sn * e, ss * e, sb * e};
  const cuuint32_t box[5] = {(cuuint32_t)W, 1, (cuuint32_t)R, 1, 1};
  return encode_map<T>(m, p, 5, dims, strides, box,
                       W == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                       : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B);
}

// kernel E on wgmma with the pair bias resident: blocks of s_per rows of
// the MSA (16: 8 per warpgroup, fewer while the grid would not cover the
// SMs twice), each block's dynamic shared memory the two warpgroups' Q
// buffers and rings and the [64][ldb] pair-bias rows
template <typename T, int D>
cudaError_t launch_fwd_wgmma(const Args& a, cudaStream_t st) {
  constexpr int W = evo_w<D>(), BK = evo_bk<D>();
  const int ST = a.fwd_stages;
  const int nq = cdiv(a.Q, kB), nkt = cdiv(a.K, BK);
  const int ldb = nkt * BK + 8;  // +8: the lanes' column pairs fall in distinct banks
  const size_t tiles = (size_t)2 * (2 * kB + 2 * ST * BK) * D * sizeof(T);
  const size_t smem = 1024 + tiles + (a.b2 ? sizeof(float) * kB * ldb : 0) +
                      sizeof(float) * 2 * 2 * nkt * BK + sizeof(uint64_t) * 2 * (4 + 2 * ST);
  if (ST < 2 || smem > (size_t)kMaxSmem - 2048) return cudaErrorInvalidConfiguration;
  CUtensorMap m[3];
  cudaError_t e;
  if ((e = evo_map<T>(&m[0], a.q, D, a.H, a.Q, a.S, a.B, a.qsh, a.qsn, a.qss, a.qsb, W,
                      kB)) != cudaSuccess ||
      (e = evo_map<T>(&m[1], a.k, D, a.H, a.K, a.S, a.B, a.ksh, a.ksn, a.kss, a.ksb, W,
                      BK)) != cudaSuccess ||
      (e = evo_map<T>(&m[2], a.v, D, a.H, a.K, a.S, a.B, a.vsh, a.vsn, a.vss, a.vsb, W,
                      BK)) != cudaSuccess)
    return e;
  int s_per = 16;
  while (s_per > 2 && (long long)a.B * a.H * nq * cdiv(a.S, s_per) < 2LL * sm_count())
    s_per /= 2;
  s_per = min(s_per, a.S);
  const int chunks = cdiv(a.S, s_per);
  const FwdWgArgs w{a.b1, a.b2, a.o, a.lse, a.B, a.S, a.Q, a.K, a.H, nq, nkt, chunks, s_per,
                    ST, ldb, a.sm_scale};
  const dim3 grid((unsigned)((long long)a.B * a.H * chunks * nq));
  constexpr int threads = kEvoWgThreads + 32;  // two consumer warpgroups, a producer warp
  if (a.b2) {
    static const cudaError_t attr = opt_in_max(evo_fwd_wgmma_kernel<T, D, true>);
    if (attr != cudaSuccess) return attr;
    evo_fwd_wgmma_kernel<T, D, true><<<grid, threads, smem, st>>>(m[0], m[1], m[2], w);
  } else {
    static const cudaError_t attr = opt_in_max(evo_fwd_wgmma_kernel<T, D, false>);
    if (attr != cudaSuccess) return attr;
    evo_fwd_wgmma_kernel<T, D, false><<<grid, threads, smem, st>>>(m[0], m[1], m[2], w);
  }
  return cudaGetLastError();
}

// bias2 [B * H, Q, ldb] fp32 as a 3-D map (K, Q, B * H), box (32, R, 1)
// swizzled at 128 bytes: one copy lands 32 keys of R query rows; keys past
// K and rows past Q arrive as zeros
cudaError_t bias2_map(CUtensorMap* m, const float* b2, int K, int Q, int BH, int ldb, int R) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)Q, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)ldb * 4, (cuuint64_t)Q * ldb * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)R, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(b2), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// kernel E'' on wgmma at its plan (dkv_wg_plan: the caller's qranges must
// be the plan's), then the second passes
template <typename T, int D>
cudaError_t launch_dkv_wgmma(const Args& args, cudaStream_t st) {
  constexpr int W = evo_w<D>(), R = dkv_rows<D>();
  Args a = args;
  const bool b2 = a.b2 != nullptr;
  if (a.qranges != dkv_wg_plan<D>(a.Q, b2, &a.dkv_stages) || a.ldb < a.K || a.ldb % 4 != 0 ||
      a.ldq < a.Q || a.ldq % 4 != 0 || (a.qranges > 1 && a.kv_part == nullptr))
    return cudaErrorInvalidConfiguration;
  const size_t smem = dkv_wg_smem<D>(a.dkv_stages, b2, range_tiles(a.Q, R, a.qranges) * R);
  CUtensorMap m[5] = {};
  cudaError_t e;
  if ((e = evo_map<T>(&m[0], a.q, D, a.H, a.Q, a.S, a.B, a.qsh, a.qsn, a.qss, a.qsb, W, R)) !=
          cudaSuccess ||
      (e = evo_map<T>(&m[1], a.k, D, a.H, a.K, a.S, a.B, a.ksh, a.ksn, a.kss, a.ksb, W, kB)) !=
          cudaSuccess ||
      (e = evo_map<T>(&m[2], a.v, D, a.H, a.K, a.S, a.B, a.vsh, a.vsn, a.vss, a.vsb, W, kB)) !=
          cudaSuccess ||
      (e = evo_map<T>(&m[3], a.dout, D, a.H, a.Q, a.S, a.B, a.dsh, a.dsn, a.dss, a.dsb, W, R)) !=
          cudaSuccess ||
      (b2 && (e = bias2_map(&m[4], a.b2, a.K, a.Q, a.B * a.H, a.ldb, R)) != cudaSuccess))
    return e;
  const int nk = cdiv(a.K, kB);
  const dim3 grid((unsigned)((long long)a.B * a.H * nk * a.chunks * a.qranges));
  if (b2) {
    static const cudaError_t attr = opt_in_max(evo_bwd_dkv_wgmma_kernel<T, D, true>);
    if (attr != cudaSuccess) return attr;
    evo_bwd_dkv_wgmma_kernel<T, D, true>
        <<<grid, kDkvThreads, smem, st>>>(m[0], m[1], m[2], m[3], m[4], a);
  } else {
    static const cudaError_t attr = opt_in_max(evo_bwd_dkv_wgmma_kernel<T, D, false>);
    if (attr != cudaSuccess) return attr;
    evo_bwd_dkv_wgmma_kernel<T, D, false>
        <<<grid, kDkvThreads, smem, st>>>(m[0], m[1], m[2], m[3], m[4], a);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.qranges > 1) {
    const long long n = (long long)a.B * a.S * a.K * a.H * D;
    const long long blocks = (2 * n + 255) / 256;
    reduce_ranges_kernel<T><<<blocks < 4096 ? (int)blocks : 4096, 256, 0, st>>>(
        a.kv_part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qranges, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (a.db2 == nullptr || a.chunks == 1) return e;
  return reduce_chunks(a.part, a.db2, (long long)a.B * a.H, a.chunks, (long long)a.Q * a.K, st);
}

// kernel E' on wgmma at its plan (dq_wg_plan: the caller's kranges and
// chunks must be the plan's), then the second passes
template <typename T, int D>
cudaError_t launch_dq_wgmma(const Args& a, cudaStream_t st) {
  constexpr int W = evo_w<D>(), BK = dq_bk<D>();
  const bool b2 = a.b2 != nullptr, db1 = a.db1 != nullptr;
  const DqPlan p = dq_wg_plan<D>(a.B, a.S, a.K, a.H, b2, db1, sm_count());
  if (p.kranges == 0 || a.kranges != p.kranges || a.chunks != p.chunks || a.ldb < a.K ||
      a.ldb % 4 != 0 || a.ldq < a.Q || a.ldq % 4 != 0 ||
      (a.kranges > 1 && a.dq_part == nullptr) || (db1 && a.chunks > 1 && a.part == nullptr))
    return cudaErrorInvalidConfiguration;
  const int Kp = cdiv(cdiv(a.K, BK), a.kranges) * BK;
  const size_t smem = dq_wg_smem<D>(p.kv_stages, p.q_stages, p.b2_stages, Kp, db1);
  CUtensorMap m[5] = {};
  cudaError_t e;
  if ((e = evo_map<T>(&m[0], a.q, D, a.H, a.Q, a.S, a.B, a.qsh, a.qsn, a.qss, a.qsb, W,
                      kDqRows)) != cudaSuccess ||
      (e = evo_map<T>(&m[1], a.k, D, a.H, a.K, a.S, a.B, a.ksh, a.ksn, a.kss, a.ksb, W, BK)) !=
          cudaSuccess ||
      (e = evo_map<T>(&m[2], a.v, D, a.H, a.K, a.S, a.B, a.vsh, a.vsn, a.vss, a.vsb, W, BK)) !=
          cudaSuccess ||
      (e = evo_map<T>(&m[3], a.dout, D, a.H, a.Q, a.S, a.B, a.dsh, a.dsn, a.dss, a.dsb, W,
                      kDqRows)) != cudaSuccess ||
      (b2 && (e = bias2_map(&m[4], a.b2, a.K, a.Q, a.B * a.H, a.ldb, kDqRows)) != cudaSuccess))
    return e;
  const dim3 grid((unsigned)((long long)a.B * a.S * a.chunks * a.kranges));
  constexpr int threads = kDqThreads + 32;  // two consumer warpgroups, a producer warp
  if (b2) {
    static const cudaError_t attr = opt_in_max(evo_bwd_dq_wgmma_kernel<T, D, true>);
    if (attr != cudaSuccess) return attr;
    evo_bwd_dq_wgmma_kernel<T, D, true>
        <<<grid, threads, smem, st>>>(m[0], m[1], m[2], m[3], m[4], a, p);
  } else {
    static const cudaError_t attr = opt_in_max(evo_bwd_dq_wgmma_kernel<T, D, false>);
    if (attr != cudaSuccess) return attr;
    evo_bwd_dq_wgmma_kernel<T, D, false>
        <<<grid, threads, smem, st>>>(m[0], m[1], m[2], m[3], m[4], a, p);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.kranges > 1) {
    const long long n = (long long)a.B * a.S * a.Q * a.H * D;
    const long long blocks = (n + 255) / 256;
    reduce_kranges_kernel<T><<<blocks < 4096 ? (int)blocks : 4096, 256, 0, st>>>(
        a.dq_part, static_cast<T*>(a.dq), a.kranges, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (!db1 || a.chunks == 1) return e;
  return reduce_chunks(a.part, a.db1, (long long)a.B * a.S, a.chunks, a.K, st);
}

template <typename T, int D>
cudaError_t launch(Pass pass, const Args& a, cudaStream_t st) {
  constexpr bool fp32 = std::is_same<T, float>::value;
  if constexpr (!fp32) {
    if (pass == kFwd && a.fwd_stages > 0) return launch_fwd_wgmma<T, D>(a, st);
    if (pass == kDq) return launch_dq_wgmma<T, D>(a, st);
    if (pass == kDkv) return launch_dkv_wgmma<T, D>(a, st);
  }
  if (pass == kFwd && a.fwd_stages > 0) return cudaErrorInvalidValue;  // fp32: FMA only
  const size_t smem = smem_bytes<D>(pass, fp32, a);
  if (smem > (size_t)kMaxSmem - 2048) return cudaErrorInvalidConfiguration;
  const int threads = fp32 ? kFmaThreads : kMmaWarps * 32;
  const int nq = (a.Q + kB - 1) / kB, nk = (a.K + kB - 1) / kB;
  if (pass == kFwd) {
    const dim3 grid(a.B * a.S * a.H * nq);
    if constexpr (fp32) {
      static const cudaError_t attr = opt_in_max(evo_fwd_fma_kernel<D>);
      if (attr != cudaSuccess) return attr;
      evo_fwd_fma_kernel<D><<<grid, threads, smem, st>>>(a);
    } else {
      static const cudaError_t attr = opt_in_max(evo_fwd_mma_kernel<T, D>);
      if (attr != cudaSuccess) return attr;
      evo_fwd_mma_kernel<T, D><<<grid, threads, smem, st>>>(a);
    }
  } else if (pass == kDq) {
    if (a.kranges != dq_kranges<D>(a.K, a.db1 != nullptr) ||
        (a.kranges > 1 && a.dq_part == nullptr))
      return cudaErrorInvalidValue;
    const dim3 grid(a.B * a.S * a.chunks * a.kranges);
    static const cudaError_t attr = opt_in_max(evo_bwd_dq_fma_kernel<D>);
    if (attr != cudaSuccess) return attr;
    evo_bwd_dq_fma_kernel<D><<<grid, threads, smem, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (a.kranges > 1) {
      const long long n = (long long)a.B * a.S * a.Q * a.H * D;
      const long long blocks = (n + 255) / 256;
      reduce_kranges_kernel<T><<<blocks < 4096 ? (int)blocks : 4096, 256, 0, st>>>(
          a.dq_part, static_cast<T*>(a.dq), a.kranges, n);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    if (a.db1 == nullptr || a.chunks == 1) return e;
    return reduce_chunks(a.part, a.db1, (long long)a.B * a.S, a.chunks, a.K, st);
  } else {
    if (a.qranges != dkv_qranges<D>(a.Q, a.db2 != nullptr) ||
        (a.qranges > 1 && a.kv_part == nullptr))
      return cudaErrorInvalidValue;
    const dim3 grid(a.B * a.H * nk * a.chunks * a.qranges);
    static const cudaError_t attr = opt_in_max(evo_bwd_dkv_fma_kernel<D>);
    if (attr != cudaSuccess) return attr;
    evo_bwd_dkv_fma_kernel<D><<<grid, threads, smem, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (a.qranges > 1) {
      const long long n = (long long)a.B * a.S * a.K * a.H * D;
      const long long blocks = (2 * n + 255) / 256;
      reduce_ranges_kernel<T><<<blocks < 4096 ? (int)blocks : 4096, 256, 0, st>>>(
          a.kv_part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qranges, n);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    if (a.db2 == nullptr || a.chunks == 1) return e;
    return reduce_chunks(a.part, a.db2, (long long)a.B * a.H, a.chunks, (long long)a.Q * a.K,
                         st);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Pass pass, int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(pass, a, st);
    case 32:
      return launch<T, 32>(pass, a, st);
    case 64:
      return launch<T, 64>(pass, a, st);
    case 128:
      return launch<T, 128>(pass, a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(Pass pass, int dtype, int D, const Args& a, void* stream) {
  if (a.Q <= 0 || a.K <= 0 || a.H <= 0 || a.chunks <= 0) return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.S == 0) return (int)cudaSuccess;
  if (a.chunks > 1 && ((pass == kDq && a.db1) || (pass == kDkv && a.db2)) && a.part == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_d<float>(pass, D, a, st);
    case 1:
      return (int)dispatch_d<__nv_bfloat16>(pass, D, a, st);
    case 2:
      return (int)dispatch_d<__half>(pass, D, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16 (q, k, v, dO, o and dq/dk/dv).  q and
// dO [B, S, Q, H, D], k and v [B, S, K, H, D], read through the given
// element strides (batch, row, residue, head; the head dim contiguous, and
// for bf16/fp16 every row 16-byte aligned).  bias1 [B, S, K] and bias2
// [B, H, Q, K] fp32 contiguous, or null.  lse and delta [B, S, H, Q] fp32
// contiguous.  o, dq [B, S, Q, H, D] and dk, dv [B, S, K, H, D] contiguous,
// written whole.  db1 [B, S, K] / db2 [B, H, Q, K] fp32 or null (no bias
// gradient); with chunks > 1, part holds the chunks' fp32 partials
// ([B*S, chunks, K] for E', [B*H, chunks, Q*K] for E'').  E'' cuts the
// query axis into qranges ranges (dstpu_evoformer_attn_dkv_qranges); above
// one, kv_part holds their fp32 dK/dV partials ([qranges][2][B*S*K*H*D]).
// E' and E'' in bf16/fp16 read bias1 and bias2 rows padded to ldb floats
// ([B, S, ldb], [B, H, Q, ldb]) and lse and delta rows padded to ldq
// ([B, S, H, ldq]), ldb >= K and ldq >= Q multiples of 4, 16-byte aligned,
// q/k/v/dO strides positive (TMA); fp32 takes ldb = K and ldq = Q.
// E' cuts the key axis into kranges ranges and its blocks into chunks, both
// the library's plan (dstpu_evoformer_attn_dq_plan); above one range,
// dq_part holds their fp32 dQ partials ([kranges][B*S*Q*H*D]).
// D is 16, 32, 64 or 128.  E with stages > 0 (bf16/fp16) runs the
// resident-bias wgmma kernel with a ring of that many stages per warpgroup
// (q/k/v strides positive; refused when its shared memory does not fit a
// block), with 0 the cp.async tile kernel.  Each returns cudaGetLastError()
// after its launches; E' and E'' take every K and Q.
#define DSTPU_EVO_STRIDES                                                                    \
  long long qsb, long long qss, long long qsn, long long qsh, long long ksb, long long kss,  \
      long long ksn, long long ksh, long long vsb, long long vss, long long vsn, long long vsh

extern "C" int dstpu_evoformer_attn_fwd(const void* q, const void* k, const void* v,
                                        const void* b1, const void* b2, void* o, void* lse,
                                        int dtype, int B, int S, int Q, int K, int H, int D,
                                        float sm_scale, int stages, DSTPU_EVO_STRIDES,
                                        void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, static_cast<const float*>(b1),
               static_cast<const float*>(b2), o, nullptr, nullptr, nullptr,
               static_cast<float*>(lse), nullptr, nullptr, nullptr, B, S, Q, K, H, 1, sm_scale,
               qsb, qss, qsn, qsh, ksb, kss, ksn, ksh, vsb, vss, vsn, vsh, 0, 0, 0, 0, 1,
               nullptr, 1, nullptr, stages};
  return dispatch(kFwd, dtype, D, a, stream);
}

extern "C" int dstpu_evoformer_attn_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, const void* b1, const void* b2,
                                           void* dq, void* db1, void* part, void* dq_part,
                                           int dtype, int B, int S, int Q, int K, int H, int D,
                                           float sm_scale, int chunks, int kranges,
                                           int ldb, int ldq, DSTPU_EVO_STRIDES, long long dsb,
                                           long long dss, long long dsn, long long dsh,
                                           void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(b1), static_cast<const float*>(b2), nullptr, dq,
               nullptr, nullptr, nullptr, static_cast<float*>(db1), nullptr,
               static_cast<float*>(part), B, S, Q, K, H, chunks, sm_scale, qsb, qss, qsn, qsh,
               ksb, kss, ksn, ksh, vsb, vss, vsn, vsh, dsb, dss, dsn, dsh, 1, nullptr, kranges,
               static_cast<float*>(dq_part), 0, 0, ldb, ldq};
  return dispatch(kDq, dtype, D, a, stream);
}

extern "C" int dstpu_evoformer_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, const void* b1, const void* b2,
                                            void* dk, void* dv, void* db2, void* part,
                                            void* kv_part, int dtype, int B, int S, int Q,
                                            int K, int H, int D, float sm_scale, int chunks,
                                            int qranges, int ldb, int ldq,
                                            DSTPU_EVO_STRIDES, long long dsb, long long dss,
                                            long long dsn, long long dsh, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(b1), static_cast<const float*>(b2), nullptr, nullptr,
               dk, dv, nullptr, nullptr, static_cast<float*>(db2), static_cast<float*>(part),
               B, S, Q, K, H, chunks, sm_scale, qsb, qss, qsn, qsh, ksb, kss, ksn, ksh, vsb,
               vss, vsn, vsh, dsb, dss, dsn, dsh, qranges, static_cast<float*>(kv_part), 1,
               nullptr, 0, 0, ldb, ldq};
  return dispatch(kDkv, dtype, D, a, stream);
}

// the query ranges E'' takes for this dtype, query length, head dim and
// whether dbias2 is wanted: the qranges that dstpu_evoformer_attn_bwd_dkv
// must be given (above 1, kv_part holds 2 * qranges * B * S * K * H * D
// floats); 0 for a head dim the kernels do not take.
template <int D>
int dkv_ranges(bool fp32, int Q, bool want_db2) {
  int stages = 0;
  return fp32 ? dkv_qranges<D>(Q, want_db2) : dkv_wg_plan<D>(Q, want_db2, &stages);
}

extern "C" int dstpu_evoformer_attn_dkv_qranges(int dtype, int Q, int D, int want_db2) {
  const bool fp32 = dtype == 0;
  switch (D) {
    case 16:
      return dkv_ranges<16>(fp32, Q, want_db2);
    case 32:
      return dkv_ranges<32>(fp32, Q, want_db2);
    case 64:
      return dkv_ranges<64>(fp32, Q, want_db2);
    case 128:
      return dkv_ranges<128>(fp32, Q, want_db2);
    default:
      return 0;
  }
}

// E''s plan for this dtype and shape, whether dbias1 is wanted and whether
// bias2 is given: out[0] the key ranges and out[1] the chunks that
// dstpu_evoformer_attn_bwd_dq must be given (above one range, dq_part holds
// kranges * B * S * Q * H * D floats; above one chunk with dbias1, part
// holds B * S * chunks * K), and in bf16/fp16 the kernel's layout: out[2]
// 1 when K and V stay resident per head, out[3] their stages, out[4] the Q
// ring's, out[5] the bias2 ring's.  Returns 0, or cudaErrorInvalidValue for
// a head dim the kernels do not take.
extern "C" int dstpu_evoformer_attn_dq_plan(int dtype, int B, int S, int Q, int K, int H, int D,
                                            int want_db1, int has_b2, int* out) {
  const bool fp32 = dtype == 0;
  DqPlan p{};
  switch (D) {
    case 16: p = dq_plan<16>(fp32, B, S, Q, K, H, want_db1, has_b2); break;
    case 32: p = dq_plan<32>(fp32, B, S, Q, K, H, want_db1, has_b2); break;
    case 64: p = dq_plan<64>(fp32, B, S, Q, K, H, want_db1, has_b2); break;
    case 128: p = dq_plan<128>(fp32, B, S, Q, K, H, want_db1, has_b2); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int v[6] = {p.kranges, p.chunks, p.resident, p.kv_stages, p.q_stages, p.b2_stages};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}
