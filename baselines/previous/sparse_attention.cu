// Block-sparse attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/sparse_attention.py
// :_sparse_attn_kernel (via sparse_attention), forward only as there.
//
// What it computes, per head h of batch b, with the layout [Hl, NB, NB]
// of a SparsityConfig (block = S / NB rows, Hl = 1 broadcast over heads):
//   s[i, j]  = (q[i] . k[j]) / sqrt(D)   where layout[h, i / block, j / block]
//                                        and (not causal or i >= j)
//   o[i]     = sum_j softmax(s[i])_j v[j]   (online softmax, fp32)
//   a row with no visible key gives 0 (no NaN), as the TPU kernel does.
//
// The TPU program holds a whole [S, D] K and V in VMEM and walks every
// k-block of its row up to the diagonal, skipping the off-layout ones with
// lax.cond.  Here the wrapper turns the layout into compact per-head lists
// (CSR: row_ptr [Hl * NB + 1], cols ascending, only cols <= the row's block
// when causal), and each CUDA block owns one (b, h, 64-row query tile) and
// walks the on-blocks of its layout row only: an off-layout block costs no
// load at all, and under causal the walk stops at the diagonal.  A layout
// block that is a multiple of 64 (128 by default) is cut into 64-key tiles;
// in the diagonal block the tiles wholly above the query tile's last row are
// not visited, and keys are masked only on the diagonal (S is a multiple of
// the block, so there are no ragged tails).
//
// Blocks that are a multiple of 16 but not of 64 (DeepSpeed's GPU default
// is 16): the tile stays 64 x 64, and the wrapper ORs the layout, taken at
// 16 x 16 units, into 64 x 64 tiles.  The lists then name the tiles to
// visit, and each visited tile carries a 16-bit mask of its units (bit 4 *
// row unit + column unit); a unit that is off is masked like the diagonal.
// A 16-row unit is one warp's rows, so a warp reads 4 bits per tile.  This
// keeps the tensor-core tile (and the block >= 64 path, timed in PERF.md)
// as it is, where a 16- or 32-row tile would quarter the work per K/V load;
// the cost is the masked compare on such tiles and the off units inside a
// visited tile.  S need only be a multiple of the block there: rows and keys past S
// are zero-filled on load, their units are off, and rows past S are not
// stored.
//
// Blocks that are not a multiple of 16 (the reference takes any block that
// divides S): the same 64 x 64 tiles over 16 x 16 units, a unit on when any
// of its elements is visible.  The wrapper marks units that are only partly
// visible with a second 16-bit mask (bits 16-31); inside those the kernel
// (ELEM) tests each element's own layout entry (row / block, col / block),
// read from a byte copy of the layout.  Fully visible units and every layout
// whose block is a multiple of 16 keep the code above.
//
// Head dims past 256 (every type): the runtime-head-dim kernel
// (csrc/wide_head.cuh) walks the unit lists on the FMA pipes, S over the whole
// head in 32-column chunks, the output in parts of 128 columns.
// Head dims: the wrapper pads rows to a multiple of 16 (32 past 128) with
// zero columns; past 128 each block computes one half of the output columns
// (a grid axis over the halves, S = QK^T still over the whole D), so the
// register budget stays that of D <= 128.
//
// What bounds it on the H100: the arithmetic.  At B = 1, S = 4096, H = 16,
// D = 64 (BERT-large's heads at a long sequence) a visible 128 x 128 block
// pair costs 4 * D * 128^2 = 4.2 MFLOP against 2 * 16 KB of K/V (and the
// query tile's q/o once), ~128 FLOP per byte per pair even with no reuse
// of K/V across query tiles: near the ~295 FLOP/byte ridge.  With the
// ~30-40 % of pairs a Fixed/Longformer/BigBird layout keeps, the tensor
// cores set the least time when K/V tiles hit L2, the bytes otherwise.
//
// Design, bf16 and fp16: the flash-forward tile (csrc/flash_attention_fwd.cu)
// — 4 warps of 16 query rows, Q as mma.sync A fragments in registers, K/V
// tiles by 16-byte cp.async, double-buffered, S = QK^T and O += PV on the
// tensor cores (m16n8k16, fp32 accumulators), P rounded to the input type
// only as the PV operand; the next tile's address comes from the list, so
// its load is in flight while the current one is computed.  fp32: the same
// walk on the FMA pipes (16 x 16 threads, 4 rows x 4 strided columns each).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_head.cuh"

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
// exp(s - m) of a score; GUARD: 0 for a masked one (s = kNegInf) whatever
// m is, also when its whole row is masked so far
template <bool GUARD = true>
__device__ __forceinline__ float prob(float s, float m) {
  return GUARD && s == kNegInf ? 0.f : expf(s - m);
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

struct Args {
  const void *q, *k, *v;
  void* o;
  const int *row_ptr, *cols, *masks;  // masks: null, or one per entry of cols
  const uint8_t* layout;              // ELEM: the layout [Hl, NB, NB] as bytes
  int B, S, H, Hl, block, causal;     // block: of the lists (64 with masks)
  int lblock;                         // the layout's own block (ELEM)
  float sm_scale;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

// The walk of one query tile: the layout row's on-blocks, each cut into
// kBK-key tiles.  tile(t) is the first key of the t-th tile.
struct Walk {
  const int* cols;
  const int* masks;  // null: every unit of a visited tile is on
  int per;           // kBK tiles per layout block
  int block;
  int n_tiles;

  __device__ Walk(const Args& a, int h, int q_start) {
    const int nb = (a.S + a.block - 1) / a.block;
    const int qi = q_start / a.block;
    const int row = (a.Hl == 1 ? 0 : h) * nb + qi;
    const int begin = a.row_ptr[row], end = a.row_ptr[row + 1];
    cols = a.cols + begin;
    masks = a.masks != nullptr ? a.masks + begin : nullptr;
    block = a.block;
    per = a.block / kBK;
    n_tiles = (end - begin) * per;
    // causal: the list stops at the diagonal block; of its tiles only
    // those starting at or before this query tile's last row are visited
    if (a.causal && end > begin && a.cols[end - 1] == qi)
      n_tiles -= per - ((q_start - qi * a.block) / kBK + 1);
  }
  __device__ __forceinline__ int tile(int t) const { return cols[t / per] * block + (t % per) * kBK; }
  // the 4 bits of row unit r of tile t (bit c: column unit c is on)
  __device__ __forceinline__ int unit_bits(int t, int r) const {
    return masks != nullptr ? (masks[t] >> (4 * r)) & 0xF : 0xF;
  }
  // the 4 bits of row unit r of tile t whose units are only partly visible
  __device__ __forceinline__ int partial_bits(int t, int r) const {
    return (masks[t] >> (16 + 4 * r)) & 0xF;
  }
};

// an element of a partly visible unit: its own layout entry (ELEM)
__device__ __forceinline__ bool elem_on(const Args& a, int h, int row, int col) {
  const int nb = a.S / a.lblock;
  return row < a.S && col < a.S &&
         a.layout[((long long)(a.Hl == 1 ? 0 : h) * nb + row / a.lblock) * nb + col / a.lblock];
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// the same, reading n (16 or 0) bytes: n = 0 fills the destination with zeros
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

// UNITS: the lists are of 64 x 64 tiles with 16 x 16 unit masks (blocks off
// the tile; S any multiple of the block).  Without it, the block-multiple path:
// no unit test per score and no ragged rows.
template <typename T, int D, bool UNITS, bool ELEM>
__global__ void __launch_bounds__(kMmaWarps * 32) sparse_attn_mma_kernel(Args a) {
  constexpr int RS = D + 8;   // padded row (+16 bytes): conflict-free fragment reads
  constexpr int KT = D / 16;
  constexpr int NT = kBK / 8;
  constexpr int DO = D > 128 ? D / 2 : D;  // output columns of this block
  constexpr int DT = DO / 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][RS]
  T* Ks = Qs + kBQ * RS;                   // [2][BK][RS]
  T* Vs = Ks + 2 * kBK * RS;               // [2][BK][RS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q_start = blockIdx.x * kBQ;
  const int col0 = DO < D ? (int)blockIdx.z * DO : 0;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  const Walk walk(a, h, q_start);

  for (int i = tid; i < kBQ * CPR; i += kMmaWarps * 32) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int qi = q_start + r;
    if constexpr (UNITS)  // rows past S read zeros
      cp_async16(Qs + r * RS + c, qb + (long long)min(qi, a.S - 1) * a.qss + c,
                 qi < a.S ? 16 : 0);
    else
      cp_async16(Qs + r * RS + c, qb + (long long)qi * a.qss + c);
  }
  cp_async_commit();

  auto load_kv = [&](int buf, int k0) {
    T* kd = Ks + buf * kBK * RS;
    T* vd = Vs + buf * kBK * RS;
    for (int i = tid; i < kBK * CPR; i += kMmaWarps * 32) {
      const int r = i / CPR, c = (i % CPR) * 8;
      if constexpr (UNITS) {
        const int n = k0 + r < a.S ? 16 : 0;
        const long long row = min(k0 + r, a.S - 1);
        cp_async16(kd + r * RS + c, kb + row * a.kss + c, n);
        cp_async16(vd + r * RS + c, vb + row * a.vss + c, n);
      } else {
        const long long row = k0 + r;
        cp_async16(kd + r * RS + c, kb + row * a.kss + c);
        cp_async16(vd + r * RS + c, vb + row * a.vss + c);
      }
    }
    cp_async_commit();
  };

  if (walk.n_tiles > 0) {
    load_kv(0, walk.tile(0));
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
  const int row_g = q_start + r0;

  for (int t = 0; t < walk.n_tiles; ++t) {
    const int cur = t & 1;
    const int k0 = walk.tile(t);
    if (t + 1 < walk.n_tiles) {
      load_kv(cur ^ 1, walk.tile(t + 1));
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

    // only a tile that reaches past the query tile's first row, or that
    // holds units that are off, is masked
    const bool diag = a.causal && k0 + kBK - 1 > q_start;
    const int bits = UNITS ? walk.unit_bits(t, warp) : 0xF;
    const int pbits = ELEM ? walk.partial_bits(t, warp) : 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_g + (e >> 1) * 8;
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool off = (diag && row < col) || (UNITS && !((bits >> (nt >> 1)) & 1)) ||
                         (ELEM && ((pbits >> (nt >> 1)) & 1) && !elem_on(a, h, row, col));
        const float x = off ? kNegInf : s[nt][e] * a.sm_scale;
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

    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // a masked key adds 0, also (UNITS) to a row that has seen no key yet;
      // without units every row sees a key in each tile it visits
      const float p0 = prob<UNITS>(s[nt][0], m[0]), p1 = prob<UNITS>(s[nt][1], m[0]);
      const float p2 = prob<UNITS>(s[nt][2], m[1]), p3 = prob<UNITS>(s[nt][3], m[1]);
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
        ldmatrix_x2_trans(bv, vr + col0 + dt * 8);
        Mma<T>::run(oacc[dt], pf[j], bv);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // l is 0 only for a row that visited no tile: its output is 0
    const float lc = fmaxf(quad_sum(l[i]), 1e-20f);
    const int qi = q_start + r0 + 8 * i;
    if (UNITS && qi >= a.S) continue;
    T* orow = static_cast<T*>(a.o) + (((long long)b * a.S + qi) * a.H + h) * D + col0;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + cq) =
          Mma<T>::pack(oacc[dt][2 * i] / lc, oacc[dt][2 * i + 1] / lc);
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

template <int D, bool ELEM>
__global__ void __launch_bounds__(kFmaThreads) sparse_attn_fma_kernel(Args a) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;           // [BQ][DP]
  float* Ks = Qs + kBQ * DP;  // [BK][DP]
  float* Vs = Ks + kBK * DP;  // [BK][D]
  float* Ps = Vs + kBK * D;   // [BQ][PP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // columns tx + 16 j
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q_start = blockIdx.x * kBQ;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  const Walk walk(a, h, q_start);

  for (int idx = tid; idx < kBQ * D; idx += kFmaThreads) {
    const int r = idx / D, d = idx % D;
    const int qi = q_start + r;
    Qs[r * DP + d] = qi < a.S ? qb[(long long)qi * a.qss + d] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < walk.n_tiles; ++t) {
    const int k0 = walk.tile(t);
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    for (int idx = tid; idx < kBK * D; idx += kFmaThreads) {
      const int r = idx / D, d = idx % D;
      const long long kj = k0 + r;
      const bool in = kj < a.S;
      Ks[r * DP + d] = in ? kb[kj * a.kss + d] : 0.f;
      Vs[r * D + d] = in ? vb[kj * a.vss + d] : 0.f;
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

    const bool diag = a.causal && k0 + kBK - 1 > q_start;
    const int bits = walk.unit_bits(t, ty >> 2);  // rows ty*4.. lie in unit ty / 4
    const int pbits = ELEM ? walk.partial_bits(t, ty >> 2) : 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q_start + ty * 4 + r;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool off = (diag && row < col) || !((bits >> j) & 1) ||
                         (ELEM && ((pbits >> j) & 1) && !elem_on(a, h, row, col));
        s[r][j] = off ? kNegInf : s[r][j] * a.sm_scale;
        mt = fmaxf(mt, s[r][j]);
      }
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = prob(s[r][j], m_new);
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
    if (qi >= a.S) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    float* orow = static_cast<float*>(a.o) + (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[r][c] / lc;
  }
}

// ---------------------------------------------------------------------------
// runtime head dim (past 256), any of the three types: csrc/wide_head.cuh
// ---------------------------------------------------------------------------
// The walk of the fp32 kernel over 64 x 64 tiles with unit masks, every
// element of a partly visible unit tested against the layout (the wrapper
// passes both for every layout here), with S over the whole head in
// 32-column chunks and the output columns in parts of 128 over a grid axis.
template <typename T>
__global__ void __launch_bounds__(kWideThreads) sparse_attn_wide_kernel(const Args a, int D) {
  extern __shared__ float wsm[];
  float* As = wsm;                         // [64][kWideLd]
  float* Bs = As + kWideRows * kWideLd;    // [64][kWideLd]
  float* Ps = Bs + kWideRows * kWideLd;    // [64][kWidePd]
  float* Vs = Ps + kWideRows * kWidePd;    // [64][kWidePart]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q_start = blockIdx.x * kBQ;
  const int c0 = blockIdx.z * kWidePart;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  const Walk walk(a, h, q_start);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }
  for (int t = 0; t < walk.n_tiles; ++t) {
    const int k0 = walk.tile(t);
    float s[4][4] = {};
    wide_dot(s, As, Bs, qb, a.qss, q_start, a.S, kb, a.kss, k0, a.S, D);
    const bool diag = a.causal && k0 + kBK - 1 > q_start;
    const int bits = walk.unit_bits(t, ty >> 2);  // rows ty*4.. lie in unit ty / 4
    const int pbits = walk.partial_bits(t, ty >> 2);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q_start + ty * 4 + r;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool off = (diag && row < col) || !((bits >> j) & 1) ||
                         (((pbits >> j) & 1) && !elem_on(a, h, row, col));
        s[r][j] = off ? kNegInf : s[r][j] * a.sm_scale;
        mt = fmaxf(mt, s[r][j]);
      }
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = prob(s[r][j], m_new);
        Ps[(ty * 4 + r) * kWidePd + tx + 16 * j] = p;
        psum += p;
      }
      psum = half_warp_sum(psum);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
    }
    wide_stage(Vs, kWidePart, kWidePart, vb, a.vss, k0, a.S, c0, D);
    __syncthreads();
    wide_pv(acc, Ps, Vs);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_start + ty * 4 + r;
    if (qi >= a.S) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    T* orow = static_cast<T*>(a.o) + (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < D) wide_put(orow + col, acc[r][c] / lc);
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

template <typename T>
cudaError_t launch_wide(int D, const Args& a, cudaStream_t st) {
  constexpr size_t smem = wide_fwd_smem();
  static const cudaError_t attr = opt_in(sparse_attn_wide_kernel<T>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H, (D + kWidePart - 1) / kWidePart);
  sparse_attn_wide_kernel<T><<<grid, kWideThreads, smem, st>>>(a, D);
  return cudaGetLastError();
}

template <typename T, int D, bool UNITS, bool ELEM>
cudaError_t launch_mma_units(const Args& a, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<D>();
  static const cudaError_t attr = opt_in(sparse_attn_mma_kernel<T, D, UNITS, ELEM>, smem);
  if (attr != cudaSuccess) return attr;
  grid.z = D > 128 ? 2 : 1;  // halves of the output columns
  sparse_attn_mma_kernel<T, D, UNITS, ELEM><<<grid, kMmaWarps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.layout != nullptr) return launch_mma_units<T, D, true, true>(a, grid, st);
  return a.masks != nullptr ? launch_mma_units<T, D, true, false>(a, grid, st)
                            : launch_mma_units<T, D, false, false>(a, grid, st);
}

template <int D, bool ELEM>
cudaError_t launch_fma(const Args& a, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = fma_smem_bytes<D>();
  static const cudaError_t attr = opt_in(sparse_attn_fma_kernel<D, ELEM>, smem);
  if (attr != cudaSuccess) return attr;
  sparse_attn_fma_kernel<D, ELEM><<<grid, kFmaThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Args& a, cudaStream_t st) {
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  if (dtype == 0) {
    return a.layout != nullptr ? launch_fma<D, true>(a, grid, st) : launch_fma<D, false>(a, grid, st);
  } else if (dtype == 1) {
    return launch_mma<__nv_bfloat16, D>(a, grid, st);
  } else if (dtype == 2) {
    return launch_mma<__half, D>(a, grid, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16.  q/k/v [B, S, H, D] read through the
// given element strides (the last dim contiguous; for bf16/fp16 every row
// 16-byte aligned); o [B, S, H, D] contiguous.  row_ptr [Hl * NB + 1] and
// cols: the layout's on-blocks per (layout head, block row), ascending, only
// those at or below the diagonal when causal (NB = ceil(S / block); Hl is 1
// or H).  Without masks, block is a multiple of 64 and S a multiple of
// block.  With masks (int32, one per entry of cols: the entry's 16 x 16 unit
// bits, and in bits 16-31 those of partly visible units), the lists are of
// 64 x 64 tiles and block is 64; then layout (null, or the layout as bytes
// [Hl, S / lblock, S / lblock]) gives the partial units' elements.  D is a
// multiple of 16 to 128, of 32 to 256, or any D past 256 (the
// runtime-head-dim kernel: masks and layout required, rows read at D with
// any alignment).  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int dstpu_sparse_attention(const void* q, const void* k, const void* v, void* o,
                                      const void* row_ptr, const void* cols,
                                      const void* masks, const void* layout, int dtype, int B,
                                      int S, int H, int D, int Hl, int block, int lblock,
                                      int causal,
                                      float sm_scale, long long qsb, long long qss,
                                      long long qsh, long long ksb, long long kss,
                                      long long ksh, long long vsb, long long vss,
                                      long long vsh, void* stream) {
  const bool units = masks != nullptr;
  if (block <= 0 || block % kBK != 0 || (units ? block != kBK : S % block) ||
      (layout != nullptr && (!units || lblock <= 0 || S % lblock != 0)) ||
      (Hl != 1 && Hl != H) || H <= 0)
    return (int)cudaErrorInvalidValue;
  if (D > 256 && (!units || layout == nullptr)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
               static_cast<const int*>(masks), static_cast<const uint8_t*>(layout), B, S, H, Hl,
               block, causal, lblock, sm_scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > 256) {  // the runtime-head-dim kernel, every type
    switch (dtype) {
      case 0: return (int)launch_wide<float>(D, a, st);
      case 1: return (int)launch_wide<__nv_bfloat16>(D, a, st);
      case 2: return (int)launch_wide<__half>(D, a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
#define DSTPU_SPARSE_CASE(d) \
  case d:                    \
    return (int)launch<d>(dtype, a, st);
    DSTPU_SPARSE_CASE(16)
    DSTPU_SPARSE_CASE(32)
    DSTPU_SPARSE_CASE(48)
    DSTPU_SPARSE_CASE(64)
    DSTPU_SPARSE_CASE(80)
    DSTPU_SPARSE_CASE(96)
    DSTPU_SPARSE_CASE(112)
    DSTPU_SPARSE_CASE(128)
    DSTPU_SPARSE_CASE(160)
    DSTPU_SPARSE_CASE(192)
    DSTPU_SPARSE_CASE(224)
    DSTPU_SPARSE_CASE(256)
#undef DSTPU_SPARSE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
