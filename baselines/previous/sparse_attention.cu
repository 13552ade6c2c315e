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
// (CSR: row_ptr and the key tiles to visit, ascending, none wholly above
// the diagonal when causal), and each CUDA block owns one (b, h, query
// tile) and walks the list of its layout row only: an off-layout block
// costs no load at all, and under causal the walk stops at the diagonal.
//
// What bounds it on the H100: the arithmetic.  At B = 1, S = 4096, H = 16,
// D = 64 (BERT-large's heads at a long sequence) a visible 128 x 128 block
// pair costs 4 * D * 128^2 = 4.2 MFLOP against 2 * 16 KB of K/V (and the
// query tile's q/o once), ~128 FLOP per byte per pair even with no reuse
// of K/V across query tiles: near the ~295 FLOP/byte ridge.  With the
// ~30-40 % of pairs a Fixed/Longformer/BigBird layout keeps, the tensor
// cores set the least time when K/V tiles hit L2, the bytes otherwise.
//
// Design, bf16 and fp16 (every head dim to 256): kernel A's forward
// (csrc/flash_attention_fwd.cu) with the causal key range replaced by the
// list walk.  One block of two consumer warpgroups per (b, h, 128-row query
// tile), 64 rows each, so both share every K/V tile; K/V tiles of BK keys
// (128 up to D = 64, 64 past it) through a ring of up to 5 stages, by TMA
// from tensor maps over [B, S, H, D] with the tensors' strides, swizzled in
// column blocks of W = 64, 32 or 16, thread 0 keeping the ring STAGES - 2
// tiles ahead.  S = Q K^T and O += P V on wgmma (P from registers, V read
// MN-major), S of tile t issued with P V of tile t - 1; the softmax in the
// log2 domain on the unscaled scores (one fma and ex2 a score: 2^(s *
// sm_scale * log2(e) - m')).  A layout block of 128 (the
// default) or a multiple of it is one query tile's layout row, and its key
// tiles need no mask but the causal diagonal's, applied only on tiles that
// cross a warp's first row; a warpgroup skips the loaded tiles wholly past
// its own last row.  Other blocks: the lists are of (128-row, BK-key) tiles
// of 16 x 16 units, each listed tile with 16 bytes of masks (byte r: the
// key units that are on for row unit r, a 16-row unit being one warp's rows
// in wgmma's accumulator layout; byte 8 + r: those only partly visible,
// whose elements are each tested against the layout, read as bytes).  A
// warp masks only on tiles whose units are not all fully on, and a masked
// score adds nothing, also to a row that has seen no key yet.  Rows and
// keys past S (S need only be a multiple of the block) arrive as zeros and
// are off.  Where TMA cannot read a tensor (a stride of 0 or off 16 bytes,
// rows aligned to 4 or 8 bytes only) every thread of the block copies its
// share of each tile by cp.async into the same swizzled layout and arrives
// on the stage's barrier when its copies land: a path of the same kernel.
//
// fp32: one block of 16 x 16 threads per 64-row query tile on the FMA pipes
// (4 rows x 4 strided columns each), walking 64 x 64 tiles: the layout's
// blocks cut into 64-key tiles when the block is a multiple of 64, else 16 x
// 16 unit masks as above over 64 x 64 tiles (16 bits a tile, a 16-row unit
// being 4 of the 16 thread rows).
//
// Head dims past 256 (every type): the runtime-head-dim kernel
// (csrc/wide_head.cuh) walks the fp32 kernel's unit lists on the FMA pipes,
// S over the whole head in 32-column chunks, the output in parts of 128
// columns.  Head dims off the kernels' widths: the wrapper pads rows to a
// multiple of 16 (32 past 128) with zero columns.

#include "hopper.cuh"
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

// an element of a partly visible unit: its own layout entry
__device__ __forceinline__ bool layout_on(const uint8_t* layout, int Hl, int S, int lblock, int h,
                                          int row, int col) {
  const int nb = S / lblock;
  return row < S && col < S &&
         layout[((long long)(Hl == 1 ? 0 : h) * nb + row / lblock) * nb + col / lblock];
}
__device__ __forceinline__ bool elem_on(const Args& a, int h, int row, int col) {
  return layout_on(a.layout, a.Hl, a.S, a.lblock, h, row, col);
}

// ---------------------------------------------------------------------------
// Hopper kernel (bf16, fp16): wgmma fed by TMA, or by a cp.async producer
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 256;  // two consumer warpgroups, 64 query rows each
constexpr size_t kSmemCap = 232448 - 1024;

struct WgArgs {
  const void *q, *k, *v;
  void* o;
  const int *row_ptr, *cols;  // per (layout head, query tile): the key tiles, ascending
  const uint8_t* masks;       // null (every unit of a listed tile on), or 16 per entry
  const uint8_t* layout;      // partly visible units: the layout [Hl, NB, NB] as bytes
  int B, S, H, Hl, lblock, causal;
  int cp;  // 0: TMA; else every thread copies by cp.async, cp (16, 8, 4) bytes at a time
  float sm_scale;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

template <int D, int BK_>
struct SpCfg {
  static constexpr int BQ = 128;  // queries per block, 64 per warpgroup
  static constexpr int BK = BK_;  // keys per tile
  // columns of a swizzled block: the widest of 64, 32, 16 that divides D
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one of K, V
  static constexpr int FIT = (int)((kSmemCap - Q_BYTES) / (2 * KV_BYTES));
  static constexpr int STAGES = FIT < 5 ? FIT : 5;
  // a tile's stage is released while the next tile is computed (its P V
  // runs under that tile's softmax): the ring runs STAGES - 2 tiles ahead
  static constexpr int AHEAD = STAGES - 2;
  static constexpr size_t smem =
      1024 + Q_BYTES + (size_t)STAGES * 2 * KV_BYTES + (1 + 2 * STAGES) * 8;
  static_assert(STAGES >= 2, "ring");
};

// rows [row0, row0 + rows) x D columns of one head into a tile laid out as
// TMA lands it ([D/W][rows][W], swizzled at W columns), CPB bytes per
// cp.async, every thread of the block its share; rows at or past n arrive as
// zeros.  src is the head's row 0; row_stride in elements.
template <int CPB, int W, typename T>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, long long row_stride, int row0,
                                        int rows, int n, int D) {
  constexpr int RB = 2 * W;  // bytes of a swizzled row
  const int per_row = D * 2 / CPB;
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  for (int i = threadIdx.x; i < rows * per_row; i += kWgThreads) {
    const int r = i / per_row, cb = (i % per_row) * CPB;  // row, byte in the row
    const uint32_t off = (uint32_t)((cb / RB) * rows * RB + r * RB + cb % RB);
    const int row = row0 + r;
    const bool in = row < n;
    cp_async_zfill<CPB>(d + tma_swizzle<RB>(off),
                        s + (long long)(in ? row : 0) * row_stride * 2 + cb, in ? CPB : 0);
  }
}

template <int W, typename T>
__device__ __forceinline__ void cp_tile_any(int cp, T* dst, const T* src, long long row_stride,
                                            int row0, int rows, int n, int D) {
  if (cp == 16)
    cp_tile<16, W>(dst, src, row_stride, row0, rows, n, D);
  else if (cp == 8)
    cp_tile<8, W>(dst, src, row_stride, row0, rows, n, D);
  else
    cp_tile<4, W>(dst, src, row_stride, row0, rows, n, D);
}

// the masked scores of one 64-query x BK-key tile set to -1e30: keys past
// the causal diagonal and key units off in `on`, and (ELEM) in the units
// marked in `part`, elements off the layout.  Rows are row0 and row0 + 8,
// columns k0 + 8 j + cq (+ 1).
template <bool ELEM, int BK>
__device__ __forceinline__ void sp_mask(float (&s)[BK / 2], int row0, int k0, int cq,
                                        const WgArgs& a, int h, int on, int part) {
  // row - col of element (j, e): d0 - 8 j + 8 (e >> 1) - (e & 1)
  const int d0 = a.causal ? row0 - k0 - cq : 1 << 20;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const int u = j >> 1;  // the key unit of columns 8 j ..
      if (d0 - 8 * j + 8 * (e >> 1) - (e & 1) < 0 || !((on >> u) & 1)) s[i] = kNegInf;
      if (ELEM && ((part >> u) & 1) &&
          !layout_on(a.layout, a.Hl, a.S, a.lblock, h, row0 + 8 * (e >> 1),
                     k0 + 8 * j + cq + (e & 1)))
        s[i] = kNegInf;
    }
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
    sparse_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const WgArgs a) {
  using C = SpCfg<D, BK>;
  constexpr int BQ = C::BQ, ST = C::STAGES, AHEAD = C::AHEAD, W = C::W;
  constexpr int FULL = (1 << (BK / 16)) - 1;  // every key unit of a tile on
  constexpr uint32_t SBO = 16 * W;            // an 8-row atom of a swizzled block
  extern __shared__ unsigned char smem_raw[];
  // swizzling repeats every 1024 bytes at most: tiles start on that
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);  // [D/W][BQ][W]
  T* Ks = Qs + BQ * D;                 // [ST][D/W][BK][W]
  T* Vs = Ks + ST * BK * D;            // [ST][D/W][BK][W]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * BK * D);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int BH = a.B * a.H;
  const int nq = (a.S + BQ - 1) / BQ;
  // under causal attention the later query tiles visit more keys: first
  const int qt = a.causal ? nq - 1 - (int)(blockIdx.x / BH) : (int)(blockIdx.x / BH);
  const int b = (blockIdx.x % BH) / a.H, h = (blockIdx.x % BH) % a.H;
  const int q0 = qt * BQ;
  const int lr = (a.Hl == 1 ? 0 : h) * nq + qt;
  const int e0 = a.row_ptr[lr];
  const int n_kt = a.row_ptr[lr + 1] - e0;
  const int* cols = a.cols + e0;
  const uint8_t* masks = a.masks != nullptr ? a.masks + 16LL * e0 : nullptr;
  const bool tma = a.cp == 0;
  const T* qg = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kg = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vg = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;

  if (threadIdx.x == 0) {
    // TMA: thread 0's one arrival and the bytes; cp.async: every thread's
    mbar_init(q_full, tma ? 1 : kWgThreads);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], tma ? 1 : kWgThreads);
      mbar_init(&empty[s], kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the ring: tile t of the list into stage t % ST once both warpgroups
  // are done with the stage's previous tile (thread 0 by TMA, or every
  // thread its share by cp.async)
  auto issue = [&](int t) {
    const int st = t % ST;
    const int k0 = cols[t] * BK;
    if (t >= ST) mbar_wait(&empty[st], (t / ST - 1) & 1);
    T* kd = Ks + st * BK * D;
    T* vd = Vs + st * BK * D;
    if (tma) {
      mbar_arrive_tx(&full[st], 2 * C::KV_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / W; ++cb) {
        tma_load_4d(kd + cb * W * BK, &tk, cb * W, h, k0, b, &full[st]);
        tma_load_4d(vd + cb * W * BK, &tv, cb * W, h, k0, b, &full[st]);
      }
    } else {
      cp_tile_any<W>(a.cp, kd, kg, a.kss, k0, BK, a.S, D);
      cp_tile_any<W>(a.cp, vd, vg, a.vss, k0, BK, a.S, D);
      cp_async_mbar_arrive(&full[st]);
    }
  };
  const bool issuer = !tma || threadIdx.x == 0;
  if (tma) {
    if (issuer) {
      mbar_arrive_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / W; ++cb) tma_load_4d(Qs + cb * W * BQ, &tq, cb * W, h, q0, b, q_full);
    }
  } else {
    cp_tile_any<W>(a.cp, Qs, qg, a.qss, q0, BQ, a.S, D);
    cp_async_mbar_arrive(q_full);
  }
  if (issuer)
    for (int t = 0; t < min(n_kt, AHEAD); ++t) issue(t);

  // warpgroup c holds queries [qw, qw + 64); warp w of it row unit 4 c + w
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x - 128 * c;
  const int lane = tid & 31, warp = tid >> 5;
  const int unit = 4 * c + warp;
  const int qw = q0 + 64 * c;
  const int row0 = qw + 16 * warp + (lane >> 2);  // this lane's rows: row0, row0 + 8
  const int cq = (lane & 3) * 2;                  // and its column pair
  const bool live = qw < a.S;
  const float scale2 = a.sm_scale * kLog2e;
  const T* Qw = Qs + 64 * c * W;  // this warpgroup's rows of each column block

  // the tiles this warpgroup computes: under causal attention the listed
  // tiles wholly past its last row (the list ascends) are loaded for the
  // other warpgroup only
  int n_act = live ? n_kt : 0;
  if (a.causal)
    while (n_act > 0 && cols[n_act - 1] * BK > qw + 63) --n_act;

  float o[D / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pf[BK / 16][4];
  mbar_wait(q_full, 0);
  if (!tma) fence_proxy_async();

  // S = Q K^T of tile t, committed
  auto qk = [&](int t) {
    const int stage = t % ST;
    mbar_wait(&full[stage], (t / ST) & 1);
    if (!tma) fence_proxy_async();  // the cp.async copies, before wgmma reads them
    const T* Kc = Ks + stage * BK * D;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // column block kk * 16 / W, then 16 columns (32 bytes) into its rows
      const int cb = kk * 16 / W, off = kk * 16 % W;
      WgmmaSS<T, BK>::run(s, gmma_desc_sw<W>(Qw + cb * W * BQ + off, 16, SBO),
                          gmma_desc_sw<W>(Kc + cb * W * BK + off, 16, SBO), kk > 0);
    }
    wg_commit();
  };
  // O += P V of tile t (P in pf), committed; V read MN-major: its column
  // blocks W * BK apart, 16 keys (rows) per step
  auto pv = [&](int t) {
    const T* Vc = Vs + (t % ST) * BK * D;
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq)
      WgmmaRS<T, D>::run(o, pf[kq], gmma_desc_sw<W>(Vc + kq * 16 * W, W * BK * 2, SBO));
    wg_commit();
  };

  for (int t = 0; t < n_kt; ++t) {
    if (issuer && t + AHEAD < n_kt) issue(t + AHEAD);
    if (t >= n_act) {  // loaded for the other warpgroup only
      mbar_wait(&full[t % ST], (t / ST) & 1);
      mbar_arrive(&empty[t % ST]);
      continue;
    }
    const int k0 = cols[t] * BK;
    qk(t);
    if (t > 0) {
      pv(t - 1);
      wg_wait<1>();  // S of tile t is done; P V of tile t - 1 runs on
    } else {
      wg_wait<0>();
    }
    pin(s);
    // this warp's row unit: its key units on and partly visible in tile t;
    // a tile that reaches past the warp's first row crosses the diagonal
    const int on = masks != nullptr ? masks[16 * t + unit] : FULL;
    const int part = masks != nullptr ? masks[16 * t + 8 + unit] : 0;
    const bool edge = (a.causal && k0 + BK - 1 > qw + 16 * warp) || on != FULL || part != 0;
    if (part != 0)
      sp_mask<true, BK>(s, row0, k0, cq, a, h, on, part);
    else if (edge)
      sp_mask<false, BK>(s, row0, k0, cq, a, h, on, part);
    // online softmax of the lane's two rows (element i is row (i >> 1) &
    // 1) on the unscaled scores: p = 2^(s sm_scale log2(e) - m'), one fma
    // and ex2 a score, m' the row's scaled maximum
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = ex2((m[r] - mx[r]) * scale2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale2;
      l[r] *= alpha[r];
    }
    // a masked score adds 0, also to a row that has seen no key yet (its
    // maximum is still -1e30)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p =
          edge && s[i] == kNegInf ? 0.f : ex2(fmaf(s[i], scale2, -ms[(i >> 1) & 1]));
      l[(i >> 1) & 1] += p;
      s[i] = p;
    }
    wg_wait<0>();  // P V of tile t - 1: its stage is free, O may be rescaled
    pin(o);
    pin(pf);
    if (t > 0) mbar_arrive(&empty[(t - 1) % ST]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_a<T, BK>(pf, s);
    if (t == n_act - 1) {  // the last tile's P V, then its stage
      pv(t);
      wg_wait<0>();
      pin(o);
      pin(pf);
      mbar_arrive(&empty[t % ST]);
    }
  }

  if (!live) return;
  // l is 0 only for a row that saw no key: its output is 0
  const float lc[2] = {fmaxf(quad_sum(l[0]), 1e-20f), fmaxf(quad_sum(l[1]), 1e-20f)};
  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= a.S) continue;
    T* row = op + (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + cq) =
          Cvt<T>::pack(o[4 * j + 2 * r] / lc[r], o[4 * j + 2 * r + 1] / lc[r]);
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
template <typename T>
cudaError_t launch_wide(int D, const Args& a, cudaStream_t st) {
  constexpr size_t smem = wide_fwd_smem();
  static const cudaError_t attr = opt_in(sparse_attn_wide_kernel<T>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H, (D + kWidePart - 1) / kWidePart);
  sparse_attn_wide_kernel<T><<<grid, kWideThreads, smem, st>>>(a, D);
  return cudaGetLastError();
}

template <int D, bool ELEM>
cudaError_t launch_fma(const Args& a, cudaStream_t st) {
  constexpr size_t smem = fma_smem_bytes<D>();
  static const cudaError_t attr = opt_in(sparse_attn_fma_kernel<D, ELEM>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  sparse_attn_fma_kernel<D, ELEM><<<grid, kFmaThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, int BK>
cudaError_t launch_wgmma(const WgArgs& a, cudaStream_t st) {
  using C = SpCfg<D, BK>;
  CUtensorMap m[3] = {};
  if (a.cp == 0) {
    cudaError_t e;
    if ((e = head_map_sw<T>(&m[0], a.q, D, a.S, a.H, a.B, a.qsb, a.qss, a.qsh, C::BQ, C::W)) !=
            cudaSuccess ||
        (e = head_map_sw<T>(&m[1], a.k, D, a.S, a.H, a.B, a.ksb, a.kss, a.ksh, BK, C::W)) !=
            cudaSuccess ||
        (e = head_map_sw<T>(&m[2], a.v, D, a.S, a.H, a.B, a.vsb, a.vss, a.vsh, BK, C::W)) !=
            cudaSuccess)
      return e;
  }
  static const cudaError_t attr = opt_in(sparse_attn_wgmma_kernel<T, D, BK>, C::smem);
  if (attr != cudaSuccess) return attr;
  const unsigned blocks = (unsigned)((a.S + C::BQ - 1) / C::BQ) * a.B * a.H;
  sparse_attn_wgmma_kernel<T, D, BK><<<blocks, kWgThreads, C::smem, st>>>(m[0], m[1], m[2], a);
  return cudaGetLastError();
}

template <int D, int BK>
cudaError_t launch_dtype(int dtype, const WgArgs& a, cudaStream_t st) {
  switch (dtype) {
    case 1: return launch_wgmma<__nv_bfloat16, D, BK>(a, st);
    case 2: return launch_wgmma<__half, D, BK>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// the key tiles a head dim is built for: 128 (up to D = 64, lists without
// unit masks) and 64
template <int D>
cudaError_t dispatch_wgmma(int dtype, int bk, const WgArgs& a, cudaStream_t st) {
  if constexpr (D <= 64) {
    if (bk == 128) return launch_dtype<D, 128>(dtype, a, st);
  }
  if (bk == 64) return launch_dtype<D, 64>(dtype, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// fp32 (dtype 0) and, for every dtype (1 = bf16, 2 = fp16), head dims past
// 256.  q/k/v [B, S, H, D] read through the given element strides (the last
// dim contiguous); o [B, S, H, D] contiguous.  row_ptr [Hl * NB + 1] and
// cols: the layout's on-blocks per (layout head, block row), ascending, only
// those at or below the diagonal when causal (NB = ceil(S / block); Hl is 1
// or H).  Without masks, block is a multiple of 64 and S a multiple of
// block.  With masks (int32, one per entry of cols: the entry's 16 x 16 unit
// bits, and in bits 16-31 those of partly visible units), the lists are of
// 64 x 64 tiles and block is 64; then layout (null, or the layout as bytes
// [Hl, S / lblock, S / lblock]) gives the partial units' elements.  fp32 D
// is a multiple of 16 to 128 or of 32 to 256; past 256 any D (the
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
  if (D <= 256 && dtype != 0) return (int)cudaErrorInvalidValue;  // dstpu_sparse_attention_wgmma
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
    return (int)(a.layout != nullptr ? launch_fma<d, true>(a, st) : launch_fma<d, false>(a, st));
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

// bf16 (dtype 1) and fp16 (2), D a multiple of 16 to 128 or of 32 to 256.
// q/k/v [B, S, H, D] read through the given element strides (the last dim
// contiguous); cp = 0: every base 16-byte aligned and every stride a
// positive multiple of 8 elements (TMA); else cp.async copies of cp (16, 8
// or 4) bytes, which must divide every base and stride in bytes.  o [B, S,
// H, D] contiguous.  row_ptr [Hl * ceil(S / 128) + 1] and cols: per (layout
// head, 128-row query tile) the key tiles of bk keys (128 for D up to 64,
// or 64) to visit, ascending, none wholly above the tile's last row when
// causal.  masks: null when every unit of each listed tile is on (a layout
// block that is a multiple of 128), else 16 bytes per entry of cols (byte r:
// bit u set when key unit u of the tile is on for row unit r, 16 x 16
// units; byte 8 + r: those only partly visible); layout (the layout as
// bytes [Hl, S / lblock, S / lblock]) is read for partly visible units
// only.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dstpu_sparse_attention_wgmma(const void* q, const void* k, const void* v,
                                            void* o, const void* row_ptr, const void* cols,
                                            const void* masks, const void* layout,
                                            int dtype, int B, int S, int H, int D,
                                            int Hl, int lblock, int causal, int cp, int bk,
                                            float sm_scale, long long qsb, long long qss,
                                            long long qsh, long long ksb, long long kss,
                                            long long ksh, long long vsb, long long vss,
                                            long long vsh, void* stream) {
  if ((Hl != 1 && Hl != H) || H <= 0 || lblock <= 0 || S % lblock != 0 ||
      (cp != 0 && cp != 16 && cp != 8 && cp != 4))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const WgArgs a{q, k, v, o, static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
                 static_cast<const uint8_t*>(masks), static_cast<const uint8_t*>(layout),
                 B, S, H, Hl, lblock, causal, cp, sm_scale, qsb, qss, qsh, ksb, kss, ksh, vsb,
                 vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define DSTPU_SPARSE_WG_CASE(d) \
  case d:                       \
    return (int)dispatch_wgmma<d>(dtype, bk, a, st);
    DSTPU_SPARSE_WG_CASE(16)
    DSTPU_SPARSE_WG_CASE(32)
    DSTPU_SPARSE_WG_CASE(48)
    DSTPU_SPARSE_WG_CASE(64)
    DSTPU_SPARSE_WG_CASE(80)
    DSTPU_SPARSE_WG_CASE(96)
    DSTPU_SPARSE_WG_CASE(112)
    DSTPU_SPARSE_WG_CASE(128)
    DSTPU_SPARSE_WG_CASE(160)
    DSTPU_SPARSE_WG_CASE(192)
    DSTPU_SPARSE_WG_CASE(224)
    DSTPU_SPARSE_WG_CASE(256)
#undef DSTPU_SPARSE_WG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
