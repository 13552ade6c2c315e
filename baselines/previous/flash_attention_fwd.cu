// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// :_fwd_kernel (via _fwd / flash_attention), the attention of the paged
// prefill programs (whole-prompt and chunked prefill with a runtime
// q_offset) and of the training forward.
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
// time is the tensor-core rate (4.3 us at 989 TFLOP/s), which only wgmma
// reaches.
//
// Design, bf16 and fp16 (serving and training): one block of two consumer
// warpgroups per (b * NH + h, 128-row query tile), each warpgroup 64 rows;
// one block per SM, so a thread may hold 255 registers.
//   Copies.  Q arrives once, K and V tiles of BK keys (128 for D <= 64, 64
//   above) through a ring of up to 5 stages, by TMA from tensor maps over
//   [B, S, H, D] with the tensors' own strides (strided views are read in
//   place), in column blocks of W = 64, 32 or 16 (the widest that divides
//   the kernel's D) swizzled at W, so every TMA request is a row of 2 W
//   bytes (csrc/hopper.cuh; 16-byte panels, 4-8 times the requests, held
//   the first version of this kernel to ~60 % of its present speed on the
//   card).  Thread 0 issues every copy, as in the backward: a producer warp
//   would cap every thread at 168 registers.  Rows past S and columns past
//   a head dim that is not the kernel's (D = 72 runs the D = 80 kernel)
//   arrive as zeros, which leave q . k unchanged and give output columns
//   that are not stored.
//   Products.  S = Q K^T by wgmma with both operands in shared memory
//   (K-major); the online softmax in registers, in the log2 domain (ex2 of
//   s * sm_scale * log2(e)); O += P V by wgmma with P packed from the S
//   accumulators as the register A operand and V read MN-major from the same
//   panels, so nothing is transposed.  In fp16 P enters as two terms, hi
//   and lo (hopper.cuh pack_a_lo), each with its own P V product into O, so
//   ~22 bits of P reach the sum as in the TPU kernel's fp32 P; bf16 keeps
//   one term (its limit allows for it).  Each warpgroup keeps the tensor
//   cores busy under its own softmax: it issues S of tile t and P V of tile
//   t - 1 together, forms tile t's probabilities while P V runs, and only
//   then rescales O (the stage of tile t - 1 is released a tile late, so the
//   ring runs STAGES - 2 tiles ahead).  The two warpgroups of a block run
//   independently, so one's softmax also overlaps the other's products.
//   Masks.  The causal/ragged mask and the ALiBi term are compiled into
//   separate versions of the per-element code; the masked one runs only on
//   tiles that cross the diagonal or valid_k.  Key tiles past the causal
//   diagonal of a block are never loaded; a warpgroup skips the loaded tiles
//   wholly past its own last row.  Causal query tiles run heaviest first.
//   D up to 256: the O accumulator is D/2 fp32 registers a thread (128 at
//   D = 256, where the ring is 2 stages of 64 keys).
//
// Design, fp32 (tests and small references): one block of 256 threads per
// 64-row query tile on the fp32 FMA pipes out of shared memory — a 16x16
// thread grid, 4 rows x 4 strided columns per thread — so fp32 stays fp32
// end to end (no TF32).
//
// Head dims past 256, every type: the runtime-head-dim kernel
// (csrc/wide_head.cuh), fp32 on the FMA pipes with the output columns in
// parts of 128 over a grid axis and S over the whole head in 32-column
// chunks.  No public model has such a head; it is right, not fast.

#include "hopper.cuh"
#include "wide_head.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 64;  // fp32 kernel: query- and key-tile rows
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

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  const float* slopes;
  int B, NH, KVH, Sq, Sk, D, Dm, valid_k, q_offset, causal;  // D: true head dim; Dm: the maps'
  float sm_scale;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

// ---------------------------------------------------------------------------
// Hopper kernel (bf16, fp16): wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int kThreadsWg = 256;  // two consumer warpgroups, 64 rows each
constexpr size_t kSmemCap = 232448 - 1024;

template <int D>
struct FwdCfg {
  static constexpr int BQ = 128;                // queries per block, 64 per warpgroup
  static constexpr int BK = D <= 64 ? 128 : 64;  // keys per pipeline step
  // columns of a swizzled block: the widest of 64, 32, 16 that divides D
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one of K, V
  static constexpr int FIT = (int)((kSmemCap - Q_BYTES) / (2 * KV_BYTES));
  static constexpr int STAGES = FIT < 5 ? FIT : 5;
  // tiles in flight ahead of the one computed: a tile's stage is released
  // while the next tile is computed (its P V runs under that tile's
  // softmax), so the stage refilled held the tile two before the current one
  static constexpr int AHEAD = STAGES - 2;
  static constexpr size_t smem =
      1024 + Q_BYTES + (size_t)STAGES * 2 * KV_BYTES + (1 + 2 * STAGES) * 8;
  static_assert(STAGES >= 2, "ring");
};

// the scores of one 64-query x BK-key tile in the log2 domain, masked to
// -1e30.  Rows are positions row0 and row0 + 8, columns keys k0 + 8 j + cq (+ 1).
template <bool ALIBI, bool EDGE, int BK>
__device__ __forceinline__ void fwd_scores(float (&s)[BK / 2], int row0, int k0, int cq,
                                           const Args& a, float scale2, float slope2) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const int row = row0 + 8 * (e >> 1);
      const int col = k0 + 8 * j + cq + (e & 1);
      float x = s[i] * scale2;
      if (ALIBI) x -= slope2 * (float)(row - col);
      if (EDGE && !visible(row, col, a.valid_k, a.causal)) x = kNegInf;
      s[i] = x;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsWg, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = FwdCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, AHEAD = C::AHEAD, W = C::W;
  // an 8-row atom of a swizzled block; K steps of 16 columns
  constexpr uint32_t SBO = 16 * W;
  extern __shared__ unsigned char smem_raw[];
  // swizzling repeats every 1024 bytes at most: tiles start on that
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);  // [D/W][BQ][W]
  T* Ks = Qs + BQ * D;                 // [ST][D/W][BK][W]
  T* Vs = Ks + ST * BK * D;            // [ST][D/W][BK][W]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * BK * D);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int BH = a.B * a.NH;
  const int n_qb = (a.Sq + BQ - 1) / BQ;
  // heaviest query tiles (the most keys under causal attention) first
  const int qb = a.causal ? n_qb - 1 - (int)(blockIdx.x / BH) : (int)(blockIdx.x / BH);
  const int b = (blockIdx.x % BH) / a.NH, h = (blockIdx.x % BH) % a.NH;
  const int kvh = h / (a.NH / a.KVH);
  const int q0 = qb * BQ;
  // keys past the tile's last row are above the diagonal for every row
  int k_end = a.valid_k;
  if (a.causal) k_end = min(k_end, a.q_offset + q0 + BQ);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreadsWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 keeps the ring AHEAD tiles ahead: for tile t it waits until
  // both warpgroups are done with the stage's previous tile
  const bool issuer = threadIdx.x == 0;
  auto issue = [&](int t) {
    const int st = t % ST;
    if (t >= ST) mbar_wait(&empty[st], (t / ST - 1) & 1);
    mbar_arrive_tx(&full[st], 2 * C::KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < D / W; ++cb) {
      tma_load_4d(Ks + (st * D + cb * W) * BK, &tk, cb * W, kvh, t * BK, b, &full[st]);
      tma_load_4d(Vs + (st * D + cb * W) * BK, &tv, cb * W, kvh, t * BK, b, &full[st]);
    }
  };
  if (issuer) {
    mbar_arrive_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int cb = 0; cb < D / W; ++cb) tma_load_4d(Qs + cb * W * BQ, &tq, cb * W, h, q0, b, q_full);
    for (int t = 0; t < min(n_kt, AHEAD); ++t) issue(t);
  }

  // warpgroup c holds queries [qw, qw + 64)
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x - 128 * c;
  const int lane = tid & 31;
  const int qw = q0 + 64 * c;
  const int lrow = qw + 16 * (tid >> 5) + (lane >> 2);  // this lane's rows: lrow, lrow + 8
  const int row0 = a.q_offset + lrow;                    // and their positions
  const int cq = (lane & 3) * 2;                         // and its column pair
  const int last_pos = a.q_offset + qw + 63;             // the warpgroup's last row
  const bool live = qw < a.Sq;
  const float scale2 = a.sm_scale * kLog2e;
  const float slope2 = a.slopes != nullptr ? a.slopes[h] * kLog2e : 0.f;
  const T* Qw = Qs + 64 * c * W;  // this warpgroup's rows of each column block

  float o[D / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // P as the A operand; fp16 adds its second term pl (hopper.cuh pack_a_lo)
  constexpr bool SPLIT = kSplitA<T>;
  uint32_t pf[BK / 16][4], pl[SPLIT ? BK / 16 : 1][4];
  // the key tiles this warpgroup computes: a tile wholly past its last row
  // is masked out whole under causal attention
  const int n_act = !live ? 0 : a.causal ? min(n_kt, last_pos / BK + 1) : n_kt;
  mbar_wait(q_full, 0);

  // S = Q K^T of tile t, committed
  auto qk = [&](int t) {
    const int stage = t % ST;
    mbar_wait(&full[stage], (t / ST) & 1);
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
    if constexpr (SPLIT) {
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq)
        WgmmaRS<T, D>::run(o, pl[kq], gmma_desc_sw<W>(Vc + kq * 16 * W, W * BK * 2, SBO));
    }
    wg_commit();
  };

  for (int t = 0; t < n_kt; ++t) {
    if (issuer && t + AHEAD < n_kt) issue(t + AHEAD);
    if (t >= n_act) {  // loaded for the other warpgroup only
      mbar_wait(&full[t % ST], (t / ST) & 1);
      mbar_arrive(&empty[t % ST]);
      continue;
    }
    const int k0 = t * BK;
    qk(t);
    if (t > 0) {
      pv(t - 1);
      wg_wait<1>();  // S of tile t is done; P V of tile t - 1 runs on
    } else {
      wg_wait<0>();
    }
    pin(s);
    const bool edge = (a.causal && k0 + BK - 1 > a.q_offset + qw) || k0 + BK > a.valid_k;
    if (a.slopes != nullptr) {
      if (edge)
        fwd_scores<true, true, BK>(s, row0, k0, cq, a, scale2, slope2);
      else
        fwd_scores<true, false, BK>(s, row0, k0, cq, a, scale2, slope2);
    } else if (edge) {
      fwd_scores<false, true, BK>(s, row0, k0, cq, a, scale2, 0.f);
    } else {
      fwd_scores<false, false, BK>(s, row0, k0, cq, a, scale2, 0.f);
    }
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
    if constexpr (SPLIT) pin(pl);
    if (t > 0) mbar_arrive(&empty[(t - 1) % ST]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_a<T, BK>(pf, s);
    if constexpr (SPLIT) pack_a_lo<BK>(pl, s);
    if (t == n_act - 1) {  // the last tile's P V, then its stage
      pv(t);
      wg_wait<0>();
      pin(o);
      pin(pf);
      if constexpr (SPLIT) pin(pl);
      mbar_arrive(&empty[t % ST]);
    }
  }

  if (!live) return;
  const float lc[2] = {fmaxf(quad_sum(l[0]), 1e-30f), fmaxf(quad_sum(l[1]), 1e-30f)};
  T* op = static_cast<T*>(a.o);
  float* lse = static_cast<float*>(a.lse);
  const bool pairs = (a.D & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = lrow + 8 * r;
    if (qi >= a.Sq) continue;
    T* row = op + (((long long)b * a.Sq + qi) * a.NH + h) * a.D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cq;
      const float v0 = o[4 * j + 2 * r] / lc[r], v1 = o[4 * j + 2 * r + 1] / lc[r];
      if (pairs && col + 1 < a.D) {
        *reinterpret_cast<uint32_t*>(row + col) = Cvt<T>::pack(v0, v1);
      } else {
        const uint32_t pk = Cvt<T>::pack(v0, v1);
        if (col < a.D) reinterpret_cast<uint16_t*>(row)[col] = (uint16_t)(pk & 0xFFFFu);
        if (col + 1 < a.D) reinterpret_cast<uint16_t*>(row)[col + 1] = (uint16_t)(pk >> 16);
      }
    }
    if ((lane & 3) == 0)
      lse[((long long)b * a.NH + h) * a.Sq + qi] =
          (m[r] == kNegInf ? kNegInf : m[r] * kLn2) + logf(lc[r]);
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
                     int KVH, int Sq, int Sk, int Dt, int valid_k, int q_offset,
                     int causal, float sm_scale, long long qsb, long long qss, long long qsh,
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
    Qs[r * DP + d] = qi < Sq && d < Dt ? qb[qi * qss + d] : 0.f;
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
      const bool in = kj < Sk && d < Dt;
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
    float* orow = o + (((long long)b * Sq + qi) * NH + h) * Dt;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < Dt) orow[tx + 16 * c] = acc[r][c] / lc;
    if (tx == 0) lse[((long long)b * NH + h) * Sq + qi] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// runtime head dim (past 256), any of the three types: csrc/wide_head.cuh
// ---------------------------------------------------------------------------
// One block of 256 threads per (64-row query tile, b * NH + h, part of at
// most 128 output columns); S over the whole head in 32-column chunks, the
// softmax as in the fp32 kernel, O += P V for the part's columns.  Every
// part recomputes S; part 0 writes the lse.
template <typename T>
__global__ void __launch_bounds__(kWideThreads) flash_fwd_wide_kernel(const Args a) {
  extern __shared__ float wsm[];
  float* As = wsm;                         // [64][kWideLd]
  float* Bs = As + kWideRows * kWideLd;    // [64][kWideLd]
  float* Ps = Bs + kWideRows * kWideLd;    // [64][kWidePd]
  float* Vs = Ps + kWideRows * kWidePd;    // [64][kWidePart]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / a.NH, h = bh % a.NH;
  const int kvh = h / (a.NH / a.KVH);
  const int q_start = blockIdx.x * kWideRows;
  const int c0 = blockIdx.z * kWidePart;  // this block's output columns
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  int k_end = a.valid_k;
  if (a.causal) k_end = min(k_end, a.q_offset + q_start + kWideRows);
  const int n_tiles = k_end > 0 ? (k_end + kWideRows - 1) / kWideRows : 0;

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kWideRows;
    float s[4][4] = {};
    wide_dot(s, As, Bs, qb, a.qss, q_start, a.Sq, kb, a.kss, k0, a.Sk, a.D);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = a.q_offset + q_start + ty * 4 + r;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float sv = s[r][j] * a.sm_scale;
        if (a.slopes != nullptr) sv -= slope * (float)(row - col);
        s[r][j] = visible(row, col, a.valid_k, a.causal) ? sv : kNegInf;
        mt = fmaxf(mt, s[r][j]);
      }
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        Ps[(ty * 4 + r) * kWidePd + tx + 16 * j] = p;
        psum += p;
      }
      psum = half_warp_sum(psum);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
    }
    wide_stage(Vs, kWidePart, kWidePart, vb, a.vss, k0, a.Sk, c0, a.D);
    __syncthreads();
    wide_pv(acc, Ps, Vs);
  }

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_start + ty * 4 + r;
    if (qi >= a.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = op + (((long long)b * a.Sq + qi) * a.NH + h) * a.D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < a.D) wide_put(orow + col, acc[r][c] / lc);
    }
    if (tx == 0 && blockIdx.z == 0)
      static_cast<float*>(a.lse)[((long long)b * a.NH + h) * a.Sq + qi] = m[r] + logf(lc);
  }
}

template <typename T>
cudaError_t launch_wide(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = wide_fwd_smem();
  static const cudaError_t attr = opt_in(flash_fwd_wide_kernel<T>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + kWideRows - 1) / kWideRows, a.B * a.NH,
                  (a.D + kWidePart - 1) / kWidePart);
  flash_fwd_wide_kernel<T><<<grid, kWideThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename T, int D>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap m[3];
  cudaError_t e;
  if ((e = head_map_sw<T>(&m[0], a.q, a.Dm, a.Sq, a.NH, a.B, a.qsb, a.qss, a.qsh, C::BQ,
                          C::W)) != cudaSuccess ||
      (e = head_map_sw<T>(&m[1], a.k, a.Dm, a.Sk, a.KVH, a.B, a.ksb, a.kss, a.ksh, C::BK,
                          C::W)) != cudaSuccess ||
      (e = head_map_sw<T>(&m[2], a.v, a.Dm, a.Sk, a.KVH, a.B, a.vsb, a.vss, a.vsh, C::BK,
                          C::W)) != cudaSuccess)
    return e;
  static const cudaError_t attr = opt_in(flash_fwd_wgmma_kernel<T, D>, C::smem);
  if (attr != cudaSuccess) return attr;
  const unsigned blocks = (unsigned)((a.Sq + C::BQ - 1) / C::BQ) * a.B * a.NH;
  flash_fwd_wgmma_kernel<T, D><<<blocks, kThreadsWg, C::smem, stream>>>(m[0], m[1], m[2], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<D>();
  static const cudaError_t attr = opt_in(flash_fwd_fma_kernel<D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.NH);
  flash_fwd_fma_kernel<D><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), static_cast<float*>(a.lse),
      a.slopes, a.NH, a.KVH, a.Sq, a.Sk, a.D, a.valid_k, a.q_offset, a.causal, a.sm_scale,
      a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const Args& a, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fma<D>(a, stream);
    case 1:
      return launch_wgmma<__nv_bfloat16, D>(a, stream);
    case 2:
      return launch_wgmma<__half, D>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16.  q [B, Sq, NH, *] and k/v [B, Sk, KVH, *]
// with the given element strides (the last dim contiguous); D >= 1 is the
// head dim of the output and of the fp32 reads; up to 256, for bf16/fp16 the
// maps read Dm >= D columns (Dm a multiple of 8, every base and stride
// 16-byte aligned and positive; columns D..Dm zero), and the kernel runs at D
// rounded up to a multiple of 16 (to 32 past 128).  Past 256 the
// runtime-head-dim kernel reads the rows at D, any alignment (Dm unused).  o [B, Sq, NH, D] contiguous in q's
// dtype; lse [B, NH, Sq] fp32; slopes [NH] fp32 or null.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dstpu_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* slopes,
    int dtype, int B, int NH, int KVH, int Sq, int Sk, int D, int Dm, int valid_k,
    int q_offset, int causal, float sm_scale, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    void* stream) {
  if (KVH <= 0 || NH % KVH != 0 || valid_k > Sk || valid_k <= 0 || Sq <= 0 || Sk <= 0 ||
      D < 1 || (D <= 256 && dtype != 0 && (Dm < D || Dm % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, lse, static_cast<const float*>(slopes), B, NH, KVH, Sq, Sk, D, Dm,
               valid_k, q_offset, causal, sm_scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
               vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > 256) {  // the runtime-head-dim kernel, every type
    switch (dtype) {
      case 0: return (int)launch_wide<float>(a, st);
      case 1: return (int)launch_wide<__nv_bfloat16>(a, st);
      case 2: return (int)launch_wide<__half>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  // the kernel's head dim: D rounded up to 16, past 128 to 32
  switch (D <= 128 ? (D + 15) / 16 * 16 : (D + 31) / 32 * 32) {
#define DSTPU_FWD_CASE(d) \
  case d:                 \
    return (int)dispatch_dtype<d>(dtype, a, st);
    DSTPU_FWD_CASE(16)
    DSTPU_FWD_CASE(32)
    DSTPU_FWD_CASE(48)
    DSTPU_FWD_CASE(64)
    DSTPU_FWD_CASE(80)
    DSTPU_FWD_CASE(96)
    DSTPU_FWD_CASE(112)
    DSTPU_FWD_CASE(128)
    DSTPU_FWD_CASE(160)
    DSTPU_FWD_CASE(192)
    DSTPU_FWD_CASE(224)
    DSTPU_FWD_CASE(256)
#undef DSTPU_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
