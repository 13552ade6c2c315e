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
// What bounds it on the H100: bytes.  Decode does about 2 FLOP per KV byte,
// far below the ~295 a byte the card needs before its arithmetic is the
// limit, so the least time is the live KV over 3.35 TB/s: 9.6 MB of bf16 KV
// at llama-1b's decode shape (B = 8, ~600 live slots a sequence, 8 KV heads,
// D = 64) is ~3 us, llama-7b's 77 MB (32 KV heads, D = 128) ~23 us.  The
// design keeps enough KV bytes in flight on every SM, in one launch, and
// keeps the arithmetic off the critical path by running it in many
// independent warps:
//   Work.  One block per (b, kv head, split, row group) holds up to 8 of
//   that head's G = NH / KVH query rows, so every K/V byte is read once for
//   a GQA group of up to 8 rows (wider groups, as falcon-7b's 71 query
//   heads over one KV head, are cut into row groups over a grid axis).  The
//   splits of one (b, kv head, row group) (1 to 8, chosen by the wrapper:
//   about two blocks an SM, but never more blocks than the SMs hold at
//   once, dstpu_paged_decode_resident: a second wave cost Mixtral-8x7b's
//   decode shape half again its time on the H100) form a thread-block
//   cluster, and each takes an equal run of the sequence's live chunks:
//   runs of up to 16 slots that divide the page, so a stage stays small at
//   any page size.
//   Chunks past positions[b] / chunk (the trash page, stale pages, the
//   unwritten end of the last page) are never loaded, so garbage there, NaN
//   included, cannot reach the output (the TPU kernel visits all MP pages
//   and masks them); a block whose run is empty loads nothing.  The block
//   reads the position and its table row once, together.
//   Warps.  Warp w of the block's W (8, or fewer where 8 warps' rings and
//   accumulators do not fit shared memory: fp32 pools at wide heads, G = 8
//   at D = 256) takes chunks w, w + W, ... of the block's run and streams
//   them through its own ring of up to 4 stages, with its own (m, l, acc):
//   no block barrier inside the loop, so the warps (and the other blocks
//   on the SM) hide each other's latencies.  (A block that walked its
//   pages in lockstep, its phases waiting on each other at every step, was
//   slower on the H100 than the kernel it replaced.)
//   Copies.  Lane 0 issues one TMA copy per chunk and operand from a 3-D
//   map over the pool [P * ps, KVH, D] (box D x 1 x chunk at (0, kvh, the
//   chunk's first row)) when the rows are the kernel's full width;
//   otherwise (a head dim off 16, rows read in place and zero-filled past
//   D) the warp's lanes copy
//   16-byte vectors by cp.async.  Either way the copies, and the int8 scales
//   (4-byte cp.async), complete on the stage's mbarrier, and a stage is
//   refilled as soon as its warp is done with it.
//   Arithmetic, fp32 on the FMA pipes, the work a chunk needs spread over the
//   warp's lanes with each K or V byte read and widened once for up to 4
//   query rows.  Scores: a few lanes per slot, each a part of the row's
//   16-byte vectors (rotated by the slot, so the 8 lanes of a shared-memory
//   wavefront read 8 different vectors), added by shuffles.  Softmax: a
//   row's slots over a power-of-two group of lanes, reduced by shuffles,
//   one online rescale per chunk and row.  PV: each lane owns 8 output
//   columns over one of 32 / (D / 8) slot groups, reading V rows 16 bytes
//   at a time.  Every sum is fp32 (PV in bf16 on the tensor cores would
//   round P).
//   Merge.  The warps' states merge in warp order in the block.  After
//   cluster.sync(), rank 0 reads the other splits' (m, l, acc) through
//   distributed shared memory, all loads in flight together, merges them in
//   split order and writes the output; a second cluster.sync() keeps the
//   other blocks resident until it has.  Every block reaches both,
//   including one with no chunks.  No second kernel, no fp32 scratch, no
//   atomics: the output is bit-equal across calls.
//
// Head dims: the kernel runs at D rounded up to a multiple of 16 (32 past
// 128) and reads the pools at their own width Dt: columns past Dt are zeros,
// so q . k is unchanged and the extra output columns are not stored.
//
// Head dims past 256: the runtime-head-dim kernel below, the same split of
// the pages with the output columns in parts of 128 over a grid axis, the
// pages read from device memory as they are (no staging), fp32 throughout,
// the runs merged by a second kernel.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;     // each its own pipeline
constexpr int kRows = 4;         // query rows a lane takes at a time
constexpr int kMaxStages = 4;    // chunks in flight per warp
constexpr int kMaxSplit = 8;     // a portable cluster
constexpr int kMaxRows = 8;      // query rows a block
constexpr int kMaxChunk = 16;    // slots a stage
constexpr size_t kSmemBudget = 200 * 1024;
constexpr size_t kRingBudget = 96 * 1024;

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

// 8 consecutive KT from shared memory as floats (one 8-, 16- or 32-byte read)
template <typename KT> __device__ __forceinline__ void load8(const KT* p, float* out) {
  if constexpr (sizeof(KT) == 4) {
    const float4 x = reinterpret_cast<const float4*>(p)[0];
    const float4 y = reinterpret_cast<const float4*>(p)[1];
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    out[4] = y.x; out[5] = y.y; out[6] = y.z; out[7] = y.w;
  } else {
    using R = typename std::conditional<sizeof(KT) == 2, uint4, uint2>::type;
    const R raw = *reinterpret_cast<const R*>(p);
    const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = to_f(e[j]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
// this thread's cp.async copies so far complete on `bar` (one of its
// expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
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
__host__ __device__ inline size_t up128(size_t n) { return (n + 127) & ~size_t(127); }

// A block's shared memory, in bytes from a 128-byte aligned base:
//   ring [warp][NST][K, V] chunk tiles [SC][D] KT (each 128-byte aligned) |
//   scales [warp][NST][K, V][SC] fp32 (int8 pools) | q [R][D] fp32 |
//   per warp: sc [R][SC], m, l, alpha [R], acc [SG][R][D] fp32 | the
//   block's m, l [R] and acc [R][D] | table [MP] int | full [warp][NST]
//   mbarriers.  W warps, R query rows, SC slots a chunk.  A warp's lanes
//   own 8 output columns each, in SG = 32 / (D / 8) slot groups that share
//   a chunk's slots out.
struct Layout {
  int NST, SG;
  size_t tile, scales, qs, sc, stats, acc, bstats, bacc, table, bars, total;
  __host__ __device__ Layout(int W, int R, int D, int SC, int kt, bool quant, int MP, int nst) {
    NST = nst;
    SG = 32 / (D / 8);
    tile = up128((size_t)SC * D * kt);
    scales = (size_t)W * NST * 2 * tile;
    qs = scales + (quant ? up16((size_t)W * NST * 2 * SC * 4) : 0);
    sc = qs + up16((size_t)R * D * 4);
    stats = sc + up16((size_t)W * R * SC * 4);
    acc = stats + up16((size_t)W * 3 * R * 4);
    bstats = acc + up16((size_t)W * SG * R * D * 4);
    bacc = bstats + up16((size_t)2 * R * 4);
    table = bacc + up16((size_t)R * D * 4);
    bars = table + up16((size_t)MP * 4);
    total = bars + (size_t)W * NST * 8;
  }
};

struct DecodeArgs {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale, *slopes;
  const int *page_table, *positions;
  void* out;
  int NH, KVH, Dt, ps, MP, NST;
  int rows, chunk;  // query rows a block (R), slots a chunk (SC, divides ps)
  int tma;          // chunks copied by TMA (else by cp.async)
  float scale;
};

// T: q/out dtype; KT: pool dtype (T, or int8_t with fp32 scales); D: the
// kernel's head dim.  Grid (splits, B * KVH, row groups), clusters of all
// the splits; blockDim.x = 32 W.
template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const DecodeArgs a) {
  constexpr int VN = Vec<KT>::N;   // elements of a 16-byte vector
  constexpr int kVecs = D / VN;    // 16-byte vectors of a K row
  constexpr int C8 = D / 8;        // 8-column groups of an output row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  cg::cluster_group cluster = cg::this_cluster();
  const int W = blockDim.x >> 5, nt = blockDim.x;
  const int G = a.NH / a.KVH, ps = a.ps, R = a.rows, SC = a.chunk, NST = a.NST;
  const int r0 = blockIdx.z * R, nr = min(R, G - r0);  // this block's rows of the group
  const bool quant = a.k_scale != nullptr;
  const Layout L(W, R, D, SC, sizeof(KT), quant, a.MP, NST);
  const int SG = L.SG;
  const int tileE = (int)(L.tile / sizeof(KT));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // scores: lp lanes a slot (a power of two that divides the row's 16-byte
  // vectors, as many as 32 lanes hold for one chunk), part of them this
  // lane's, cpl vectors each, starting at rs (rotated by the slot)
  int lp = 1;
  while (2 * lp * SC <= 32 && kVecs % (2 * lp) == 0) lp *= 2;
  const int part = lane % lp, cpl = kVecs / lp, rs = (lane / lp) % cpl;
  const int split = blockIdx.x;    // the block's rank in its cluster of gridDim.x splits
  const int n_split = gridDim.x;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;

  KT* ring = reinterpret_cast<KT*>(base) + (size_t)warp * NST * 2 * tileE;  // this warp's
  float* scl = reinterpret_cast<float*>(base + L.scales) + (size_t)warp * NST * 2 * SC;
  const float* qs = reinterpret_cast<const float*>(base + L.qs);
  float* sc = reinterpret_cast<float*>(base + L.sc) + (size_t)warp * R * SC;
  float* ms = reinterpret_cast<float*>(base + L.stats) + (size_t)warp * 3 * R;
  float* ls = ms + R;
  float* al = ls + R;
  float* acc = reinterpret_cast<float*>(base + L.acc) + (size_t)warp * SG * R * D;
  float* bm = reinterpret_cast<float*>(base + L.bstats);
  float* bl = bm + R;
  float* bacc = reinterpret_cast<float*>(base + L.bacc);
  int* tbl = reinterpret_cast<int*>(base + L.table);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars) + (size_t)warp * NST;

  // the position, the table row and the query rows (times the scale,
  // zeros past Dt), all loads in flight together
  const int pos = a.positions[b];
  for (int i = tid; i < a.MP; i += nt) tbl[i] = a.page_table[(long long)b * a.MP + i];
  const long long row0 = (long long)b * a.NH + (long long)kvh * G + r0;  // the block's first head
  const T* qb = static_cast<const T*>(a.q) + row0 * a.Dt;
  float* qw = reinterpret_cast<float*>(base + L.qs);
  for (int i = tid; i < nr * D; i += nt)
    qw[i] = i % D < a.Dt ? to_f(qb[(i / D) * a.Dt + i % D]) * a.scale : 0.f;
  for (int i = lane; i < SG * R * D; i += 32) acc[i] = 0.f;
  for (int g = lane; g < R; g += 32) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  if (lane == 0) {
    // every lane's cp.async arrival, and lane 0's TMA byte count
    for (int i = 0; i < NST; ++i) mbar_init(&full[i], 32 + (a.tma ? 1 : 0));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's run [c0, c1) of the sequence's live chunks (chunk j: the
  // slots j SC ... of page table[j / nc]); warp w takes chunks c0 + w,
  // c0 + w + W, ... through its own ring
  const int nc = ps / SC;  // chunks of a page
  const int n_chunks = min(pos / SC + 1, a.MP * nc);
  const int per = (n_chunks + n_split - 1) / n_split;
  const int c0 = min(n_chunks, split * per), c1 = min(n_chunks, c0 + per);
  const int n_w = c1 - c0 > warp ? (c1 - c0 - warp + W - 1) / W : 0;
  const long long row_stride = (long long)a.KVH * a.Dt;  // between slots of a page

  // the warp's i-th chunk into stage i % NST (every lane calls it)
  auto issue = [&](int i) {
    const int st = i % NST;
    const int j = c0 + warp + W * i;
    const int prow = tbl[j / nc] * ps + (j % nc) * SC;  // its first row of the pool
    KT* kd = ring + (size_t)st * 2 * tileE;
    KT* vd = kd + tileE;
    if (a.tma) {
      if (lane == 0) {
        mbar_arrive_tx(&full[st], (uint32_t)(2 * SC * D * sizeof(KT)));
        tma_load_3d(kd, &tk, 0, kvh, prow, &full[st]);
        tma_load_3d(vd, &tv, 0, kvh, prow, &full[st]);
      }
    } else {
      const KT* kp = static_cast<const KT*>(a.k_pool);
      const KT* vp = static_cast<const KT*>(a.v_pool);
      for (int c = lane; c < SC * kVecs; c += 32) {
        const int s = c / kVecs, e0 = (c % kVecs) * VN;
        const long long off = ((long long)prow + s) * row_stride + (long long)kvh * a.Dt + e0;
        if (e0 + VN <= a.Dt &&
            ((reinterpret_cast<uintptr_t>(kp + off) | reinterpret_cast<uintptr_t>(vp + off)) &
             15) == 0) {
          cp_async16(kd + s * D + e0, kp + off);
          cp_async16(vd + s * D + e0, vp + off);
        } else {  // the row's tail past Dt (or an unaligned row): zeros there
          using Raw = typename RawOf<sizeof(KT)>::T;
          Raw* kr = reinterpret_cast<Raw*>(kd + s * D + e0);
          Raw* vr = reinterpret_cast<Raw*>(vd + s * D + e0);
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            kr[e] = e0 + e < a.Dt ? reinterpret_cast<const Raw*>(kp + off)[e] : Raw(0);
            vr[e] = e0 + e < a.Dt ? reinterpret_cast<const Raw*>(vp + off)[e] : Raw(0);
          }
        }
      }
    }
    if (quant) {
      float* ks = scl + (size_t)st * 2 * SC;
      for (int s = lane; s < SC; s += 32) {
        const long long slot = (long long)prow + s;
        cp_async4(ks + s, a.k_scale + slot * a.KVH + kvh);
        cp_async4(ks + SC + s, a.v_scale + slot * a.KVH + kvh);
      }
    }
    cp_async_arrive(&full[st]);
  };

  for (int i = 0; i < min(NST, n_w); ++i) issue(i);
  __syncwarp();  // the lanes' zero-fill stores before any lane reads them
  // lanes of one row's softmax: a power of two up to 32 covering a chunk
  int rl = 1;
  while (rl < SC && rl < 32) rl *= 2;
  const int rows_per_round = 32 / rl;
  for (int i = 0; i < n_w; ++i) {
    const int st = i % NST;
    const int slot0 = (c0 + warp + W * i) * SC;  // the sequence slot of the chunk's first
    const int nv = min(SC, pos + 1 - slot0);     // its live slots: a prefix
    mbar_wait(&full[st], (i / NST) & 1);
    const KT* kc = ring + (size_t)st * 2 * tileE;
    const KT* vc = kc + tileE;
    const float* ksc = scl + (size_t)st * 2 * SC;

    // scores: lp lanes a slot, each a part of the row's 16-byte vectors
    // (rotated by the slot, so that the 8 lanes of a shared-memory wavefront
    // read 8 different vectors), for kRows query rows at a time: each K vector
    // is read and widened once for all of them
    for (int g0 = 0; g0 < nr; g0 += kRows) {
      for (int s0 = 0; s0 < SC; s0 += 32 / lp) {
        const int s = s0 + lane / lp;
        float dot[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
        if (s < nv) {
          const KT* kr = kc + s * D;
          int kk = rs;
          for (int k = 0; k < cpl; ++k, kk = kk + 1 < cpl ? kk + 1 : 0) {
            const int ch = part + lp * kk;
            float kv[VN];
            Vec<KT>::load(kr + ch * VN, kv);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (g0 + r >= nr) break;
              const float* qr = qs + (g0 + r) * D + ch * VN;
#pragma unroll
              for (int e = 0; e < VN; e += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
                dot[r] = fmaf(q4.x, kv[e], dot[r]);
                dot[r] = fmaf(q4.y, kv[e + 1], dot[r]);
                dot[r] = fmaf(q4.z, kv[e + 2], dot[r]);
                dot[r] = fmaf(q4.w, kv[e + 3], dot[r]);
              }
            }
          }
        }
        for (int off = lp / 2; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < kRows; ++r) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
        if (part == 0 && s < SC)
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int g = g0 + r;
            if (g >= nr) break;
            float x = kNegInf;
            if (s < nv) {
              x = quant ? dot[r] * ksc[s] : dot[r];
              if (a.slopes != nullptr)
                x -= a.slopes[kvh * G + r0 + g] * (float)(pos - (slot0 + s));
            }
            sc[g * SC + s] = x;
          }
      }
    }
    __syncwarp();

    // the online softmax: rl lanes a row, 32 / rl rows a round, one
    // rescale per chunk and row
    for (int g0 = 0; g0 < nr; g0 += rows_per_round) {
      const int g = g0 + lane / rl, sl = lane % rl;
      const bool row_ok = g < nr;
      float mt = kNegInf;
      if (row_ok)
        for (int s = sl; s < nv; s += rl) mt = fmaxf(mt, sc[g * SC + s]);
      for (int off = rl / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_prev = row_ok ? ms[g] : 0.f;
      const float m_new = fmaxf(m_prev, mt);
      float psum = 0.f;
      if (row_ok)
        for (int s = sl; s < nv; s += rl) {
          const float p = expf(sc[g * SC + s] - m_new);
          psum += p;
          // the V scale rides on the probability (l keeps the unscaled sum)
          sc[g * SC + s] = quant ? p * ksc[SC + s] : p;
        }
      for (int off = rl / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (row_ok && sl == 0) {
        const float alpha = expf(m_prev - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + psum;
        ms[g] = m_new;
      }
    }
    __syncwarp();

    // acc += p v: each lane 8 output columns of kRows rows at a time, over
    // one of SG slot groups; each V vector is read and widened once for the
    // rows
    if (lane < SG * C8) {
      const int c = (lane % C8) * 8, sg = lane / C8;
      for (int g0 = 0; g0 < nr; g0 += kRows) {
        float o[kRows][8];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) o[r][e] = 0.f;
#pragma unroll 2
        for (int s = sg; s < nv; s += SG) {
          float v[8];
          load8(vc + s * D + c, v);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (g0 + r >= nr) break;
            const float p = sc[(g0 + r) * SC + s];
#pragma unroll
            for (int e = 0; e < 8; ++e) o[r][e] = fmaf(p, v[e], o[r][e]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int g = g0 + r;
          if (g >= nr) break;
          float* ap = acc + ((size_t)sg * R + g) * D + c;
          const float alpha = al[g];
          const float4 a0 = reinterpret_cast<const float4*>(ap)[0];
          const float4 a1 = reinterpret_cast<const float4*>(ap)[1];
          reinterpret_cast<float4*>(ap)[0] =
              make_float4(fmaf(a0.x, alpha, o[r][0]), fmaf(a0.y, alpha, o[r][1]),
                          fmaf(a0.z, alpha, o[r][2]), fmaf(a0.w, alpha, o[r][3]));
          reinterpret_cast<float4*>(ap)[1] =
              make_float4(fmaf(a1.x, alpha, o[r][4]), fmaf(a1.y, alpha, o[r][5]),
                          fmaf(a1.z, alpha, o[r][6]), fmaf(a1.w, alpha, o[r][7]));
        }
      }
    }
    __syncwarp();  // the stage, sc and al are free
    if (i + NST < n_w) issue(i + NST);
    __syncwarp();
  }
  __syncthreads();

  // this block's (m, l, acc): the warps' merged in warp order, each warp's
  // slot groups added in order
  for (int i = tid; i < nr * D; i += nt) {
    const int g = i / D;
    const float* wm = reinterpret_cast<const float*>(base + L.stats);
    float m = kNegInf;
    for (int w = 0; w < W; ++w) m = fmaxf(m, wm[w * 3 * R + g]);
    float l = 0.f, o = 0.f;
    for (int w = 0; w < W; ++w) {
      const float f = expf(wm[w * 3 * R + g] - m);
      const float* wa = reinterpret_cast<const float*>(base + L.acc) + (size_t)w * SG * R * D;
      float v = wa[i];
      for (int sg = 1; sg < SG; ++sg) v += wa[(size_t)sg * R * D + i];
      l += wm[w * 3 * R + R + g] * f;
      o += v * f;
    }
    bacc[i] = o;
    if (i % D == 0) {
      bm[g] = m;
      bl[g] = l;
    }
  }
  cluster.sync();  // every split's (m, l, acc) is in its shared memory
  if (split == 0) {
    T* ob = static_cast<T*>(a.out) + row0 * a.Dt;
    for (int i = tid; i < nr * D; i += nt) {
      const int g = i / D, d = i % D;
      if (d >= a.Dt) continue;
      // every split's (m, l, acc) loaded before any is used: the remote
      // loads overlap
      float mr[kMaxSplit], lr[kMaxSplit], ar[kMaxSplit];
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < n_split) {
          mr[r] = cluster.map_shared_rank(bm, r)[g];
          lr[r] = cluster.map_shared_rank(bl, r)[g];
          ar[r] = cluster.map_shared_rank(bacc, r)[i];
        }
      float m = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < n_split) m = fmaxf(m, mr[r]);
      float l = 0.f, o = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < n_split) {
          const float f = expf(mr[r] - m);
          l += lr[r] * f;
          o += ar[r] * f;
        }
      ob[g * a.Dt + d] = from_f<T>(o / fmaxf(l, 1e-30f));
    }
  }
  cluster.sync();  // the other splits stay resident until rank 0 has read them
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
  void* out;
  int B, NH, KVH, Dt, ps, MP;
  float scale;
  // up to D = 256: pool pages, splits (the cluster), query rows a block,
  // slots a chunk, TMA copies
  int P, n_split, rows, chunk, tma;
  // past 256: fp32 scratch of the runs, pages a run
  void* part;
  int pages_per_split;
};

// the block's warps W and each warp's ring of NST stages: all 8 warps with
// the most stages (up to kMaxStages) that keep the block within
// kRingBudget, so that two blocks (16 warps) share an SM, else within
// kSmemBudget; failing both, half the warps, and so on.  One warp of one
// stage fits every wrapper plan (at most 8 rows, chunks of at most 16
// slots); false where even that does not.
bool choose_plan(int R, int D, int SC, int kt, bool quant, int MP, int* W, int* nst) {
  for (int w = kMaxWarps; w >= 1; w /= 2)
    for (const size_t budget : {kRingBudget, kSmemBudget})
      for (int n = kMaxStages; n >= 1; --n)
        if (128 + Layout(w, R, D, SC, kt, quant, MP, n).total <= budget) {
          *W = w;
          *nst = n;
          return true;
        }
  return false;
}

template <typename KT> CUtensorMapDataType tma_type() {
  if (std::is_same<KT, __nv_bfloat16>::value) return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (std::is_same<KT, __half>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (std::is_same<KT, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return CU_TENSOR_MAP_DATA_TYPE_UINT8;  // int8 codes, copied as bytes
}

// a pool [P, ps, KVH, D] as a 3-D map (D, KVH, P * ps), box (D, 1, SC): one
// copy lands one chunk of one kv head as a dense [SC][D] tile
template <typename KT>
cudaError_t pool_map(CUtensorMap* m, const void* pool, int D, int KVH, long long rows, int SC) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = sizeof(KT);
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * e, (cuuint64_t)KVH * D * e};
  const cuuint32_t box[3] = {(cuuint32_t)D, 1, (cuuint32_t)SC};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(m, tma_type<KT>(), 3, const_cast<void*>(pool), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, typename KT, int D>
cudaError_t allow_max_smem() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(paged_decode_kernel<T, KT, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBudget);
  return attr;
}

template <typename T, typename KT, int D>
cudaError_t launch_cluster(const Args& a, int W, const CUtensorMap& tk, const CUtensorMap& tv,
                           const DecodeArgs& d, size_t smem, cudaStream_t stream) {
  const cudaError_t attr = allow_max_smem<T, KT, D>();
  if (attr != cudaSuccess) return attr;
  const int G = a.NH / a.KVH;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.n_split, (unsigned)(a.B * a.KVH),
                     (unsigned)((G + a.rows - 1) / a.rows));
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)a.n_split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  CUtensorMap k = tk, v = tv;
  DecodeArgs args = d;
  void* params[] = {&k, &v, &args};
  const cudaError_t e = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(paged_decode_kernel<T, KT, D>), params);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the streaming kernel at head dim D (up to 256)
template <typename T, typename KT, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool quant = a.k_scale != nullptr;
  int W = 0, nst = 0;
  if (!choose_plan(a.rows, D, a.chunk, sizeof(KT), quant, a.MP, &W, &nst))
    return cudaErrorInvalidValue;
  const size_t smem = 128 + Layout(W, a.rows, D, a.chunk, sizeof(KT), quant, a.MP, nst).total;
  const DecodeArgs d{a.q,
                     a.k_pool,
                     a.v_pool,
                     static_cast<const float*>(a.k_scale),
                     static_cast<const float*>(a.v_scale),
                     static_cast<const float*>(a.slopes),
                     static_cast<const int*>(a.page_table),
                     static_cast<const int*>(a.positions),
                     a.out,
                     a.NH,
                     a.KVH,
                     a.Dt,
                     a.ps,
                     a.MP,
                     nst,
                     a.rows,
                     a.chunk,
                     a.tma,
                     a.scale};
  CUtensorMap tk{}, tv{};
  if (!a.tma) return launch_cluster<T, KT, D>(a, W, tk, tv, d, smem, stream);
  // TMA takes rows at the kernel's full width (every stride a whole number
  // of 16-byte vectors)
  if (a.Dt != D) return cudaErrorInvalidValue;
  cudaError_t e;
  const long long rows = (long long)a.P * a.ps;
  if ((e = pool_map<KT>(&tk, a.k_pool, D, a.KVH, rows, a.chunk)) != cudaSuccess ||
      (e = pool_map<KT>(&tv, a.v_pool, D, a.KVH, rows, a.chunk)) != cudaSuccess)
    return e;
  return launch_cluster<T, KT, D>(a, W, tk, tv, d, smem, stream);
}

// the runtime-head-dim kernel (past 256), then the merge of its runs
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

// blocks of the streaming kernel one SM holds at once at its plan (its
// shared memory, warps and registers); 0 where no plan fits
template <typename T, typename KT, int D>
int resident(const Args& a) {
  int W = 0, nst = 0, n = 0;
  const bool quant = a.k_scale != nullptr;
  if (!choose_plan(a.rows, D, a.chunk, sizeof(KT), quant, a.MP, &W, &nst) ||
      allow_max_smem<T, KT, D>() != cudaSuccess)
    return 0;
  const size_t smem = 128 + Layout(W, a.rows, D, a.chunk, sizeof(KT), quant, a.MP, nst).total;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, paged_decode_kernel<T, KT, D>,
                                                       32 * W, smem) == cudaSuccess
             ? n
             : 0;
}

template <typename T, typename KT, int D> struct LaunchOp {
  static int none() { return (int)cudaErrorInvalidValue; }
  static int run(const Args& a, cudaStream_t stream) { return (int)launch<T, KT, D>(a, stream); }
};

template <typename T, typename KT, int D> struct ResidentOp {
  static int none() { return 0; }
  static int run(const Args& a, cudaStream_t) { return resident<T, KT, D>(a); }
};

// Op<T, KT, d>::run at the kernel's head dim d for a.Dt (up to 256: Dt
// rounded up to 16, to 32 past 128)
template <typename T, typename KT, template <typename, typename, int> class Op>
struct ByHeadDim {
  static int run(const Args& a, cudaStream_t stream) {
    switch (a.Dt <= 128 ? (a.Dt + 15) / 16 * 16 : (a.Dt + 31) / 32 * 32) {
#define DSTPU_PAGED_CASE(d) \
  case d:                   \
    return Op<T, KT, d>::run(a, stream);
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
        return Op<T, KT, 16>::none();
    }
  }
};

template <typename T, typename KT> using Streaming = ByHeadDim<T, KT, LaunchOp>;
template <typename T, typename KT> using Residency = ByHeadDim<T, KT, ResidentOp>;

template <typename T, typename KT> struct Wide {
  static int run(const Args& a, cudaStream_t stream) { return (int)launch_wide<T, KT>(a, stream); }
};

// Path<T, KT>::run for the dtype (q's; the pools' unless quant); `none`
// for an unknown dtype
template <template <typename, typename> class Path>
int by_type(int dtype, int quant, const Args& a, cudaStream_t st, int none) {
  switch (dtype) {
    case 0:
      return quant ? Path<float, int8_t>::run(a, st) : Path<float, float>::run(a, st);
    case 1:
      return quant ? Path<__nv_bfloat16, int8_t>::run(a, st)
                   : Path<__nv_bfloat16, __nv_bfloat16>::run(a, st);
    case 2:
      return quant ? Path<__half, int8_t>::run(a, st) : Path<__half, __half>::run(a, st);
    default:
      return none;
  }
}

// the checks both launching entry points share, then Path for the dtype
template <template <typename, typename> class Path>
int dispatch(int dtype, int quant, const Args& a, void* stream) {
  if (a.KVH <= 0 || a.NH % a.KVH != 0 || a.ps <= 0 || a.MP <= 0)
    return (int)cudaErrorInvalidValue;
  if (quant && (a.k_scale == nullptr || a.v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.k_pool) | reinterpret_cast<uintptr_t>(a.v_pool)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (a.B == 0) return (int)cudaSuccess;
  Args b = a;
  if (!quant) b.k_scale = b.v_scale = nullptr;
  return by_type<Path>(dtype, quant, b, static_cast<cudaStream_t>(stream),
                       (int)cudaErrorInvalidValue);
}

}  // namespace

// dtype (of q and out; of the pools unless quant): 0 = fp32, 1 = bf16, 2 = fp16.
// q [B, NH, D]; pools [P, ps, KVH, D] (int8 when quant, with fp32 scales
// [P, ps, KVH]), 16-byte aligned; page_table [B, MP] int32; positions [B]
// int32; slopes [NH] fp32 or null; out [B, NH, D].  All contiguous.
// Each returns cudaGetLastError() after its launches (0 = launched).
//
// D from 1 to 256: the streaming kernel at D rounded up to 16 (to 32 past
// 128).  Each (sequence, kv head) is split over n_split blocks (1..8, a
// cluster) and its NH / KVH query rows over row groups of `rows` (1..8);
// a stage holds `chunk` slots (1..16, dividing ps); the chunks are copied
// by TMA when tma (then D must be a multiple of 16, 32 past 128).
extern "C" int dstpu_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* k_scale,
                                            const void* v_scale, const void* page_table,
                                            const void* positions, const void* slopes,
                                            void* out, int dtype, int quant, int B, int NH,
                                            int KVH, int D, int ps, int MP, int P, int n_split,
                                            int rows, int chunk, int tma, float scale,
                                            void* stream) {
  if (D < 1 || D > 256 || P <= 0 || n_split < 1 || n_split > kMaxSplit || rows < 1 ||
      rows > kMaxRows || chunk < 1 || chunk > kMaxChunk || ps % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k_pool, v_pool, k_scale, v_scale, page_table, positions, slopes,
               out, B,      NH,     KVH,     D,       ps,         MP,        scale,
               P,  n_split, rows,   chunk,   tma,     nullptr,    0};
  return dispatch<Streaming>(dtype, quant, a, stream);
}

// The blocks of the streaming kernel (D from 1 to 256) one SM of the current
// device holds at once for this dtype, pool type, page size, table width,
// rows a block and chunk: what the caller's split count must not exceed
// over the SMs.  0 where no plan fits.
extern "C" int dstpu_paged_decode_resident(int dtype, int quant, int D, int ps, int MP,
                                           int rows, int chunk) {
  if (D < 1 || D > 256 || ps <= 0 || MP <= 0 || rows < 1 || rows > kMaxRows || chunk < 1 ||
      chunk > kMaxChunk || ps % chunk != 0)
    return 0;
  Args a{};
  a.Dt = D;
  a.ps = ps;
  a.MP = MP;
  a.rows = rows;
  a.chunk = chunk;
  static const float one = 1.f;  // only tested for null: int8 pools carry scales
  a.k_scale = a.v_scale = quant ? &one : nullptr;
  return by_type<Residency>(dtype, quant, a, nullptr, 0);
}

// D past 256: the runtime-head-dim kernel takes runs of pages_per_split
// pages; when MP > pages_per_split, part is fp32 scratch of B * KVH *
// ceil(MP / pages_per_split) * (NH / KVH) * (D + 2) floats that its second
// kernel merges.
extern "C" int dstpu_paged_decode_attention_wide(const void* q, const void* k_pool,
                                                 const void* v_pool, const void* k_scale,
                                                 const void* v_scale, const void* page_table,
                                                 const void* positions, const void* slopes,
                                                 void* out, void* part, int dtype, int quant,
                                                 int B, int NH, int KVH, int D, int ps, int MP,
                                                 int pages_per_split, float scale,
                                                 void* stream) {
  if (D <= 256 || pages_per_split <= 0 || (MP > pages_per_split && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, page_table, positions, slopes, out, B, NH,
               KVH, D, ps, MP, scale, 0, 0, 0, 0, 0, part, pages_per_split};
  return dispatch<Wide>(dtype, quant, a, stream);
}
