// Device pieces shared by the serial (kernel 2) and pipelined (kernel 3)
// generator kernels in beamgen.cu: the block geometry, the per-row online
// logsumexp + running top-kc update (rows_select), and the two ways to get
// a tile's scores -- the exact f32 FMA loop of the float32 kernels
// (tile_fma) and the bf16 tensor-core tiles of the bf16 kernels (namespace
// tc).  Kernels of one dtype run the same product and the same selection,
// in the same order over k and over the vocab tiles, so every mode of one
// dtype gives the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lstm_mma.cuh"

namespace beamgen {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowBlock = kWarps * kRowsPerWarp;  // 64 rows per block
constexpr int kColsPerLane = 4;
constexpr int kTile = 32 * kColsPerLane;  // 128 vocab columns per tile
constexpr int kMaxK = 32;
constexpr int kNoIndex = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// a ranks before b: larger value, or equal value and lower index
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// x rows [row0, row0 + kRowBlock) of x [n_rows, e] into shared memory as
// f32, k-major: xs[k * kRowBlock + r] (rows past n_rows read 0).
template <typename TX>
__device__ __forceinline__ void stage_x(const TX* __restrict__ x, float* xs,
                                        int n_rows, int e, int row0) {
  for (int i = threadIdx.x; i < kRowBlock * e; i += blockDim.x) {
    const int r = i / e;
    const int k = i - r * e;
    const int row = row0 + r;
    xs[k * kRowBlock + r] =
        row < n_rows ? to_f32(x[(size_t)row * e + k]) : 0.0f;
  }
}

template <typename TW, bool kGlobal>
__device__ __forceinline__ float load_w(const TW* p) {
  if constexpr (kGlobal) {
    return to_f32(__ldg(p));
  } else {
    return to_f32(*p);
  }
}

// acc[r][c] += sum over k in [k0, k1) of x[row r][k] * table[k][col c] for
// the warp's 8 rows (a_base: xs at the warp's first row) and the lane's 4
// columns (w: table row k0 at the lane's first column, consecutive k rows
// `stride` elements apart, the lane's columns 32 apart).  One fmaf per
// product, k ascending: the same sequence in both float32 kernels.
template <typename TW, bool kGlobal>
__device__ __forceinline__ void tile_fma(float (&acc)[kRowsPerWarp][kColsPerLane],
                                         const float* a_base,
                                         const TW* w, size_t stride, int k0,
                                         int k1,
                                         const bool (&ok)[kColsPerLane]) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4* a4 = reinterpret_cast<const float4*>(a_base + k * kRowBlock);
    const float4 lo = a4[0];
    const float4 hi = a4[1];
    const float a[kRowsPerWarp] = {lo.x, lo.y, lo.z, lo.w,
                                   hi.x, hi.y, hi.z, hi.w};
    const TW* wr = w + (size_t)(k - k0) * stride;
    float wv[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      wv[c] = ok[c] ? load_w<TW, kGlobal>(wr + 32 * c) : 0.0f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        acc[r][c] = fmaf(a[r], wv[c], acc[r][c]);
    }
  }
}

constexpr int kGroup = 4;  // rows of a warp folded at once

// v[c] for a column c known only at run time, from registers (no local
// memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kColsPerLane], int c) {
  T out = v[0];
#pragma unroll
  for (int j = 1; j < kColsPerLane; ++j) out = c == j ? v[j] : out;
  return out;
}

// Whether any lane's column beats the row's running kc-th entry.
__device__ __forceinline__ bool gains(const float (&v)[kColsPerLane],
                                      const int (&vi)[kColsPerLane],
                                      const bool (&ok)[kColsPerLane],
                                      float kth_v, int kth_i) {
  bool gain = false;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c)
    gain |= ok[c] && beats(v[c], vi[c], kth_v, kth_i);
  return gain;
}

// prune: insert into the row's running top-kc (lane l < kc holds slot l,
// sorted by `beats`) each of the tile's candidates that beats the running
// kc-th entry, first lane first; every insertion raises the kc-th entry, and
// a candidate that no longer beats it is left out.  Only candidates that
// could enter are touched, one ballot and one shuffle-shift each; the
// buffer ends as the exact top-kc of [buffer | tile], whatever the order.
// The caller has found that some candidate beats the kc-th entry.
__device__ __forceinline__ void insert_gains(const float (&v)[kColsPerLane],
                                             const int (&vi)[kColsPerLane],
                                             const bool (&ok)[kColsPerLane],
                                             float& buf_v, int& buf_i, int kc,
                                             int lane) {
  unsigned done = 0;  // bit c: column c inserted
  for (;;) {
    const float kth_v = __shfl_sync(kFull, buf_v, kc - 1);
    const int kth_i = __shfl_sync(kFull, buf_i, kc - 1);
    int first = -1;
#pragma unroll
    for (int c = kColsPerLane - 1; c >= 0; --c)
      if (ok[c] && !(done >> c & 1u) && beats(v[c], vi[c], kth_v, kth_i))
        first = c;
    const unsigned lanes = __ballot_sync(kFull, first >= 0);
    if (lanes == 0) return;
    const int src = __ffs(lanes) - 1;
    float cv = 0.0f;
    int ci = kNoIndex;
    if (lane == src) {
      cv = pick(v, first);
      ci = pick(vi, first);
      done |= 1u << first;
    }
    cv = __shfl_sync(kFull, cv, src);
    ci = __shfl_sync(kFull, ci, src);
    const int pos = __popc(__ballot_sync(
        kFull, lane < kc && beats(buf_v, buf_i, cv, ci)));  // < kc
    const float up_v = __shfl_up_sync(kFull, buf_v, 1);
    const int up_i = __shfl_up_sync(kFull, buf_i, 1);
    if (lane == pos) {
      buf_v = cv;
      buf_i = ci;
    } else if (lane > pos && lane < kc) {
      buf_v = up_v;
      buf_i = up_i;
    }
  }
}

// Rows g0 .. g0 + kGroup - 1: kc exact argmax passes over [tile | buffer]
// (v[g]: row g0 + g's scores), the rows in lockstep.
__device__ __forceinline__ void passes_select(
    const float (&v)[kGroup][kColsPerLane], const int (&vi)[kColsPerLane],
    const bool (&ok)[kColsPerLane], float (&buf_v)[kRowsPerWarp],
    int (&buf_i)[kRowsPerWarp], int g0, int kc, int lane) {
  unsigned taken[kGroup];  // bit c: tile column c, bit kColsPerLane: buffer
  float new_v[kGroup];
  int new_i[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    taken[g] = 0;
    new_v[g] = -INFINITY;
    new_i[g] = kNoIndex;
  }
  for (int p = 0; p < kc; ++p) {
    float lv[kGroup], gv[kGroup];
    int li[kGroup], gi[kGroup], slot[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      lv[g] = -INFINITY;
      li[g] = kNoIndex;
      slot[g] = -1;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        if (ok[c] && !(taken[g] >> c & 1u) &&
            (slot[g] < 0 || beats(v[g][c], vi[c], lv[g], li[g]))) {
          lv[g] = v[g][c];
          li[g] = vi[c];
          slot[g] = c;
        }
      }
      if (lane < kc && !(taken[g] >> kColsPerLane & 1u) &&
          (slot[g] < 0 || beats(buf_v[g0 + g], buf_i[g0 + g], lv[g], li[g]))) {
        lv[g] = buf_v[g0 + g];
        li[g] = buf_i[g0 + g];
        slot[g] = kColsPerLane;
      }
      gv[g] = lv[g];
      gi[g] = li[g];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float ov = __shfl_xor_sync(kFull, gv[g], off);
        const int oi = __shfl_xor_sync(kFull, gi[g], off);
        if (beats(ov, oi, gv[g], gi[g])) {
          gv[g] = ov;
          gi[g] = oi;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const unsigned owners = __ballot_sync(
          kFull, slot[g] >= 0 && lv[g] == gv[g] && li[g] == gi[g]);
      if (owners != 0 && lane == __ffs(owners) - 1)
        taken[g] |= 1u << slot[g];
      if (lane == p) {
        new_v[g] = gv[g];
        new_i[g] = gi[g];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    if (lane < kc) {
      buf_v[g0 + g] = new_v[g];
      buf_i[g0 + g] = new_i[g];
    }
  }
}

// The warp's rows' scores of one tile folded into each row's online
// logsumexp (m_run, s_run) and running top-kc (lane l < kc holds buffer
// slot l): load(r, c) is row r's logit at the lane's column c (vocab id
// vi[c], ok[c] whether it exists).  kGroup rows go through the logsumexp
// (and the passes) at once, so their shuffle chains overlap; every row's
// arithmetic is the one-row sequence (a butterfly max and sum, expf in
// column order).  The top-kc is exact in both forms, so they give the same
// bits: kPrune inserts only the candidates that beat the row's running
// kc-th entry (insert_gains; a tile with none costs one vote), otherwise
// kc exact argmax passes run over [tile | buffer] on every tile, as the
// TPU's unpruned kernel.
template <bool kPrune, typename Load>
__device__ __forceinline__ void rows_select(
    Load load, const int (&vi)[kColsPerLane], const bool (&ok)[kColsPerLane],
    float (&m_run)[kRowsPerWarp], float (&s_run)[kRowsPerWarp],
    float (&buf_v)[kRowsPerWarp], int (&buf_i)[kRowsPerWarp], int kc,
    int lane) {
#pragma unroll
  for (int g0 = 0; g0 < kRowsPerWarp; g0 += kGroup) {
    float v[kGroup][kColsPerLane], m_new[kGroup], se[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      m_new[g] = -INFINITY;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        v[g][c] = ok[c] ? load(g0 + g, c) : -INFINITY;
        m_new[g] = fmaxf(m_new[g], v[g][c]);
      }
    }
    // online logsumexp; every tile holds at least one real column
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        m_new[g] = fmaxf(m_new[g], __shfl_xor_sync(kFull, m_new[g], off));
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      m_new[g] = fmaxf(m_run[g0 + g], m_new[g]);
      se[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        if (ok[c]) se[g] += expf(v[g][c] - m_new[g]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        se[g] += __shfl_xor_sync(kFull, se[g], off);
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      s_run[g0 + g] = s_run[g0 + g] * expf(m_run[g0 + g] - m_new[g]) + se[g];
      m_run[g0 + g] = m_new[g];
    }
    if constexpr (kPrune) {
      // the rows' votes in lockstep; insertions only where a row gains
      bool gain[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        gain[g] = gains(v[g], vi, ok, __shfl_sync(kFull, buf_v[g0 + g], kc - 1),
                        __shfl_sync(kFull, buf_i[g0 + g], kc - 1));
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (__any_sync(kFull, gain[g]))
          insert_gains(v[g], vi, ok, buf_v[g0 + g], buf_i[g0 + g], kc, lane);
    } else {
      passes_select(v, vi, ok, buf_v, buf_i, g0, kc, lane);
    }
  }
}

// The warp's rows' partial results for its vocab split.
__device__ __forceinline__ void store_partials(
    const float (&m_run)[kRowsPerWarp], const float (&s_run)[kRowsPerWarp],
    const float (&buf_v)[kRowsPerWarp], const int (&buf_i)[kRowsPerWarp],
    int row0, int warp, int lane, int split, int n_rows, int kc,
    float* __restrict__ part_v, int* __restrict__ part_i,
    float* __restrict__ part_m, float* __restrict__ part_s) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    const size_t at = (size_t)split * n_rows + row;
    if (lane < kc) {
      part_v[at * kc + lane] = buf_v[r];
      part_i[at * kc + lane] = buf_i[r];
    }
    if (lane == 0) {
      part_m[at] = m_run[r];
      part_s[at] = s_run[r];
    }
  }
}

// -- bf16 tensor-core tiles (kernels 2 and 3 on bf16 x) ----------------------
//
// A block owns kRowBlock rows and a run of vocab tiles.  Its x rows are
// staged once in bf16, row-major, each row padded by 16 bytes so the eight
// row addresses of an `ldmatrix` fall in eight bank groups, and zero past e
// up to ep(e), the next multiple of 16 (the last k-slab's zero fill).  The
// table's [e, kTile] column tiles stream through a ring of kStages slabs of
// kKs k-rows, copied by 16-byte `cp.async` (rows past e and pieces past V
// zero-filled), so the copy of the next slabs -- across tile boundaries --
// runs under the `mma` of this one.  Eight product warps (2 x 4) each own
// 32 rows x 32 columns of the 64 x 128 score tile: per k16 step two A
// fragments (`ldmatrix.x4`), two B fragment pairs (`ldmatrix.x4.trans`),
// eight `mma.sync.m16n8k16` (bf16 in, f32 accumulate), k ascending.  The
// f32 tile goes to a shared [kRowBlock][kScoreStride] buffer, from which
// the selection warps read their rows in rows_select's layout (lane l:
// columns l, l + 32, l + 64, l + 96).  An int8 table is staged as int8
// (half the bytes) and widened to bf16 in shared memory before its B
// fragments: every int8 value is exact in bf16.
namespace tc {

using cair_lstm::tiles::bf16;
using cair_lstm::tiles::cp_async16;
using cair_lstm::tiles::cp_async_commit;
using cair_lstm::tiles::cp_async_wait;
using cair_lstm::tiles::ldsm_x4;
using cair_lstm::tiles::ldsm_x4_trans;
using cair_lstm::tiles::mbar_init;
using cair_lstm::tiles::mbar_wait;
using cair_lstm::tiles::mma_bf16;
using cair_lstm::tiles::smem_addr;

constexpr int kThreads = kWarps * 32;  // the product warps of a block
constexpr int kKs = 32;                // table k-rows per slab
constexpr int kStages = 4;             // slabs in the ring
constexpr int kSmemLimit = 232448;     // dynamic shared memory of a block
constexpr int kScoreStride = kTile + 8;        // floats per staged score row
constexpr int kWideStride = kTile * 2 + 16;    // bytes per bf16 slab row
constexpr int kNarrowStride = kTile + 16;      // bytes per int8 slab row
constexpr int kRingBytes = kStages * kKs * kWideStride;  // either kind
constexpr int kScoreBytes = kRowBlock * kScoreStride * 4;
constexpr int kHeader = 64;  // the pipelined kernel's mbarriers

__host__ __device__ inline int ep(int e) { return (e + 15) / 16 * 16; }
__host__ __device__ inline int x_stride(int e) { return ep(e) * 2 + 16; }

// Dynamic shared memory of a block: (the pipelined kernel's header,) the
// x tile, one score buffer (two when pipelined) and the slab ring (an int8
// ring plus one widened slab fits in a bf16 ring's bytes).
// `beamgen_smem_bytes` in ops/kernels/beamgen.py states the same sum.
__host__ __device__ inline size_t smem_bytes(int e, bool pipelined) {
  return (pipelined ? kHeader : 0) + (size_t)kRowBlock * x_stride(e) +
         (pipelined ? 2 : 1) * (size_t)kScoreBytes + kRingBytes;
}

// x rows [row0, row0 + kRowBlock) of x [n_rows, e] (bf16) into the staged
// tile (rows x_stride(e) bytes apart); rows past n_rows and columns
// [e, ep(e)) are zero.  Plain 2-byte loads: x rows need not be 16-byte
// aligned, and the tile is read once per block.
__device__ __forceinline__ void stage_x_bf16(
    const bf16* __restrict__ x, char* xs, int n_rows, int e, int row0,
    int tid, int n_threads) {
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
  const int half = ep(e) / 2;
  const int xst = x_stride(e);
  for (int i = tid; i < kRowBlock * half; i += n_threads) {
    const int r = i / half;
    const int k = 2 * (i - r * half);
    const int row = row0 + r;
    uint32_t pair = 0;
    if (row < n_rows) {
      const unsigned short* src = xb + (size_t)row * e + k;
      const uint32_t lo = k < e ? __ldg(src) : 0u;
      const uint32_t hi = k + 1 < e ? __ldg(src + 1) : 0u;
      pair = lo | (hi << 16);
    }
    *reinterpret_cast<uint32_t*>(xs + r * xst + k * 2) = pair;
  }
}

// Producer-side barrier: the whole block (__syncthreads) when every warp
// runs the product, named barrier 1 over the kThreads product threads when
// other warps select at the same time (kernel 3).
template <bool kAll>
__device__ __forceinline__ void producer_sync() {
  if constexpr (kAll) {
    __syncthreads();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  }
}

// One arrival for the calling warp, after every lane's prior shared-memory
// accesses (__syncwarp orders them): barriers count warps, not threads, so
// a hand-over is eight arrivals, not 256 atomics on one word.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
}

// The table stream of one block: slab n is k-rows [s * kKs, (s + 1) * kKs)
// (s = n % n_slabs) of vocab tile tile_begin + n / n_slabs, in ring slot
// n % kStages, staged row-major (TW: bf16 rows kWideStride bytes apart,
// int8 rows kNarrowStride).  Table rows are `ld` elements apart (ld * size
// of TW a multiple of 16, the table 16-byte aligned), so every 16-byte
// piece is one cp.async; a piece that starts past v_size is zero-filled,
// one that crosses it reads the row's padding (masked by the selection).
// Only the kThreads product threads call these; each thread's cp.async
// group g holds its copies of slab g.
template <typename TW, bool kAll>
struct SlabRing {
  static constexpr int kRow = sizeof(TW) == 1 ? kNarrowStride : kWideStride;
  static constexpr int kSlot = kKs * kRow;
  static constexpr int kPer = 16 / (int)sizeof(TW);  // elements per piece
  static constexpr int kPieces = kTile / kPer;       // pieces per row

  char* base;
  const TW* table;
  int e, v_size, ld, n_slabs, tile_begin, total;

  __device__ __forceinline__ void issue(int n, int tid) {
    if (n >= total) return;
    const int tile = tile_begin + n / n_slabs;
    const int k0 = (n % n_slabs) * kKs;
    char* dst = base + (n % kStages) * kSlot;
    for (int i = tid; i < kKs * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int p = i - r * kPieces;
      const int k = k0 + r;
      const int col = tile * kTile + p * kPer;
      const bool in = k < e && col < v_size;
      const TW* src = in ? table + (size_t)k * ld + col : table;
      cp_async16(dst + r * kRow + p * 16, src, in);
    }
  }
  // slabs 0 .. kStages - 2, one commit group each
  __device__ __forceinline__ void prologue(int tid) {
    for (int p = 0; p < kStages - 1; ++p) {
      issue(p, tid);
      cp_async_commit();
    }
  }
  // Wait for slab n (this thread's copies, then everyone's: the barrier
  // also frees the slot of slab n - 1, which every product warp has read),
  // issue slab n + kStages - 1 into it and return slab n's slot.
  __device__ __forceinline__ const char* acquire(int n, int tid) {
    cp_async_wait<kStages - 2>();
    producer_sync<kAll>();
    issue(n + kStages - 1, tid);
    cp_async_commit();
    return base + (n % kStages) * kSlot;
  }
};

// An int8 slab widened to bf16 (exact) into `wide` (rows kWideStride bytes
// apart), then a barrier: the caller's slab_mma reads it.  `wide` is free:
// the acquire that returned `narrow` came after every warp's last read.
template <bool kAll>
__device__ __forceinline__ void widen_slab(const char* narrow, char* wide,
                                           int tid) {
  constexpr int kPieces = kTile / 16;
  for (int i = tid; i < kKs * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int p = i - r * kPieces;
    const int4 q = *reinterpret_cast<const int4*>(narrow + r * kNarrowStride +
                                                  p * 16);
    const int8_t* qb = reinterpret_cast<const int8_t*>(&q);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(
          static_cast<float>(qb[2 * j]), static_cast<float>(qb[2 * j + 1]));
      w[j] = *reinterpret_cast<const uint32_t*>(&pr);
    }
    int4* dst = reinterpret_cast<int4*>(wide + r * kWideStride + p * 32);
    dst[0] = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    dst[1] = make_int4((int)w[4], (int)w[5], (int)w[6], (int)w[7]);
  }
  producer_sync<kAll>();
}

// acc[mt][nt] += x[rows wm*32 + mt*16 ..][k0 .. k0 + kcount) @ slab[0 ..
// kcount)[cols wn*32 + nt*8 ..]: product warp (wm, wn)'s 32 x 32 share of
// one bf16 slab (kcount a multiple of 16), k16 steps ascending.
__device__ __forceinline__ void slab_mma(float (&acc)[2][4][4],
                                         const char* xs, int xst, int k0,
                                         const char* slab, int kcount,
                                         int wm, int wn, int lane) {
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_k = lane & 15, b_n = (lane >> 4) * 8;
  for (int kk = 0; kk < kcount; kk += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(a[mt], xs + (wm * 32 + mt * 16 + a_row) * xst +
                         (k0 + kk + a_k) * 2);
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldsm_x4_trans(b[np], slab + (kk + b_k) * kWideStride +
                               (wn * 32 + np * 16 + b_n) * 2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
      }
    }
  }
}

// All slabs of one vocab tile: acc = x_tile @ table[:, tile] (ring slabs
// n .. n + n_slabs - 1; n advances).
template <typename TW, bool kAll>
__device__ __forceinline__ void tile_mma(float (&acc)[2][4][4],
                                         SlabRing<TW, kAll>& ring,
                                         int& n, const char* xs,
                                         char* wide, int e, int wm, int wn,
                                         int tid, int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
  const int xst = x_stride(e), e16 = ep(e);
  for (int s = 0; s < ring.n_slabs; ++s, ++n) {
    const char* slab = ring.acquire(n, tid);
    if constexpr (sizeof(TW) == 1) {
      widen_slab<kAll>(slab, wide, tid);
      slab = wide;
    }
    const int k0 = s * kKs;
    slab_mma(acc, xs, xst, k0, slab, min(kKs, e16 - k0), wm, wn, lane);
  }
}

// The product warp's accumulators into the score buffer (row-major,
// kScoreStride floats a row; conflict-free float2 stores).
__device__ __forceinline__ void store_scores(const float (&acc)[2][4][4],
                                             float* scores, int wm, int wn,
                                             int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = wm * 32 + mt * 16 + g;
      const int col = wn * 32 + nt * 8 + 2 * tg;
      *reinterpret_cast<float2*>(scores + row * kScoreStride + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(scores + (row + 8) * kScoreStride + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// Selection warp `sw`'s rows of one staged score tile folded into their
// running state: rows_select on the lane's four columns, the int8 mode's
// scale applied to the f32 score after the dot.
template <bool kScale, bool kPrune>
__device__ __forceinline__ void select_tile(
    const float* scores, const float* __restrict__ scale, int tile,
    int v_size, int kc, int sw, int lane, float (&m_run)[kRowsPerWarp],
    float (&s_run)[kRowsPerWarp], float (&buf_v)[kRowsPerWarp],
    int (&buf_i)[kRowsPerWarp]) {
  const int col0 = tile * kTile + lane;
  bool ok[kColsPerLane];
  int vi[kColsPerLane];
  float scl[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    ok[c] = col0 + 32 * c < v_size;
    vi[c] = ok[c] ? col0 + 32 * c : kNoIndex;
    scl[c] = kScale && ok[c] ? __ldg(scale + col0 + 32 * c) : 1.0f;
  }
  const float* rows = scores + sw * kRowsPerWarp * kScoreStride + lane;
  rows_select<kPrune>(
      [&](int r, int c) {
        const float s = rows[r * kScoreStride + 32 * c];
        return kScale ? s * scl[c] : s;
      },
      vi, ok, m_run, s_run, buf_v, buf_i, kc, lane);
}

}  // namespace tc

}  // namespace beamgen
