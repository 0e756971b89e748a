// Device pieces shared by the serial (kernel 2) and pipelined (kernel 3)
// generator kernels in beamgen.cu: the block geometry, the per-row online
// logsumexp + running top-kc update (rows_select), and the two ways to get
// a tile's scores -- the exact f32 FMA loop of the float32 kernels
// (tile_fma) and the bf16 tensor-core tiles of the bf16 kernels (namespace
// tc).  Kernels of one dtype run the same product and the same selection,
// in the same order over k and over the vocab tiles, so every mode of one
// dtype gives the same bits.
//
// A row's running top-kc (kc <= kMaxK = 128, the TPU kernel's _KPAD) is
// spread over its warp's lanes: entry p lies on lane p % 32 in slot p / 32,
// S = slots_for(kc) registers a lane (a template parameter: 1 for kc <= 32,
// one register a row as before; 2 up to 64; 4 up to 128).

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
constexpr int kMaxK = 128;
constexpr int kNoIndex = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// registers a lane gives each row's running top-kc
__host__ __device__ constexpr int slots_for(int kc) {
  return kc <= 32 ? 1 : kc <= 64 ? 2 : 4;
}

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

// Columns [k0, k0 + kn) of x rows [row0, row0 + kRowBlock) (x rows ldx
// elements apart) into shared memory as f32, k-major: xs[k * kRowBlock + r]
// for k < kn (rows past n_rows read 0).  The whole x tile is k0 = 0,
// kn = e.
template <typename TX>
__device__ __forceinline__ void stage_x(const TX* __restrict__ x, float* xs,
                                        int n_rows, int ldx, int row0,
                                        int k0, int kn) {
  for (int i = threadIdx.x; i < kRowBlock * kn; i += blockDim.x) {
    const int r = i / kn;
    const int k = i - r * kn;
    const int row = row0 + r;
    xs[k * kRowBlock + r] =
        row < n_rows ? to_f32(x[(size_t)row * ldx + k0 + k]) : 0.0f;
  }
}

// -- float32 x: where x lives --------------------------------------------------
//
// The CUDA-core kernels stage x as f32, k-major.  Up to the E a block's
// shared memory holds, the whole [E, 64] x tile once per block (the serial
// kernel: E <= 908; the pipelined kernel beside its two table stages:
// E <= 652); past it, x is streamed in chunks of k-rows: the serial kernel
// stages kF32XChunk k-rows of x at a time for each vocab tile, the
// pipelined kernel puts the x rows of each table k-chunk (kF32Chunk rows)
// beside it in a second two-slot ring.  Either way every product's fmaf
// runs in ascending k, so the chunked kernels give the whole tile's bits.
// `beamgen_smem_bytes` / `beamgen_streams_x` in ops/kernels/beamgen.py
// state the same sums and switch.
constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block
constexpr int kTile4 = kTile * 4;    // bytes of a table row of one f32 tile
// table rows of one k-chunk staged per ring slot of the f32 pipelined
// kernel: 32 KB per stage
constexpr int kF32Chunk = 32768 / kTile4;
// x k-rows the serial f32 kernel stages at once when x is streamed (64 KB)
constexpr int kF32XChunk = 256;

__host__ __device__ inline size_t f32_smem_bytes(int e, bool pipelined,
                                                 bool stream) {
  const size_t row = kRowBlock * sizeof(float);
  if (pipelined)
    return 2 * (size_t)kF32Chunk * kTile4 +
           (stream ? 2 * (size_t)kF32Chunk : (size_t)e) * row;
  return (stream ? (size_t)kF32XChunk : (size_t)e) * row;
}

__host__ __device__ inline bool f32_stream_x(int e, bool pipelined) {
  return f32_smem_bytes(e, pipelined, false) > (size_t)kSmemLimit;
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

// The row's running kc-th entry (lane (kc - 1) % 32, slot (kc - 1) / 32),
// on every lane.
template <int S>
__device__ __forceinline__ void kth_entry(const float (&bv)[S],
                                          const int (&bi)[S], int kc,
                                          float& kth_v, int& kth_i) {
  const int js = (kc - 1) >> 5;
  float v = bv[0];
  int i = bi[0];
#pragma unroll
  for (int j = 1; j < S; ++j) {
    if (j == js) {
      v = bv[j];
      i = bi[j];
    }
  }
  kth_v = __shfl_sync(kFull, v, (kc - 1) & 31);
  kth_i = __shfl_sync(kFull, i, (kc - 1) & 31);
}

// Insert (cv, ci), which beats the row's running kc-th entry, into the
// row's sorted top-kc: it lands after the entries that beat it, every
// later entry p < kc takes entry p - 1's place (lane l - 1 of its slot;
// lane 31 of the slot before for lane 0) and the kc-th falls out.  Slots
// are shifted from the last down, so each reads its predecessor unmoved.
template <int S>
__device__ __forceinline__ void insert_entry(float (&bv)[S], int (&bi)[S],
                                             float cv, int ci, int kc,
                                             int lane) {
  int pos = 0;  // < kc
#pragma unroll
  for (int j = 0; j < S; ++j)
    pos += __popc(__ballot_sync(
        kFull, 32 * j + lane < kc && beats(bv[j], bi[j], cv, ci)));
#pragma unroll
  for (int j = S - 1; j >= 0; --j) {
    float up_v = __shfl_up_sync(kFull, bv[j], 1);
    int up_i = __shfl_up_sync(kFull, bi[j], 1);
    if (j > 0) {
      const float carry_v = __shfl_sync(kFull, bv[j > 0 ? j - 1 : 0], 31);
      const int carry_i = __shfl_sync(kFull, bi[j > 0 ? j - 1 : 0], 31);
      if (lane == 0) {
        up_v = carry_v;
        up_i = carry_i;
      }
    }
    const int p = 32 * j + lane;
    if (p == pos) {
      bv[j] = cv;
      bi[j] = ci;
    } else if (p > pos && p < kc) {
      bv[j] = up_v;
      bi[j] = up_i;
    }
  }
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

// prune: insert into the row's running top-kc (entry p on lane p % 32,
// slot p / 32, sorted by `beats`) each of the tile's candidates that beats
// the running kc-th entry, first lane first; every insertion raises the
// kc-th entry, and a candidate that no longer beats it is left out.  Only
// candidates that could enter are touched, S ballots and one shuffle-shift
// each; the buffer ends as the exact top-kc of [buffer | tile], whatever
// the order.  The caller has found that some candidate beats the kc-th
// entry.
template <int S>
__device__ __forceinline__ void insert_gains(const float (&v)[kColsPerLane],
                                             const int (&vi)[kColsPerLane],
                                             const bool (&ok)[kColsPerLane],
                                             float (&buf_v)[S],
                                             int (&buf_i)[S], int kc,
                                             int lane) {
  unsigned done = 0;  // bit c: column c inserted
  for (;;) {
    float kth_v;
    int kth_i;
    kth_entry(buf_v, buf_i, kc, kth_v, kth_i);
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
    insert_entry(buf_v, buf_i, cv, ci, kc, lane);
  }
}

// Rows g0 .. g0 + kGroup - 1: kc exact argmax passes over [tile | buffer]
// (v[g]: row g0 + g's scores), the rows in lockstep; pass p's winner is
// entry p of the new buffer (lane p % 32, slot p / 32).
template <int S>
__device__ __forceinline__ void passes_select(
    const float (&v)[kGroup][kColsPerLane], const int (&vi)[kColsPerLane],
    const bool (&ok)[kColsPerLane], float (&buf_v)[kRowsPerWarp][S],
    int (&buf_i)[kRowsPerWarp][S], int g0, int kc, int lane) {
  // bit c: tile column c, bit kColsPerLane + j: buffer slot j
  unsigned taken[kGroup];
  float new_v[kGroup][S];
  int new_i[kGroup][S];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    taken[g] = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      new_v[g][j] = -INFINITY;
      new_i[g][j] = kNoIndex;
    }
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
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (32 * j + lane < kc && !(taken[g] >> (kColsPerLane + j) & 1u) &&
            (slot[g] < 0 ||
             beats(buf_v[g0 + g][j], buf_i[g0 + g][j], lv[g], li[g]))) {
          lv[g] = buf_v[g0 + g][j];
          li[g] = buf_i[g0 + g][j];
          slot[g] = kColsPerLane + j;
        }
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
      if (lane == (p & 31)) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (j == (p >> 5)) {
            new_v[g][j] = gv[g];
            new_i[g][j] = gi[g];
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (32 * j + lane < kc) {
        buf_v[g0 + g][j] = new_v[g][j];
        buf_i[g0 + g][j] = new_i[g][j];
      }
    }
  }
}

// The warp's rows' scores of one tile folded into each row's online
// logsumexp (m_run, s_run) and running top-kc (entry p on lane p % 32,
// slot p / 32): load(r, c) is row r's logit at the lane's column c (vocab id
// vi[c], ok[c] whether it exists).  kGroup rows go through the logsumexp
// (and the passes) at once, so their shuffle chains overlap; every row's
// arithmetic is the one-row sequence (a butterfly max and sum, expf in
// column order).  The top-kc is exact in both forms, so they give the same
// bits: kPrune inserts only the candidates that beat the row's running
// kc-th entry (insert_gains; a tile with none costs one vote), otherwise
// kc exact argmax passes run over [tile | buffer] on every tile, as the
// TPU's unpruned kernel.
template <bool kPrune, int S, typename Load>
__device__ __forceinline__ void rows_select(
    Load load, const int (&vi)[kColsPerLane], const bool (&ok)[kColsPerLane],
    float (&m_run)[kRowsPerWarp], float (&s_run)[kRowsPerWarp],
    float (&buf_v)[kRowsPerWarp][S], int (&buf_i)[kRowsPerWarp][S], int kc,
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
      for (int g = 0; g < kGroup; ++g) {
        float kth_v;
        int kth_i;
        kth_entry(buf_v[g0 + g], buf_i[g0 + g], kc, kth_v, kth_i);
        gain[g] = gains(v[g], vi, ok, kth_v, kth_i);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (__any_sync(kFull, gain[g]))
          insert_gains(v[g], vi, ok, buf_v[g0 + g], buf_i[g0 + g], kc, lane);
    } else {
      passes_select(v, vi, ok, buf_v, buf_i, g0, kc, lane);
    }
  }
}

// Every row's state at the start of a split: no score seen, an empty
// running top-kc.
template <int S>
__device__ __forceinline__ void init_rows(float (&m_run)[kRowsPerWarp],
                                          float (&s_run)[kRowsPerWarp],
                                          float (&buf_v)[kRowsPerWarp][S],
                                          int (&buf_i)[kRowsPerWarp][S]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    s_run[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      buf_v[r][j] = -INFINITY;
      buf_i[r][j] = kNoIndex;
    }
  }
}

// The warp's rows' partial results for its vocab split.
template <int S>
__device__ __forceinline__ void store_partials(
    const float (&m_run)[kRowsPerWarp], const float (&s_run)[kRowsPerWarp],
    const float (&buf_v)[kRowsPerWarp][S],
    const int (&buf_i)[kRowsPerWarp][S], int row0, int warp, int lane,
    int split, int n_rows, int kc, float* __restrict__ part_v,
    int* __restrict__ part_i, float* __restrict__ part_m,
    float* __restrict__ part_s) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    const size_t at = (size_t)split * n_rows + row;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (32 * j + lane < kc) {
        part_v[at * kc + 32 * j + lane] = buf_v[r][j];
        part_i[at * kc + 32 * j + lane] = buf_i[r][j];
      }
    }
    if (lane == 0) {
      part_m[at] = m_run[r];
      part_s[at] = s_run[r];
    }
  }
}

// -- bf16 tensor-core tiles (kernels 2 and 3 on bf16 x) ----------------------
//
// A block owns kRowBlock rows and a run of vocab tiles.  Up to the E its
// shared memory holds whole (stream_x), its x rows are staged once in bf16,
// row-major, each row padded by 16 bytes so the eight row addresses of an
// `ldmatrix` fall in eight bank groups, and zero past e up to ep(e), the
// next multiple of 16 (the last k-slab's zero fill).  The table's [e, kTile]
// column tiles stream through a ring of kStages slabs of kKs k-rows, copied
// by 16-byte `cp.async` (rows past e and pieces past V zero-filled), so the
// copy of the next slabs -- across tile boundaries -- runs under the `mma`
// of this one.  Past that E, x is streamed too: each ring slot holds the
// table slab and beside it the [kRowBlock, kKs] x slab it multiplies
// (rows kXSlabStride bytes apart, again eight bank groups), copied with it
// by `cp.async` from x rows `ldx` elements apart (the wrapper pads x to a
// multiple of 8 columns with zeros); x's columns from e on are
// zero-filled, and the table's rows there are zero, so the last slab adds
// nothing past e.  No tile grows with E, so every E fits; the `mma` run in
// the same k order over the same values, so a streamed x gives the whole
// tile's bits.  Eight product warps (2 x 4) each own
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
constexpr int kScoreStride = kTile + 8;        // floats per staged score row
constexpr int kWideStride = kTile * 2 + 16;    // bytes per bf16 slab row
constexpr int kNarrowStride = kTile + 16;      // bytes per int8 slab row
constexpr int kXSlabStride = kKs * 2 + 16;     // bytes per streamed x row
constexpr int kXSlabBytes = kRowBlock * kXSlabStride;
constexpr int kScoreBytes = kRowBlock * kScoreStride * 4;
constexpr int kHeader = 64;  // the pipelined kernel's mbarriers

__host__ __device__ inline int ep(int e) { return (e + 15) / 16 * 16; }
__host__ __device__ inline int x_stride(int e) { return ep(e) * 2 + 16; }

// The slab ring's bytes: kStages bf16 table slabs, each with its x slab
// when x is streamed (an int8 ring -- narrow slots plus one widened slab --
// fits in a bf16 ring's bytes either way).
__host__ __device__ constexpr int ring_bytes(bool stream) {
  return kStages * (kKs * kWideStride + (stream ? kXSlabBytes : 0));
}

// Dynamic shared memory of a block: (the pipelined kernel's header,) the
// whole x tile unless x is streamed, one score buffer (two when pipelined)
// and the slab ring.  `beamgen_smem_bytes` in ops/kernels/beamgen.py
// states the same sum.
__host__ __device__ inline size_t smem_bytes(int e, bool pipelined,
                                             bool stream) {
  return (pipelined ? kHeader : 0) +
         (stream ? 0 : (size_t)kRowBlock * x_stride(e)) +
         (pipelined ? 2 : 1) * (size_t)kScoreBytes + ring_bytes(stream);
}

// Whether a block streams x in k-slabs: exactly when the whole x tile does
// not fit (kernel 2 past E = 1,264, kernel 3 past 976), so every shape that
// fits keeps the whole tile.  `beamgen_streams_x` states the same rule.
__host__ __device__ inline bool stream_x(int e, bool pipelined) {
  return smem_bytes(e, pipelined, false) > (size_t)kSmemLimit;
}

// x rows [row0, row0 + kRowBlock) of x [n_rows, e] (bf16, rows ldx
// elements apart) into the staged tile (rows x_stride(e) bytes apart);
// rows past n_rows and columns [e, ep(e)) are zero.  Plain 2-byte loads:
// x rows need not be 16-byte aligned, and the tile is read once per block.
__device__ __forceinline__ void stage_x_bf16(
    const bf16* __restrict__ x, char* xs, int n_rows, int e, int ldx,
    int row0, int tid, int n_threads) {
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
  const int half = ep(e) / 2;
  const int xst = x_stride(e);
  for (int i = tid; i < kRowBlock * half; i += n_threads) {
    const int r = i / half;
    const int k = 2 * (i - r * half);
    const int row = row0 + r;
    uint32_t pair = 0;
    if (row < n_rows) {
      const unsigned short* src = xb + (size_t)row * ldx + k;
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
// With `x` set (x streamed), the slot also takes x's columns
// [s * kKs, (s + 1) * kKs) of the block's rows, kTableBytes into it.
// Only the kThreads product threads call these; each thread's cp.async
// group g holds its copies of slab g.
template <typename TW, bool kAll>
struct SlabRing {
  static constexpr int kRow = sizeof(TW) == 1 ? kNarrowStride : kWideStride;
  static constexpr int kTableBytes = kKs * kRow;
  static constexpr int kPer = 16 / (int)sizeof(TW);  // elements per piece
  static constexpr int kPieces = kTile / kPer;       // pieces per row
  static constexpr int kXPieces = kKs / 8;           // x pieces per row

  char* base;
  const TW* table;
  const bf16* x;  // nullptr: the whole x tile is staged
  int e, v_size, ld, n_slabs, tile_begin, total;
  int ldx, n_rows, row0;

  // bytes of a ring slot
  __device__ __forceinline__ int slot() const {
    return kTableBytes + (x != nullptr ? kXSlabBytes : 0);
  }
  // where the slab ring ends (an int8 ring's widened slab starts here)
  __device__ __forceinline__ char* end() const {
    return base + kStages * slot();
  }

  __device__ __forceinline__ void issue(int n, int tid) {
    if (n >= total) return;
    const int tile = tile_begin + n / n_slabs;
    const int k0 = (n % n_slabs) * kKs;
    char* dst = base + (n % kStages) * slot();
    for (int i = tid; i < kKs * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int p = i - r * kPieces;
      const int k = k0 + r;
      const int col = tile * kTile + p * kPer;
      const bool in = k < e && col < v_size;
      const TW* src = in ? table + (size_t)k * ld + col : table;
      cp_async16(dst + r * kRow + p * 16, src, in);
    }
    if (x != nullptr) {
      char* xd = dst + kTableBytes;
      for (int i = tid; i < kRowBlock * kXPieces; i += kThreads) {
        const int r = i / kXPieces;
        const int p = i - r * kXPieces;
        const int row = row0 + r;
        const int k = k0 + p * 8;
        const bool in = row < n_rows && k < e;
        const bf16* src = in ? x + (size_t)row * ldx + k : x;
        cp_async16(xd + r * kXSlabStride + p * 16, src, in);
      }
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
    return base + (n % kStages) * slot();
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
// n .. n + n_slabs - 1; n advances), x from the whole staged tile `xs` or,
// streamed, from each slot's x slab.
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
  const bool streamed = ring.x != nullptr;
  const int xst = streamed ? kXSlabStride : x_stride(e), e16 = ep(e);
  for (int s = 0; s < ring.n_slabs; ++s, ++n) {
    const char* slot = ring.acquire(n, tid);
    const char* slab = slot;
    if constexpr (sizeof(TW) == 1) {
      widen_slab<kAll>(slot, wide, tid);
      slab = wide;
    }
    const int k0 = s * kKs;
    const int kcount = min(kKs, e16 - k0);
    if (streamed)
      slab_mma(acc, slot + SlabRing<TW, kAll>::kTableBytes, xst, 0, slab,
               kcount, wm, wn, lane);
    else
      slab_mma(acc, xs, xst, k0, slab, kcount, wm, wn, lane);
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
template <bool kScale, bool kPrune, int S>
__device__ __forceinline__ void select_tile(
    const float* scores, const float* __restrict__ scale, int tile,
    int v_size, int kc, int sw, int lane, float (&m_run)[kRowsPerWarp],
    float (&s_run)[kRowsPerWarp], float (&buf_v)[kRowsPerWarp][S],
    int (&buf_i)[kRowsPerWarp][S]) {
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
  rows_select<kPrune, S>(
      [&](int r, int c) {
        const float s = rows[r * kScoreStride + 32 * c];
        return kScale ? s * scl[c] : s;
      },
      vi, ok, m_run, s_run, buf_v, buf_i, kc, lane);
}

}  // namespace tc

}  // namespace beamgen
