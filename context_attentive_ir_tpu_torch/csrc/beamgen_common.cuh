// Device pieces shared by the serial (kernel 2) and pipelined (kernel 3)
// generator kernels in beamgen.cu: the block geometry, the per-row online
// logsumexp + running top-kc update (rows_select), and the tensor-core
// score tiles (namespace tc): bf16 x on `mma.sync.m16n8k16`, float32 x on
// split-TF32 `mma.sync.m16n8k8` (tf32_mma.cuh).  Kernels of one dtype run
// the same product and the same selection, in the same order over k and
// over the vocab tiles, so every mode of one dtype gives the same bits.
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

// a ranks before b: larger value, or equal value and lower index
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block

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

// Insert into the row's running top-kc (entry p on lane p % 32, slot
// p / 32, sorted by `beats`) each of the tile's candidates that beats the
// running kc-th entry, first lane first; every insertion raises the kc-th
// entry, and a candidate that no longer beats it is left out.  Only
// candidates that could enter are touched, S ballots and one shuffle-shift
// each, and a row with none costs one vote; the buffer ends as the exact
// top-kc of [buffer | tile], whatever the order.
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

// The warp's rows' scores of one tile folded into each row's online
// logsumexp (m_run, s_run) and running top-kc (entry p on lane p % 32,
// slot p / 32): load(r, c) is row r's logit at the lane's column c (vocab id
// vi[c], ok[c] whether it exists).  kGroup rows go through the logsumexp
// at once, so their shuffle chains overlap; every row's arithmetic is the
// one-row sequence (a butterfly max and sum, expf in column order).  Both
// modes insert only the candidates that beat the row's running kc-th entry
// (insert_gains), so the selection costs what enters the top-kc, not kc
// passes a tile (the TPU's unpruned kernel merges every tile whole: a
// design for its vector unit); kPrune first votes the kGroup rows in
// lockstep and skips the rows whose tile holds no such candidate.  The
// top-kc is exact either way, so the modes give the same bits.
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
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        insert_gains(v[g], vi, ok, buf_v[g0 + g], buf_i[g0 + g], kc, lane);
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

// -- tensor-core score tiles (kernels 2 and 3) ------------------------------
//
// A block owns kRowBlock rows and a run of vocab tiles.  Up to the E its
// shared memory holds whole (stream_x), its x rows are staged once in x's
// type, row-major, each row padded by 16 bytes so the eight row addresses
// of an `ldmatrix` fall in eight bank groups, and zero past e up to ep(e),
// the next multiple of one `mma`'s k (16 bf16, 8 float32: the last k step's
// zero fill).  The table's [e, kTile] column tiles stream through a ring of
// kStages slabs of kKs k-rows, copied by 16-byte `cp.async` (rows past e
// and pieces past V zero-filled), so the copy of the next slabs -- across
// tile boundaries -- runs under the `mma` of this one.  Past that E, x is
// streamed too: each ring slot holds the table slab and beside it the
// [kRowBlock, kKs] x slab it multiplies (rows an odd number of 16-byte
// pieces apart, again eight bank groups), copied with it by `cp.async`
// from x rows `ldx` elements apart (the wrapper pads x to whole 16-byte
// pieces with zeros); x's columns from e on are zero-filled, and the
// table's rows there are zero, so the last slab adds nothing past e.  No
// tile grows with E, so every E fits; the `mma` run in the same k order
// over the same values, so a streamed x gives the whole tile's bits.
// Eight product warps (2 x 4) each own 32 rows x 32 columns of the
// 64 x 128 score tile.
//   - bf16 x (Tile<bf16>): per k16 step two A fragments (`ldmatrix.x4`),
//     two B fragment pairs (`ldmatrix.x4.trans`), eight
//     `mma.sync.m16n8k16` (bf16 in, f32 accumulate), k ascending, into the
//     tile's accumulators.  An int8 table is staged as int8 (half the
//     bytes) and widened to bf16 in shared memory before its B fragments:
//     every int8 value is exact in bf16.
//   - float32 x (Tile<float>): split TF32 (tf32_mma.cuh).  Per k8 step two
//     A fragments (`ldmatrix.x4` of f32 rows) and four B fragments (two
//     scalar loads a lane from a slab row of 136 floats: 8 words modulo
//     32, no bank conflict), each split into hi and lo where it is loaded;
//     each 16 x 8 tile takes lo*hi, hi*lo, hi*hi in that order, 24
//     `mma.sync.m16n8k8` a warp a step.  A slab's products start from a
//     fresh accumulator that f32 adds then fold into the tile's sum: the
//     tensor core's own adds do not round to nearest, which biased long
//     sums (PERF.md, float32 kernels 5 and 9).  An int8 table stays int8
//     in its slab: |q| <= 127 is exact in TF32, so a B fragment is the
//     values themselves and a product two terms, x_lo*q then x_hi*q (the
//     scale applied to the score after the dot).
// The f32 score tile goes to a shared [kRowBlock][kScoreStride] buffer,
// from which the selection warps read their rows in rows_select's layout
// (lane l: columns l, l + 32, l + 64, l + 96).
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
namespace t32 = cair_lstm::tf32;

constexpr int kThreads = kWarps * 32;  // the product warps of a block
constexpr int kKs = 32;                // table k-rows per slab
constexpr int kStages = 4;             // slabs in the ring
constexpr int kScoreStride = kTile + 8;    // floats per staged score row
constexpr int kNarrowStride = kTile + 16;  // bytes per int8 slab row
constexpr int kScoreBytes = kRowBlock * kScoreStride * 4;
constexpr int kHeader = 64;  // the pipelined kernel's mbarriers

// What the tiles of one type of x take: the k of one `mma`, the bytes of a
// float-table slab row and of a streamed x slab row.
template <typename TX>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int kStep = 16;
  static constexpr int kWideRow = kTile * 2 + 16;
  static constexpr int kXRow = kKs * 2 + 16;
};
template <>
struct Tile<float> {
  static constexpr int kStep = 8;
  static constexpr int kWideRow = kTile * 4 + 32;
  static constexpr int kXRow = kKs * 4 + 16;
};

template <typename TX>
__host__ __device__ inline int ep(int e) {
  return (e + Tile<TX>::kStep - 1) / Tile<TX>::kStep * Tile<TX>::kStep;
}
template <typename TX>
__host__ __device__ inline int x_stride(int e) {
  return ep<TX>(e) * (int)sizeof(TX) + 16;
}
template <typename TX>
__host__ __device__ constexpr int x_slab_bytes() {
  return kRowBlock * Tile<TX>::kXRow;
}

// The slab ring's bytes: kStages float-table slabs, each with its x slab
// when x is streamed (an int8 ring -- narrow slots, plus one widened slab
// for bf16 x -- fits in a float ring's bytes either way).
template <typename TX>
__host__ __device__ constexpr int ring_bytes(bool stream) {
  return kStages *
         (kKs * Tile<TX>::kWideRow + (stream ? x_slab_bytes<TX>() : 0));
}

// Dynamic shared memory of a block: (the pipelined kernel's header,) the
// whole x tile unless x is streamed, one score buffer (two when pipelined)
// and the slab ring.  `beamgen_smem_bytes` in ops/kernels/beamgen.py
// states the same sum.
template <typename TX>
__host__ __device__ inline size_t smem_bytes(int e, bool pipelined,
                                             bool stream) {
  return (pipelined ? kHeader : 0) +
         (stream ? 0 : (size_t)kRowBlock * x_stride<TX>(e)) +
         (pipelined ? 2 : 1) * (size_t)kScoreBytes + ring_bytes<TX>(stream);
}

// Whether a block streams x in k-slabs: exactly when the whole x tile does
// not fit (bf16: kernel 2 past E = 1,264, kernel 3 past 976; float32:
// kernel 2 past 496, kernel 3 past 352), so every shape that fits keeps
// the whole tile.  `beamgen_streams_x` states the same rule.
template <typename TX>
__host__ __device__ inline bool stream_x(int e, bool pipelined) {
  return smem_bytes<TX>(e, pipelined, false) > (size_t)kSmemLimit;
}

// x rows [row0, row0 + kRowBlock) of x [n_rows, e] (rows ldx elements
// apart) into the staged tile (rows x_stride(e) bytes apart); rows past
// n_rows and columns [e, ep(e)) are zero.  Plain loads (bf16 in pairs): x
// rows need not be 16-byte aligned, and the tile is read once per block.
__device__ __forceinline__ void stage_x(const bf16* __restrict__ x, char* xs,
                                        int n_rows, int e, int ldx, int row0,
                                        int tid, int n_threads) {
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
  const int half = ep<bf16>(e) / 2;
  const int xst = x_stride<bf16>(e);
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

__device__ __forceinline__ void stage_x(const float* __restrict__ x,
                                        char* xs, int n_rows, int e, int ldx,
                                        int row0, int tid, int n_threads) {
  const int kp = ep<float>(e);
  const int xst = x_stride<float>(e);
  for (int i = tid; i < kRowBlock * kp; i += n_threads) {
    const int r = i / kp;
    const int k = i - r * kp;
    const int row = row0 + r;
    *reinterpret_cast<float*>(xs + r * xst + k * 4) =
        row < n_rows && k < e ? __ldg(x + (size_t)row * ldx + k) : 0.0f;
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
// n % kStages, staged row-major (a float table's rows Tile<TX>::kWideRow
// bytes apart, an int8 table's kNarrowStride).  Table rows are `ld`
// elements apart (ld * size of TW a multiple of 16, the table 16-byte
// aligned), so every 16-byte piece is one cp.async; a piece that starts
// past v_size is zero-filled, one that crosses it reads the row's padding
// (masked by the selection).  With `x` set (x streamed), the slot also
// takes x's columns [s * kKs, (s + 1) * kKs) of the block's rows,
// kTableBytes into it.  Only the kThreads product threads call these; each
// thread's cp.async group g holds its copies of slab g.
template <typename TX, typename TW, bool kAll>
struct SlabRing {
  static constexpr int kRow =
      sizeof(TW) == 1 ? kNarrowStride : Tile<TX>::kWideRow;
  static constexpr int kTableBytes = kKs * kRow;
  static constexpr int kPer = 16 / (int)sizeof(TW);   // elements per piece
  static constexpr int kPieces = kTile / kPer;        // pieces per row
  static constexpr int kXPer = 16 / (int)sizeof(TX);  // x elements per piece
  static constexpr int kXPieces = kKs / kXPer;        // x pieces per row

  char* base;
  const TW* table;
  const TX* x;  // nullptr: the whole x tile is staged
  int e, v_size, ld, n_slabs, tile_begin, total;
  int ldx, n_rows, row0;

  // bytes of a ring slot
  __device__ __forceinline__ int slot() const {
    return kTableBytes + (x != nullptr ? x_slab_bytes<TX>() : 0);
  }
  // where the slab ring ends (a bf16 int8 ring's widened slab starts here)
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
        const int k = k0 + p * kXPer;
        const bool in = row < n_rows && k < e;
        const TX* src = in ? x + (size_t)row * ldx + k : x;
        cp_async16(xd + r * Tile<TX>::kXRow + p * 16, src, in);
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

// An int8 slab widened to bf16 (exact) into `wide` (rows
// Tile<bf16>::kWideRow bytes apart), then a barrier: the caller's slab_mma
// reads it.  `wide` is free: the acquire that returned `narrow` came after
// every warp's last read.
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
    int4* dst =
        reinterpret_cast<int4*>(wide + r * Tile<bf16>::kWideRow + p * 32);
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
  constexpr int kRow = Tile<bf16>::kWideRow;
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
      ldsm_x4_trans(b[np], slab + (kk + b_k) * kRow +
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

// The same share of one float32 (TW float) or int8 (TW int8_t) slab with
// f32 x, in split TF32: k8 steps ascending (kcount a multiple of 8) into a
// fresh accumulator, which is then added to acc.
template <typename TW>
__device__ __forceinline__ void slab_mma_tf32(float (&acc)[2][4][4],
                                              const char* xs, int xst,
                                              int k0, const char* slab,
                                              int kcount, int wm, int wn,
                                              int lane) {
  constexpr int kRow = SlabRing<float, TW, true>::kRow;
  const int g = lane >> 2, tg = lane & 3;
  float part[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.0f;
  // the A fragment rows of lanes 0-15, k + 4 for lanes 16-31
  const char* a_base =
      xs + (wm * 32 + (lane & 15)) * xst + (k0 + (lane >> 4) * 4) * 4;
  // the B fragments: k row tg (b0) and tg + 4 (b1), column g of each n-tile
  const char* b_base = slab + tg * kRow + (wn * 32 + g) * (int)sizeof(TW);
  for (int kk = 0; kk < kcount; kk += 8) {
    t32::AFrag a[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t raw[4];
      ldsm_x4(raw, a_base + mt * 16 * xst + kk * 4);
      t32::split_a(a[mt], raw);
    }
    const TW* b_lo = reinterpret_cast<const TW*>(b_base + kk * kRow);
    const TW* b_hi = reinterpret_cast<const TW*>(b_base + (kk + 4) * kRow);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float b0 = static_cast<float>(b_lo[nt * 8]);
      const float b1 = static_cast<float>(b_hi[nt * 8]);
      if constexpr (sizeof(TW) == 4) {
        const t32::BFrag b = t32::split_b(b0, b1);
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            t32::mma_term(part[mt][nt], a[mt], b, term);
      } else {
        // an int8 value is a TF32 value: no lo half
        const uint32_t q0 = __float_as_uint(b0), q1 = __float_as_uint(b1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) t32::mma(part[mt][nt], a[mt].lo, q0, q1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) t32::mma(part[mt][nt], a[mt].hi, q0, q1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
}

// All slabs of one vocab tile: acc = x_tile @ table[:, tile] (ring slabs
// n .. n + n_slabs - 1; n advances), x from the whole staged tile `xs` or,
// streamed, from each slot's x slab.  `wide`: a bf16 int8 ring's widened
// slab.
template <typename TX, typename TW, bool kAll>
__device__ __forceinline__ void tile_mma(float (&acc)[2][4][4],
                                         SlabRing<TX, TW, kAll>& ring,
                                         int& n, const char* xs, char* wide,
                                         int e, int wm, int wn, int tid,
                                         int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
  const bool streamed = ring.x != nullptr;
  const int xst = streamed ? Tile<TX>::kXRow : x_stride<TX>(e);
  const int ek = ep<TX>(e);
  for (int s = 0; s < ring.n_slabs; ++s, ++n) {
    const char* slot = ring.acquire(n, tid);
    const int k0 = s * kKs;
    const int kcount = min(kKs, ek - k0);
    // x from the slot's slab (its k from 0) or from the whole tile
    const char* a = streamed ? slot + SlabRing<TX, TW, kAll>::kTableBytes
                             : xs;
    const int ka = streamed ? 0 : k0;
    if constexpr (std::is_same<TX, float>::value) {
      slab_mma_tf32<TW>(acc, a, xst, ka, slot, kcount, wm, wn, lane);
    } else {
      const char* slab = slot;
      if constexpr (sizeof(TW) == 1) {
        widen_slab<kAll>(slot, wide, tid);
        slab = wide;
      }
      slab_mma(acc, a, xst, ka, slab, kcount, wm, wn, lane);
    }
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
