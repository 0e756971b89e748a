// Tensor-core tiles of the recurrent kernels (lstm_fwd.cu, lstm_bwd.cu,
// gru_fwd.cu, gru_bwd.cu): `mma.sync.m16n8k16` (bf16 x bf16, f32
// accumulate) fed by `ldmatrix` from operands staged in shared memory in
// bf16 -- float32 the same layout with f32 operands on split-TF32
// `m16n8k8` tiles (Elt<T> below, tf32_mma.cuh) -- and the ring of bulk
// copies that streams the weights.  Everything
// here takes the number of gate column blocks NG: 4 for the LSTM (i, f, g,
// o), 3 for the GRU (r, z, n).
//
// Layout of a row-tile block (8 warps, M = 16 * MT rows):
//
// - h is staged row-major in bf16, one row per sequence, every row padded by
//   16 bytes so the eight row addresses of an `ldmatrix` fall in eight
//   different bank groups.
// - The weights are streamed from L2 in slabs of `ks` k-rows through a ring
//   of kStages slabs.  The wrapper stages them once a call as one matrix
//   [W_ih; W_hh] of (E + H) rows of NG*H + 8 bf16 (8 zero columns: the
//   staged rows' padding), so a slab is one contiguous range and one thread
//   issues it as a single bulk copy (`cp.async.bulk`, completing on the
//   slot's mbarrier): the copy engine moves the bytes and the warps that run
//   the `mma` spend no load instructions on them.  One __syncthreads per
//   slab frees the slot consumed one slab earlier.  The stream runs on
//   across time steps, so the next step's first slabs arrive under the cell
//   update.  E and H are multiples of 32 and a slab holds 32 or 16 k-rows,
//   so every slab is all W_ih rows (an x slab) or all W_hh rows (an h slab).
// - x is streamed beside the weights: an x slab of the weight ring comes
//   with the [M, ks] bf16 columns of x_t it multiplies, copied by `cp.async`
//   into the ring's x slot of the same index (rows padded by 16 bytes, so an
//   `ldmatrix`'s eight row addresses again fall in eight bank groups).  No
//   tile grows with E, so every E fits.  The slab order (x slabs, then h
//   slabs) and the k order of the `mma` are those of a whole staged x row:
//   the products are the same bits.
// - Gate columns are not permuted in memory: the B fragment of an n-tile is
//   eight consecutive columns of any gate, so warp w takes, for each of its
//   G unit groups (8 hidden units), the n-tiles at columns q*H + 8*ug of
//   every gate q.  A thread's accumulator fragments at one position of
//   those tiles belong to one (row, unit): the cell update needs no
//   exchange and the carried state stays in registers across steps.
// - Four f32 accumulator slots per (row, unit) for either recurrence.  The
//   LSTM's are its four gates.  The GRU's are r, z, xn, hn: r multiplies
//   only the recurrent part of the n gate (n = tanh(xn + r * hn)), so the n
//   tile of an x slab goes into xn and that of an h slab into hn, with no
//   zero blocks staged and no `mma` wasted.
// - The same slabs, read through non-transposed `ldmatrix`, are the B
//   operand of dgates_c @ W^T in both backwards (slab rows = output
//   columns), so no transposed copy of the weights exists anywhere.
//
// Wide recurrences (LSTM H above kMaxSingle, GRU above kGruMaxSingle) split
// the gate columns over a thread-block cluster of C blocks (kernels 1, 4, 5
// and 7, 8, 9; the constants below): rank r owns hidden units
// r*Hc .. r*Hc + Hc - 1 (Hc = H / C) with every gate of them, streams its
// own column slice of [W_ih; W_hh] (the wrapper stages C matrices of
// (E + H) rows of NG*Hc + 8), and keeps the whole h in two tiles,
// read and written in turn: each step a block writes its units' new h into
// the next tile of every rank through distributed shared memory (`mapa`,
// `st.shared::cluster`) and arrives on the cluster barrier; the next step
// waits on it before its first h slab.  Here "hidden size" splits in two:
// `hk`, the k extent of h (all H units), and `hc`, the units whose gate
// columns a block computes (H in a single block).
//
// E and H are multiples of 32 here (the wrapper zero-pads other sizes; zero
// weights and biases keep padded units at exactly 0) and every pointer is
// 16-byte aligned.

#pragma once

#include "lstm_common.cuh"
#include "tf32_mma.cuh"

namespace cair_lstm {
namespace tiles {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;         // slabs in the weight ring
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kAlign = 32;          // E and H are multiples of this
constexpr int kLstmGates = 4;  // gate column blocks of each recurrence
constexpr int kGruGates = 3;

// The LSTM's cluster split (kernels 1, 4, 5): one block up to kMaxSingle,
// C = 2 blocks up to kMaxPair, C = 4 up to kMaxClustered, each rank with
// kClusterConfig's 16-row tile.  `lstm_cluster` in ops/kernels/lstm.py
// states the same rule.
constexpr int kMaxSingle = 384;
constexpr int kMaxPair = 512;
constexpr int kMaxClustered = 1024;

inline int lstm_cluster(int h) {
  return h <= kMaxSingle ? 1 : h <= kMaxPair ? 2 : h <= kMaxClustered ? 4 : 0;
}

// The route of the LSTM kernels, in both dtypes: one block, a cluster of
// blocks that exchange h through distributed shared memory (kernels 1, 4, 5
// alike: bf16 lstm_cluster, float32 f32_cluster), or the step route
// (lstm_step.cu: one launch a time step, h through device memory) for every
// H past those: above kMaxClustered for kernels 1, 4, 5 and above kMaxRec
// for kernel 6 (`rec`; its one block has 2H <= 1,024 threads).
// `lstm_route` in ops/kernels/lstm.py states the same rule.
enum Route { kRouteSingle = 0, kRouteCluster = 1, kRouteStep = 2 };
constexpr int kMaxRec = 512;

inline int lstm_route(int h, bool bf16, bool rec) {
  if (rec) return h <= kMaxRec ? kRouteSingle : kRouteStep;
  if (h > kMaxClustered) return kRouteStep;
  return (bf16 ? lstm_cluster(h) : f32_cluster(h)) > 1 ? kRouteCluster
                                                       : kRouteSingle;
}

// The GRU's cluster split (kernels 7, 8, 9): one block up to
// kGruMaxSingle (where kernel 9's single-block tiles stop fitting), then
// the LSTM's: C = 2 up to kMaxPair, C = 4 up to kMaxClustered, each rank
// with kClusterConfig's 16-row tile.  A rank's Hc units are a multiple of
// 16, since kernel 9's products step over its 3 Hc gate columns by 16: a
// cluster of 4 takes H a multiple of 64 (the wrapper pads to it).
// `gru_cluster` / `gru_tile_hidden` in ops/kernels/gru.py state the same.
constexpr int kGruMaxSingle = 448;

inline int gru_cluster(int h) {
  return h <= kGruMaxSingle ? 1
         : h <= kMaxPair    ? 2
         : h <= kMaxClustered ? 4
                              : 0;
}

// The route of the GRU kernels 7, 8 and 9 alike, in both dtypes, by the
// rule of lstm_route: one block (bf16 up to kGruMaxSingle, float32
// f32_cluster's one block), a cluster (bf16 gru_cluster, float32
// f32_cluster), or the step route (lstm_step.cu with three gate blocks)
// above kMaxClustered.  `gru_route` in ops/kernels/gru.py states the same
// rule.
inline int gru_route(int h, bool bf16) {
  if (h > kMaxClustered) return kRouteStep;
  return (bf16 ? gru_cluster(h) : f32_cluster(h)) > 1 ? kRouteCluster
                                                      : kRouteSingle;
}

// bf16 GRU tiles take E and H multiples of 32, a cluster and its ranks'
// multiple of 16 units
inline bool gru_tiles_ok(int e, int h) {
  const int c = gru_cluster(h);
  return e > 0 && e % kAlign == 0 && h > 0 && h % kAlign == 0 && c > 0 &&
         h % (16 * c) == 0;
}

// Rows and unit groups of a block by hidden size: warp w owns unit groups
// w*G .. w*G + G - 1 (8 units each) of all M = 16*MT rows; G * MT <= 8 keeps
// the 16 * G * MT accumulators of a thread in registers.
struct Config {
  int g, mt;
};

inline Config pick_config(int h) {
  if (h <= 64) return {1, 4};
  if (h <= 128) return {2, 4};
  if (h <= 256) return {4, 2};
  return {8, 1};
}

// The float32 tensor-core phase A of kernels 5 and 9 (split TF32) in one
// block (H up to 128, f32_cluster): the same unit groups per warp, fewer
// rows, since its f32 tiles take twice the bytes: 64 rows up to H = 64, 32
// up to 128.
inline Config pick_config_f32(int h) {
  return h <= 64 ? Config{1, 4} : Config{2, 2};
}

// a rank of a cluster: up to 256 units over the 8 warps, 16 rows
constexpr Config kClusterConfig = {4, 1};
// a float32 rank of kernels 5 and 9 (split TF32) in a cluster of c: its
// units (at most 128) in 2 unit groups a warp; 32 rows up to 4 ranks, 16 in
// a cluster of 8 (two 32-row h tiles of H = 1,024 do not fit)
inline Config cluster_config_f32(int c) { return {2, c <= 4 ? 2 : 1}; }

// The float32 forwards, kernels 1, 4, 7, 8 (split TF32), on f32_cluster's
// ranks: no gradient tile or dh partials share their shared memory, so a
// block holds more rows than the backward's, and the rows a block holds
// set how often the weight slabs stream from L2.  One block has 1 unit
// group a warp up to 64 units, 2 up to 128; a rank (at most 128 units) 2;
// their rows: f32_fwd_smem.
inline int f32_fwd_groups(int h) { return h <= 64 ? 1 : 2; }
// blocks that fill one H100 (its SMs): fewer row blocks take fewer rows
constexpr int kFillBlocks = 132;
// a unit tile of the step route: a rank's tile, all of its 256 units (the
// bf16 step route pads H to a multiple of it)
constexpr int kStepUnits = kClusterConfig.g * 8 * kWarps;

// bytes per staged row of elements of `elt` bytes (bf16 2, float32 4):
// 16 bytes of padding each, and a staged weight row's 8 zero columns
__host__ __device__ inline int h_stride(int h, int elt = 2) {
  return h * elt + 16;
}
__host__ __device__ inline int w_stride(int h, int gates, int elt = 2) {
  return (h * gates + 8) * elt;
}
// bytes per row of an x slot (ks columns of x_t)
__host__ __device__ inline int xslot_stride(int ks, int elt = 2) {
  return ks * elt + 16;
}

// bytes per row of a backward's staged gradient tile: four slots of H
// (the LSTM's four gates; the GRU's da_r, da_z, da_n, da_n * r)
__host__ __device__ inline int slot_stride(int h, int elt = 2) {
  return h * 4 * elt + 16;
}
// bytes of the f32 tile through which dh returns to its owning threads
__host__ __device__ inline size_t exch_bytes(int h, int m_rows) {
  return (size_t)m_rows * (h + 8) * 4;
}

// Dynamic shared memory of a row-tile block of m_rows rows with `gates`
// gate blocks, forward or backward phase A, a rank of a cluster of c blocks
// (c = 1: a single block, hc = hk), or 0 if no slab depth fits (*ks gets
// the depth: 32 k-rows, else 16, and for float32 (elt 4) else 8): the
// ring's header, slabs and x slots of `elt`-byte elements, the
// staged tiles, the bias (four f32 slots of hc) and, float32's backward,
// the warps' partials of its reverse products.  The forward stages the h
// tile (two in a cluster; a float32 forward passes c = 1 for a cluster
// whose rank keeps one, f32_fwd_smem); a backward reuses that space for
// its gradient tile (m_rows rows of four slots) and needs the f32 tile
// that dh returns through: the LSTM's single-block kernel 5 keeps it after
// that union, the GRU's single-block kernel 9 inside it, after the
// gradient tile; a cluster's rank (either recurrence) keeps there instead
// one tile of Hc columns per source rank (the dh partials of its units).
// `tile_smem_bytes` in ops/kernels/lstm.py states the same sum.
constexpr int kRingHeader = 64;  // the slots' mbarriers
// float32 backward: the partials of a reverse product's tiles from the
// warps of their split k extent but the first (32 lanes x 8 floats a warp)
constexpr int kRedBytes = (kWarps - 1) * 32 * 8 * 4;

__host__ __device__ inline size_t staged_bytes(int hk, int hc, int gates,
                                               int m_rows, bool backward,
                                               int c, int elt = 2) {
  const size_t fwd = (size_t)(c > 1 ? 2 : 1) * m_rows * h_stride(hk, elt);
  if (!backward) return fwd;
  size_t rev = (size_t)m_rows * slot_stride(hc, elt);
  if (c > 1)
    rev += (size_t)c * exch_bytes(hc, m_rows);
  else if (gates == kGruGates)
    rev += exch_bytes(hk, m_rows);
  return rev > fwd ? rev : fwd;
}

inline size_t mma_smem(int hk, int hc, int gates, int m_rows, bool backward,
                       int c, int* ks, int elt = 2) {
  for (int depth = 32; depth >= (elt == 4 ? 8 : 16); depth /= 2) {
    const size_t bytes =
        kRingHeader + (size_t)kStages * depth * w_stride(hc, gates, elt) +
        (size_t)kStages * m_rows * xslot_stride(depth, elt) +
        staged_bytes(hk, hc, gates, m_rows, backward, c, elt) +
        (backward && gates == kLstmGates && c == 1 ? exch_bytes(hk, m_rows)
                                                   : 0) +
        16 * hc + (backward && elt == 4 ? kRedBytes : 0);
    if (bytes <= kSmemLimit) {
      *ks = depth;
      return bytes;
    }
  }
  return 0;
}

// A float32 forward block (kernels 1, 4 with `gates` 4; 7, 8 with 3) at
// padded hidden size h for n_rows rows: its dynamic shared memory (0 if
// f32_cluster(h) is 0), *m_rows its rows, *ks its slab depth and *tiles
// its h tiles.  A block or rank takes the most rows of 64, 32 and 16 whose
// h tile fits beside some slab and whose row blocks, times the ranks, fill
// the card (kFillBlocks), else 16: rows a block save slab bytes only where
// every SM is busy.  One block keeps one tile, rewritten in place.  A rank
// keeps two, read and written in turn, unless one tile lets its slabs be
// deeper or two do not fit: then one, which the ranks rewrite after a
// second cluster barrier a step (every rank done reading it).  A deeper
// slab halves the ring's hand-overs a step, an mbarrier wait and a
// barrier each.  `f32_forward_tiles` in ops/kernels/lstm.py states the
// same rule.
inline size_t f32_fwd_smem(int h, int gates, int n_rows, int* m_rows,
                           int* ks, int* tiles) {
  const int c = f32_cluster(h);
  for (int m = 64; c > 0 && m >= 16; m /= 2) {
    int ks1 = 0, ks2 = 0;
    const size_t one = mma_smem(h, h / c, gates, m, false, 1, &ks1, 4);
    const long long blocks = ((long long)n_rows + m - 1) / m * c;
    if (one == 0 || (m > 16 && blocks < kFillBlocks)) continue;
    const size_t two =
        c > 1 ? mma_smem(h, h / c, gates, m, false, c, &ks2, 4) : 0;
    *m_rows = m;
    if (two != 0 && ks2 >= ks1) {
      *ks = ks2;
      *tiles = 2;
      return two;
    }
    *ks = ks1;
    *tiles = 1;
    return one;
  }
  return 0;
}

// Dynamic shared memory of a bf16 step-route block (lstm_step.cu: a unit
// tile of kStepUnits units, kClusterConfig's 16 rows) with `gates` gate
// blocks (the LSTM's 4, the GRU's 3), or 0 if no slab depth fits (*ks gets
// the depth): the ring's header, slabs of the tile's staged weights and x
// slots (x_t and h_{t-1} both stream through them), then the bias (four f32
// slots of the tile, the forward) or the tile's four gradient slots (the
// backward's dh product).  No term grows with E or H.  `step_smem_bytes`
// in ops/kernels/lstm.py states the same sum.
inline size_t step_smem(bool backward, int gates, int* ks) {
  const int m_rows = 16 * kClusterConfig.mt;
  for (int depth = 32; depth >= 16; depth /= 2) {
    const size_t bytes =
        kRingHeader + (size_t)kStages * depth * w_stride(kStepUnits, gates) +
        (size_t)kStages * m_rows * xslot_stride(depth) +
        (backward ? (size_t)m_rows * slot_stride(kStepUnits)
                  : (size_t)16 * kStepUnits);
    if (bytes <= kSmemLimit) {
      *ks = depth;
      return bytes;
    }
  }
  return 0;
}

// -- the cluster: rank, barrier, distributed shared memory --------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of every block of the cluster arrives (release: its shared
// and global writes before it are visible to the cluster after the wait)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the shared::cluster address of `p` (a shared variable of this block) in
// the block of the cluster with rank `rank`
__device__ __forceinline__ uint32_t map_rank(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float a,
                                              float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(a), "f"(b)
               : "memory");
}

}  // namespace tiles

// -- the element type of the recurrent tiles (lstm_mma.cuh) ----------------
//
// Each recurrent tile kernel -- the forwards 1, 4, 7, 8 and phase A of the
// backwards 5, 9 -- is one kernel for both types: bf16 runs
// `mma.sync.m16n8k16` on bf16 operands, float32 the split-TF32 tiles
// (tf32_mma.cuh; slab_gates_tf32, tf32_rev_product below).  Elt<T>
// holds the k values of a 32-byte step and the loads and stores of two
// adjacent values: to and from memory, and to another rank's h tile.

template <typename T>
struct Elt;

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kK = 16;  // k values of a 32-byte step
  static __device__ __forceinline__ void store2(void* p, float a, float b) {
    *reinterpret_cast<tiles::bf162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 load2(const void* p) {
    return __bfloat1622float2(*reinterpret_cast<const tiles::bf162*>(p));
  }
  // the pair (a, b) rounded, or the pair at `keep` unchanged (!m), to the
  // shared::cluster address `addr`
  static __device__ __forceinline__ void send2(uint32_t addr, bool m, float a,
                                               float b, const void* keep) {
    const tiles::bf162 v =
        m ? __floats2bfloat162_rn(a, b)
          : *reinterpret_cast<const tiles::bf162*>(keep);
    tiles::st_cluster_b32(addr, *reinterpret_cast<const uint32_t*>(&v));
  }
};

template <>
struct Elt<float> {
  static constexpr int kK = 8;
  static __device__ __forceinline__ void store2(void* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float2 load2(const void* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void send2(uint32_t addr, bool m, float a,
                                               float b, const void* keep) {
    const float2 v =
        m ? make_float2(a, b) : *reinterpret_cast<const float2*>(keep);
    tiles::st_cluster_f2(addr, v.x, v.y);
  }
};

namespace tiles {

// -- mbarrier and bulk copy (the weight ring) ---------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of this parity has completed.  A barrier
// that never completes (a fault in the ring's accounting) traps instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (spins > (1 << 22)) __trap();
  }
}

// `bytes` (a multiple of 16) from global to shared memory by the copy
// engine; completion is counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// x[row0 .. row0 + m_rows - 1, t, k0 .. k0 + ks - 1] into the x slot `dst`
// (rows xslot_stride(ks) bytes apart); rows past n_rows are zero-filled.
template <typename T>
__device__ __forceinline__ void load_x_slab(char* dst,
                                            const T* __restrict__ x,
                                            int row0, int m_rows, int n_rows,
                                            int n_steps, int t, int e, int k0,
                                            int ks) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements of a 16-byte chunk
  // 16-byte chunks a row: 2, 4 or 8
  const int shift = ks == 2 * kPer ? 1 : ks == 4 * kPer ? 2 : 3;
  const int total = m_rows << shift;
  const int xs = xslot_stride(ks, (int)sizeof(T));
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int r = idx >> shift;
    const int c = idx - (r << shift);
    const int row = row0 + r;
    const bool valid = row < n_rows;
    const T* src =
        valid ? x + ((size_t)row * n_steps + t) * e + k0 + c * kPer : x;
    cp_async16(dst + r * xs + c * 16, src, valid);
  }
}

// The x step of a unit of the weight ring: t >= 0 streams every slab and
// x_t's columns beside the x slabs; kNoX every slab without x (a single
// block's reverse pass, whose dx reads the W_ih slabs); kHOnly the h slabs
// alone (a cluster's reverse pass: its dx is phase C's product).
constexpr int kNoX = -1;
constexpr int kHOnly = -2;

// The weight ring: slab n of the launch-long stream (slab s of a unit:
// slab s of the staged weights `w`, (E + hk) rows w_stride(hc, gates) bytes
// apart, W_ih over W_hh) lives in slot n % kStages, behind kRingHeader
// bytes that hold the slots' mbarriers; an x slab's columns of x_t live in
// x slot n % kStages.  A unit of the stream is one pass over the slabs
// first_slab(t) .. n_slabs - 1 (a time step of the forward, the recompute
// or the reverse pass), t its x step as above.  `acquire(n, s, t_cur,
// t_next)` -- s the slab of slab n in its unit (the caller's loop index: no
// division on the hot path), t_cur the x step of slab n's unit, t_next that
// of the unit after it -- waits for slab n (its k-th use of the slot
// completes the barrier's phase of parity k & 1, and its x copies are in
// the cp.async group of slab n), frees the slots of slab n - 1 (one
// __syncthreads: every warp is done reading them) and issues slab
// n + kStages - 1 with its x columns.  The caller may add cp.async copies of
// its own and then calls cp_async_commit() exactly once per acquire.
// T: the element type of the staged weights and x (bf16, or float32 for
// the split-TF32 tiles).
template <typename T>
struct WeightRingT {
  char* base;
  char* xbase;
  uint64_t* full;
  const char* w;
  const T* x;
  // h streamed beside the h slabs as x is beside the x slabs, from a
  // row-major [rows, hk] bf16 buffer (the step route); null: h is a staged
  // tile the caller reads
  const T* hx;
  int e, hk, ws, ks, n_slabs, slab_bytes, xslot_bytes;
  int row0, m_rows, n_rows, n_steps;
  int total;

  // every thread of the block calls this (it ends in a __syncthreads);
  // the launch streams `units` units of every slab and `h_units` of the h
  // slabs alone
  __device__ __forceinline__ void init(char* smem, const T* staged,
                                       const T* x_, int e_, int hk_,
                                       int hc, int gates, int ks_,
                                       int units, int row0_,
                                       int m_rows_, int n_rows_,
                                       int n_steps_, int h_units = 0) {
    full = reinterpret_cast<uint64_t*>(smem);
    base = smem + kRingHeader;
    w = reinterpret_cast<const char*>(staged);
    x = x_;
    hx = nullptr;
    e = e_;
    hk = hk_;
    ws = w_stride(hc, gates, (int)sizeof(T));
    ks = ks_;
    n_slabs = (e + hk) / ks;
    slab_bytes = ks * ws;
    xbase = base + kStages * slab_bytes;
    row0 = row0_;
    m_rows = m_rows_;
    n_rows = n_rows_;
    n_steps = n_steps_;
    xslot_bytes = m_rows * xslot_stride(ks, (int)sizeof(T));
    total = units * n_slabs + h_units * (hk / ks);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // the first slab of a unit of x step t
  __device__ __forceinline__ int first_slab(int t) const {
    return t == kHOnly ? e / ks : 0;
  }
  // the bytes the ring takes: slabs and x slots
  __device__ __forceinline__ char* end() const {
    return xbase + kStages * xslot_bytes;
  }
  __device__ __forceinline__ const char* x_slab(int n) const {
    return xbase + (n % kStages) * xslot_bytes;
  }
  // slab n (slab s of its unit) and, if it is an x slab of a unit with an
  // x step t >= 0, its x columns; every thread calls this
  __device__ __forceinline__ void issue(int n, int s, int t) {
    if (n >= total) return;
    const int slot = n % kStages;
    if (threadIdx.x == 0) {
      mbar_expect_tx(&full[slot], slab_bytes);
      bulk_copy(base + slot * slab_bytes, w + (size_t)s * slab_bytes,
                slab_bytes, &full[slot]);
    }
    const int k0 = s * ks;
    if (k0 < e && t >= 0)
      load_x_slab(xbase + slot * xslot_bytes, x, row0, m_rows, n_rows,
                  n_steps, t, e, k0, ks);
    else if (hx != nullptr && t >= 0)
      load_x_slab(xbase + slot * xslot_bytes, hx, row0, m_rows, n_rows, 1, 0,
                  hk, k0 - e, ks);
  }
  // the first kStages - 1 slabs of the first unit (x step t0), one
  // cp.async commit group each (the caller's own copies issued before this
  // ride in the first).  A unit has at least two slabs (kStages - 1), so
  // they share one unit.
  __device__ __forceinline__ void prologue(int t0) {
    const int s0 = first_slab(t0);
    for (int p = 0; p < kStages - 1; ++p) {
      issue(p, s0 + p, t0);
      cp_async_commit();
    }
  }
  __device__ __forceinline__ const char* acquire(int n, int s, int t_cur,
                                                 int t_next) {
    cp_async_wait<kStages - 2>();
    mbar_wait(&full[n % kStages], (uint32_t)(n / kStages) & 1u);
    __syncthreads();
    // slab n + kStages - 1 lies in this unit or the next (a unit has at
    // least kStages - 1 slabs)
    const int ahead = s + kStages - 1;
    if (ahead < n_slabs)
      issue(n + kStages - 1, ahead, t_cur);
    else
      issue(n + kStages - 1, first_slab(t_next) + ahead - n_slabs, t_next);
    return base + (n % kStages) * slab_bytes;
  }
};

using WeightRing = WeightRingT<bf16>;

// acc[mt][gi][slot] += A[rows of m-tile mt, a_col .. a_col + ks - 1] * slab
// for the warp's unit groups ug0 .. ug0 + G - 1: the gate pre-activations'
// share of one slab.  A is a staged tile (row stride a_stride bytes), ws the
// slab's row stride.  NG = 4: slot q is gate q, two gates a transposed
// `ldmatrix.x4`.  NG = 3 (GRU): r and z (slots 0, 1) by one `ldmatrix.x4`,
// the n tile by an `ldmatrix.x2` into slot 2 (xn) from an x slab, slot 3
// (hn) from an h slab (kHSlab).
template <int NG, int G, int MT, bool kHSlab>
__device__ __forceinline__ void slab_gates(float (&acc)[MT][G][4][4],
                                           const char* a_tile, int a_stride,
                                           int a_col, const char* slab,
                                           int ws, int ks, int h, int ug0,
                                           int lane) {
  static_assert(NG == 3 || NG == 4, "the LSTM's four or the GRU's three");
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_k = lane & 15, b_gate = lane >> 4;
  for (int kk = 0; kk < ks; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], a_tile + (mt * 16 + a_row) * a_stride +
                         (a_col + kk + a_k) * 2);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int u0 = (ug0 + gi) * 8;
      if (u0 < h) {  // warp-uniform
        const char* b_row = slab + (kk + b_k) * ws;
        if constexpr (NG == 4) {
          uint32_t b[2][4];  // b[p]: gates 2p (regs 0, 1) and 2p + 1 (2, 3)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            ldsm_x4_trans(b[p], b_row + ((2 * p + b_gate) * h + u0) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][gi][0], a[mt], b[0][0], b[0][1]);
            mma_bf16(acc[mt][gi][1], a[mt], b[0][2], b[0][3]);
            mma_bf16(acc[mt][gi][2], a[mt], b[1][0], b[1][1]);
            mma_bf16(acc[mt][gi][3], a[mt], b[1][2], b[1][3]);
          }
        } else {
          uint32_t b[4], bn[2];  // r (regs 0, 1), z (2, 3); n
          ldsm_x4_trans(b, b_row + (b_gate * h + u0) * 2);
          ldsm_x2_trans(bn, b_row + (2 * h + u0) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][gi][0], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][gi][1], a[mt], b[2], b[3]);
            mma_bf16(acc[mt][gi][kHSlab ? 3 : 2], a[mt], bn[0], bn[1]);
          }
        }
      }
    }
  }
}

// slab_gates in float32 on split-TF32 tiles (tf32_mma.cuh): the same
// accumulator slots, A (an f32 tile) by `ldmatrix` split as it is loaded,
// the k-major slab's B fragments by two scalar loads a lane (a staged row
// of gates * h + 8 floats), k steps of 8.
template <int NG, int G, int MT, bool kHSlab>
__device__ __forceinline__ void slab_gates_tf32(float (&acc)[MT][G][4][4],
                                                const char* a_tile,
                                                int a_stride, int a_col,
                                                const char* slab, int ws,
                                                int ks, int h, int ug0,
                                                int lane) {
  static_assert(NG == 3 || NG == 4, "the LSTM's four or the GRU's three");
  const int a_row = lane & 15, a_k = (lane >> 4) * 4;
  const int g = lane >> 2, tg = lane & 3;
  for (int kk = 0; kk < ks; kk += 8) {
    tf32::AFrag a[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t raw[4];
      ldsm_x4(raw, a_tile + (mt * 16 + a_row) * a_stride +
                       (a_col + kk + a_k) * 4);
      tf32::split_a(a[mt], raw);
    }
    const float* b0 = reinterpret_cast<const float*>(slab + (kk + tg) * ws);
    const float* b1 = reinterpret_cast<const float*>(slab + (kk + tg + 4) * ws);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int u0 = (ug0 + gi) * 8;
      if (u0 < h) {  // warp-uniform
        tf32::BFrag b[NG];
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int col = q * h + u0 + g;
          b[q] = tf32::split_b(b0[col], b1[col]);
        }
        // an accumulator's three terms in their order, its neighbours'
        // between them (no two dependent mma back to back)
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int q = 0; q < NG; ++q) {
            const int slot = NG == 3 && q == 2 && kHSlab ? 3 : q;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              tf32::mma_term(acc[mt][gi][slot], a[mt], b[q], term);
          }
      }
    }
  }
}

// The backwards' reverse product of one warp tile in float32: o[j] (n-tile
// j of two; one of an 8-row slab) = the k steps kk in [k_lo, k_hi) of A at
// column ka(kk) -- a staged f32 tile, rows a_base -- times B, the slab's
// rows read untransposed at b_base.  Each k step adds lo*hi and hi*lo into
// a small-term accumulator and hi*hi into its own, even and odd k steps
// apart, so no chain of dependent `mma`s is longer than a third of the
// steps; o = (small_even + small_odd) + (big_even + big_odd), a fixed order.
template <typename KA>
__device__ __forceinline__ void tf32_rev_product(float (&o)[2][4],
                                                 const char* a_base,
                                                 const char* b_base, int k_lo,
                                                 int k_hi, bool one, KA ka) {
  float sm[2][2][4], bg[2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sm[p][j][i] = bg[p][j][i] = 0.0f;
  auto step = [&](int kk, float (&s)[2][4], float (&b)[2][4]) {
    uint32_t raw[4];
    tf32::AFrag af;
    ldsm_x4(raw, a_base + ka(kk) * 4);
    tf32::split_a(af, raw);
    tf32::BFrag bf[2];
    if (one) {
      uint32_t r2[2];
      ldsm_x2(r2, b_base + kk * 4);
      bf[0] = tf32::split_b(__uint_as_float(r2[0]), __uint_as_float(r2[1]));
    } else {
      uint32_t r4[4];
      ldsm_x4(r4, b_base + kk * 4);
      bf[0] = tf32::split_b(__uint_as_float(r4[0]), __uint_as_float(r4[1]));
      bf[1] = tf32::split_b(__uint_as_float(r4[2]), __uint_as_float(r4[3]));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j == 0 || !one) {
        tf32::mma(s[j], af.lo, bf[j].hi0, bf[j].hi1);
        tf32::mma(b[j], af.hi, bf[j].hi0, bf[j].hi1);
        tf32::mma(s[j], af.hi, bf[j].lo0, bf[j].lo1);
      }
  };
  int kk = k_lo;
  for (; kk + 8 < k_hi; kk += 16) {
    step(kk, sm[0], bg[0]);
    step(kk + 8, sm[1], bg[1]);
  }
  if (kk < k_hi) step(kk, sm[0], bg[0]);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[j][i] = (sm[0][j][i] + sm[1][j][i]) + (bg[0][j][i] + bg[1][j][i]);
}

// All slabs of one step: acc = bias + [x_t | h] @ [W_ih; W_hh] for the
// warp's cells, slot q starting from bias_s[q*hc + unit] (f32; the GRU's
// slots r, z, xn, hn start from b_ih + b_hh, b_ih + b_hh, b_ih_n, b_hh_n).
// `n` is the ring's slab counter (advanced by n_slabs); t_cur / t_next the
// x steps of this unit and the next (WeightRing::acquire).
// `after_first(void)` runs once after the first slab's hand-over (the
// caller's copies), before its commit; `before_h(void)` once after the first
// h slab's hand-over, before the h tile is read (a cluster's wait for the
// other ranks' h).
template <int NG, int G, int MT, typename T, typename F, typename FH>
__device__ __forceinline__ void step_gates(float (&acc)[MT][G][4][4],
                                           WeightRingT<T>& ring, int& n,
                                           int t_cur, int t_next,
                                           const char* h_tile,
                                           const float* bias_s, int hc,
                                           int ug0, int lane, F after_first,
                                           FH before_h) {
  const int e = ring.e, ks = ring.ks;
  const int tg = lane & 3;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int u = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float b0 = u < hc ? bias_s[q * hc + u] : 0.0f;
      const float b1 = u < hc ? bias_s[q * hc + u + 1] : 0.0f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][gi][q][0] = b0;
        acc[mt][gi][q][1] = b1;
        acc[mt][gi][q][2] = b0;
        acc[mt][gi][q][3] = b1;
      }
    }
  }
  for (int s = 0; s < ring.n_slabs; ++s, ++n) {
    const char* slab = ring.acquire(n, s, t_cur, t_next);
    if (s == 0) after_first();
    cp_async_commit();
    const int k0 = s * ks;
    constexpr int kE = (int)sizeof(T);
    if constexpr (kE == 4) {
      if (k0 < e) {
        slab_gates_tf32<NG, G, MT, false>(acc, ring.x_slab(n),
                                          xslot_stride(ks, kE), 0, slab,
                                          ring.ws, ks, hc, ug0, lane);
      } else {
        if (k0 == e) before_h();
        slab_gates_tf32<NG, G, MT, true>(acc, h_tile, h_stride(ring.hk, kE),
                                         k0 - e, slab, ring.ws, ks, hc, ug0,
                                         lane);
      }
    } else if (k0 < e) {
      slab_gates<NG, G, MT, false>(acc, ring.x_slab(n), xslot_stride(ks), 0,
                                   slab, ring.ws, ks, hc, ug0, lane);
    } else {
      if (k0 == e) before_h();
      slab_gates<NG, G, MT, true>(acc, h_tile, h_stride(ring.hk), k0 - e,
                                  slab, ring.ws, ks, hc, ug0, lane);
    }
  }
}

// a no-op hook of step_gates
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

}  // namespace tiles

// Launch `kernel` on n_blocks row blocks of `c` blocks each (a cluster
// when c > 1).
template <typename K, typename... Args>
inline cudaError_t launch_blocks(K kernel, int n_blocks, int c, int threads,
                                 size_t smem, cudaStream_t stream,
                                 Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks * c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace cair_lstm
