// bf16 tensor-core tiles of the recurrent kernels (lstm_fwd.cu,
// lstm_bwd.cu, gru_fwd.cu, gru_bwd.cu): `mma.sync.m16n8k16` (bf16 x bf16, f32
// accumulate) fed by `ldmatrix` from operands staged in shared memory in
// bf16, and the ring of bulk copies that streams the weights.  Everything
// here takes the number of gate column blocks NG: 4 for the LSTM (i, f, g,
// o), 3 for the GRU (r, z, n).
//
// Layout of a row-tile block (8 warps, M = 16 * MT rows):
//
// - [x_t | h] is staged row-major in bf16, one row per sequence, every row
//   padded by 16 bytes so the eight row addresses of an `ldmatrix` fall in
//   eight different bank groups.
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
// E and H are multiples of 32 here (the wrapper zero-pads other sizes; zero
// weights and biases keep padded units at exactly 0) and every pointer is
// 16-byte aligned.

#pragma once

#include "lstm_common.cuh"

namespace cair_lstm {
namespace tiles {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;         // slabs in the weight ring
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kAlign = 32;          // E and H are multiples of this
constexpr int kMaxHidden = 512;
constexpr int kLstmGates = 4;  // gate column blocks of each recurrence
constexpr int kGruGates = 3;

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

// bytes per staged row (16 bytes of padding each)
__host__ __device__ inline int x_stride(int e) { return e * 2 + 16; }
__host__ __device__ inline int h_stride(int h) { return h * 2 + 16; }
__host__ __device__ inline int w_stride(int h, int gates) {
  return h * gates * 2 + 16;
}

// bytes per row of a backward's staged gradient tile: four slots of H
// (the LSTM's four gates; the GRU's da_r, da_z, da_n, da_n * r)
__host__ __device__ inline int slot_stride(int h) { return h * 8 + 16; }
// bytes of the f32 tile through which dh returns to its owning threads
__host__ __device__ inline size_t exch_bytes(int h, int m_rows) {
  return (size_t)m_rows * (h + 8) * 4;
}

// Dynamic shared memory of a row-tile block of m_rows rows with `gates`
// gate blocks, forward or backward phase A, or 0 if no slab depth fits
// (*ks gets the depth: 32 k-rows, else 16): the ring's header and slabs,
// the staged tiles, the bias (four f32 slots of H).  The forward stages two
// x tiles and the h tile; a backward reuses that space for its gradient
// tile (m_rows rows of four slots) and needs the f32 tile that dh returns
// through: the LSTM's kernel 5 keeps it after that union, the GRU's kernel
// 9 inside it, after the gradient tile (the x tiles are idle in the
// reverse pass), so kernel 9 holds every E its forward holds.
// `tile_smem_bytes` in ops/kernels/lstm.py states the same sum.
constexpr int kRingHeader = 64;  // the slots' mbarriers

__host__ __device__ inline size_t staged_bytes(int e, int h, int gates,
                                               int m_rows, bool backward) {
  const size_t fwd =
      2 * (size_t)m_rows * x_stride(e) + (size_t)m_rows * h_stride(h);
  if (!backward) return fwd;
  size_t rev = (size_t)m_rows * slot_stride(h);
  if (gates == kGruGates) rev += exch_bytes(h, m_rows);
  return rev > fwd ? rev : fwd;
}

inline size_t mma_smem(int e, int h, int gates, int m_rows, bool backward,
                       int* ks) {
  for (int depth = 32; depth >= 16; depth /= 2) {
    const size_t bytes =
        kRingHeader + (size_t)kStages * depth * w_stride(h, gates) +
        staged_bytes(e, h, gates, m_rows, backward) +
        (backward && gates == kLstmGates ? exch_bytes(h, m_rows) : 0) +
        16 * h;
    if (bytes <= kSmemLimit) {
      *ks = depth;
      return bytes;
    }
  }
  return 0;
}

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

// x[row0 .. row0 + m_rows - 1, t, :] into `dst` (rows x_stride(e) bytes
// apart); rows past n_rows are zero-filled.
__device__ __forceinline__ void load_x_tile(char* dst,
                                            const bf16* __restrict__ x,
                                            int row0, int m_rows, int n_rows,
                                            int n_steps, int t, int e) {
  const int cpr = e / 8;
  const int total = m_rows * cpr;
  const int xs = x_stride(e);
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int r = idx / cpr;
    const int c = idx - r * cpr;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    const bf16* src =
        valid ? x + ((size_t)row * n_steps + t) * e + c * 8 : x;
    cp_async16(dst + r * xs + c * 16, src, valid);
  }
}

// The weight ring: slab n of the launch-long stream (slab n % n_slabs of the
// staged weights `w`, (E + H) rows w_stride(h, gates) bytes apart, W_ih
// over W_hh)
// lives in slot n % kStages, behind kRingHeader bytes that hold the slots'
// mbarriers.  `acquire(n)` waits for slab n (its k-th use of the slot
// completes the barrier's phase of parity k & 1), frees the slot of slab
// n - 1 (one __syncthreads: every warp is done reading it) and has thread 0
// issue slab n + kStages - 1.  The caller may add cp.async copies of its own
// (the x tile) and then calls cp_async_commit() exactly once per acquire.
struct WeightRing {
  char* base;
  uint64_t* full;
  const char* w;
  int e, h, ws, ks, n_slabs, slab_bytes;
  long long total;

  // every thread of the block calls this (it ends in a __syncthreads)
  __device__ __forceinline__ void init(char* smem, const bf16* staged, int e_,
                                       int h_, int gates, int ks_,
                                       long long units) {
    full = reinterpret_cast<uint64_t*>(smem);
    base = smem + kRingHeader;
    w = reinterpret_cast<const char*>(staged);
    e = e_;
    h = h_;
    ws = w_stride(h, gates);
    ks = ks_;
    n_slabs = (e + h) / ks;
    slab_bytes = ks * ws;
    total = units * n_slabs;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  __device__ __forceinline__ void issue(long long n) {
    if (n < total && threadIdx.x == 0) {
      const int slot = (int)(n % kStages);
      mbar_expect_tx(&full[slot], slab_bytes);
      bulk_copy(base + slot * slab_bytes,
                w + (size_t)(n % n_slabs) * slab_bytes, slab_bytes,
                &full[slot]);
    }
  }
  // slabs 0 .. kStages - 2, one cp.async commit group each (the caller's
  // own copies issued before this ride in the first)
  __device__ __forceinline__ void prologue() {
    for (int p = 0; p < kStages - 1; ++p) {
      issue(p);
      cp_async_commit();
    }
  }
  __device__ __forceinline__ const char* acquire(long long n) {
    cp_async_wait<kStages - 2>();
    mbar_wait(&full[n % kStages], (uint32_t)(n / kStages) & 1u);
    __syncthreads();
    issue(n + kStages - 1);
    return base + (int)(n % kStages) * slab_bytes;
  }
};

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

// All slabs of one step: acc = bias + [x_t | h] @ [W_ih; W_hh] for the
// warp's cells, slot q starting from bias_s[q*H + unit] (f32; the GRU's
// slots r, z, xn, hn start from b_ih + b_hh, b_ih + b_hh, b_ih_n, b_hh_n).
// `n` is the ring's slab counter (advanced by n_slabs); `after_first(void)`
// runs once after the first slab's hand-over (the caller's prefetch of the
// next x tile and other copies), before its commit.
template <int NG, int G, int MT, typename F>
__device__ __forceinline__ void step_gates(float (&acc)[MT][G][4][4],
                                           WeightRing& ring, long long& n,
                                           const char* x_tile,
                                           const char* h_tile,
                                           const float* bias_s, int ug0,
                                           int lane, F after_first) {
  const int e = ring.e, h = ring.h, ks = ring.ks;
  const int tg = lane & 3;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int u = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float b0 = u < h ? bias_s[q * h + u] : 0.0f;
      const float b1 = u < h ? bias_s[q * h + u + 1] : 0.0f;
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
    const char* slab = ring.acquire(n);
    if (s == 0) after_first();
    cp_async_commit();
    const int k0 = s * ks;
    if (k0 < e)
      slab_gates<NG, G, MT, false>(acc, x_tile, x_stride(e), k0, slab,
                                   ring.ws, ks, h, ug0, lane);
    else
      slab_gates<NG, G, MT, true>(acc, h_tile, h_stride(h), k0 - e, slab,
                                  ring.ws, ks, h, ug0, lane);
  }
}

}  // namespace tiles
}  // namespace cair_lstm
