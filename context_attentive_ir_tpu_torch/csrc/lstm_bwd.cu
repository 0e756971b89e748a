// Chunked-rematerialization LSTM backward for Hopper (sm_90a): kernel 5.
//
// Replaces the TPU kernel `_lstm_fused_bwd_kernel` / `_lstm_fused_bwd_impl`
// in context_attentive_ir_tpu/ops/pallas/lstm.py (the backward of the
// `lstm_pallas_fused` custom_vjp).  Given the forward's chunk-boundary state
// (hb, cb from kernel 4, lstm_fwd.cu) and dout = dL/d out, it returns
// dx [B, T, E] and dW_ih, db, dW_hh.  Per time chunk, in reverse processing
// order: recompute the forward inside the chunk from its boundary state,
// then run the cell backward step by step:
//
//   dh' = m * (dout_t + dh);  dc' = m * dc + dh' * o * (1 - tanh(c')^2)
//   dgates = [dc'*g * i(1-i), dc'*c * f(1-f), dc'*i * (1-g^2),
//             dh'*tanh(c') * o(1-o)]                          (f32)
//   dx_t = dgates_c @ W_ih^T;  dh = (1-m) dh + dgates_c @ W_hh^T;
//   dc = (1-m) dc + dc' * f
//   dW_ih += x_t^T dgates_c;  dW_hh += h_prev_c^T dgates_c;  db += sum dgates
//
// with the TPU kernel's rounding: h is rounded to the compute dtype before
// h @ W_hh (in the recompute) and before the dW_hh product; dgates are
// rounded to it (dgates_c) before the dx, dh and dW products; db sums the
// f32 dgates; dW accumulates in f32 and is cast to the weight dtype at the
// end.
//
// What bounds it on the H100, doc encoder [16000, 30, 256] -> 128, one
// direction, bf16: recompute 1.89e11 + dx 1.26e11 + dh 6.3e10 + dW_ih
// 1.26e11 + dW_hh 6.3e10 = 5.66e11 flops, 0.572 ms at 989 TFLOP/s, against
// ~0.70 GB of x, dout, dx and boundary traffic (0.21 ms): bound by
// operations, which only the tensor cores deliver.
//
// The TPU accumulates dW in one VMEM-resident output block across a
// sequential grid; on Hopper blocks run in parallel and nothing carries
// between them, and dW_ih alone (256 x 512 f32 = 512 KB) exceeds a block's
// shared memory.  So the work is split:
//
// - Phase A walks the chunks in reverse, recomputes each one from (hb, cb)
//   and runs the cell backward; it writes dx, and dgates_c and h_prev_c per
//   (row, step) to a workspace for phase B, and a per-block partial db.
// - Phase B (lstm_common.cuh, shared with the GRU backward): dW_ih = X^T G
//   and dW_hh = Hp^T G over all B*T (row, step) pairs, split over up to 32
//   row ranges to fill the card; sum_partials_kernel then adds the splits
//   (and the per-block db partials) in a fixed order.
//
// No atomics and a fixed instruction order: the gradients are the same bits
// from run to run.
//
// Design, bfloat16 (lstm_bwd_mma_kernel; lstm_mma.cuh's tiles): a block of
// 8 warps owns M = 64 rows (32 or 16 for H above 128 or 256).  The recompute
// is kernel 1's step (the same device functions), and it keeps i, f, g, o
// and c_prev of each cell -- five f32 planes; c_new = f*c_prev + i*g is
// recomputed -- in a global workspace written and read back by the owning
// thread as whole float4 fragments, consecutive threads on consecutive 16
// bytes.  In the reverse pass a thread computes the four dgates of its
// cells from registers, rounds them to bf16 into a staged [M x 4H] tile
// (which takes the place of the [x | h] tiles of the recompute), and the
// products dx_t = dgates_c @ W_ih^T and dh = dgates_c @ W_hh^T are
// `mma.sync.m16n8k16` tiles against the same weight slabs the forward
// streams (bulk copies of the staged weights), read untransposed by
// `ldmatrix` (a slab's rows are the
// product's output columns): no transposed copy of the weights exists.  dh
// returns to the owning threads through a small f32 tile in shared memory;
// the staged dgates tile and the h tile are copied to the workspace for
// phase B with 16-byte coalesced stores.  Phase B is tensor-core tiles too
// (wgrad_partial_mma_kernel).  E and H are multiples of 32 here: the
// wrapper zero-pads other sizes.  Above H = 384 a cluster of 2 or 4 blocks
// of 16 rows shares the gate columns (lstm_mma.cuh): the recompute is
// kernel 1's clustered step; in the reverse pass a block's dgates are those
// of its units, so dgates_c @ W_hh^T is a partial of every unit's dh: each
// block sends the partials of rank r's units into rank r's tile of
// partials (distributed shared memory), and rank r adds them in rank order
// (the same bits every run); the reverse pass streams the h slabs alone,
// and dx = dgates_c @ W_ih^T over all B*T rows is one tensor-core product
// after phase A (phase C, launch_matmul: phase B's tile kernel with dgates
// read m-major).  Across each recompute the reverse pass's dh, dc and db
// sums wait in the workspace, so the recompute's accumulators keep their
// registers.
//
// float32 keeps exact f32 FMAs (no TF32) on the first version's layout
// (lstm_bwd_cell_kernel: one block per 32 rows, thread (rg, j) owning unit
// j of 16 rows, six activation planes, host-made transposes of the weights
// for the dx and dh products, x staged in chunks of kF32Chunk k-rows) and
// wgrad_partial_kernel; above H = 403 its units split over a cluster of up
// to 8 blocks by the same scheme (dh's partials in rank order, dx in phase
// C by exact f32 FMAs).
//
// Above H = 1,024, in both dtypes, phase A takes the step route
// (lstm_step.cu: the recompute a launch a step, the reverse pass two, with
// each unit tile's dh partial added in tile order), and phases B and C run
// as for a cluster: any H the JAX kernel takes.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"
#include "lstm_step.cuh"

namespace {

using namespace cair_lstm;

constexpr int kSaved = 6;  // per step: i, f, g, o, c_prev, c_new

// kBound: the launch bound (row_tile_bound).  A block has 2 * hc threads and
// owns units rank*hc .. rank*hc + hc - 1 of a cluster of ceil(H / hc) blocks
// (kCl; else hc = H: one block).  Shared memory, recompute: h of all H units
// [H][kStride] | the x chunk; reverse pass: the block's dgates
// [4 hc][kStride] | in a cluster, the dh partials of its units from every
// rank [C][hc][kStride].
template <typename T, int kBound, bool kCl>
__global__ void __launch_bounds__(kBound)
lstm_bwd_cell_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                     const T* __restrict__ w_ih, const T* __restrict__ bias,
                     const T* __restrict__ w_hh, const T* __restrict__ w_ih_t,
                     const T* __restrict__ w_hh_t, const float* __restrict__ hb,
                     const float* __restrict__ cb, const T* __restrict__ dout,
                     T* __restrict__ dx, T* __restrict__ dgates_ws,
                     T* __restrict__ h_prev_ws, float* __restrict__ act,
                     float* __restrict__ db_part, int n_rows, int n_steps,
                     int e, int h_dim, int reverse, int tc, int hc) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float* ht = tile;
  float* xt = tile + (size_t)h_dim * kStride;
  float* exch = tile + (size_t)4 * hc * kStride;

  constexpr bool cl = kCl;
  const int n_ranks = cl ? (int)tiles::cluster_size() : 1;
  const int rank = cl ? (int)tiles::cluster_rank() : 0;
  const int j = threadIdx.x % hc;
  const int rg = threadIdx.x / hc;
  const int unit = rank * hc + j;
  const bool active = !cl || unit < h_dim;
  const int own = min(hc, h_dim - rank * hc);  // the block's real units
  const int row0 = (blockIdx.x / n_ranks) * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;
  const int g4 = 4 * h_dim;
  const int n_chunks = (n_steps + tc - 1) / tc;
  const size_t act_step = (size_t)kSaved * kRows * hc;
  const size_t plane = (size_t)kRows * hc;
  float* my_act = act + (size_t)blockIdx.x * tc * act_step;

  float bg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    bg[g] = active ? to_f32(bias[g * h_dim + unit]) : 0.0f;
  float dh[kRowsPerThread], dc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    dh[i] = 0.0f;
    dc[i] = 0.0f;
  }
  float dbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int q = 0; q < n_chunks; ++q) {
    // chunks in the reverse of the forward's processing order
    const int chunk = reverse ? q : n_chunks - 1 - q;
    const int t_lo = chunk * tc;
    const int len = min(tc, n_steps - t_lo);

    // --- recompute the forward inside the chunk from its boundary -------
    __syncthreads();  // the last reverse step is done with the tile
    float h[kRowsPerThread], c[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      const size_t at = ((size_t)chunk * n_rows + row) * h_dim + unit;
      h[i] = active && row < n_rows ? hb[at] : 0.0f;
      c[i] = active && row < n_rows ? cb[at] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < kRows * h_dim; idx += blockDim.x) {
      const int r = idx / h_dim;
      const int u = idx - r * h_dim;
      const int row = row0 + r;
      ht[(size_t)u * kStride + r] =
          row < n_rows
              ? round_to<T>(hb[((size_t)chunk * n_rows + row) * h_dim + u])
              : 0.0f;
    }
    // the tile is whole; in a cluster, every rank is done with its reverse
    // pass (the other ranks' h writes below land in the same space)
    f32_sync(cl);
    for (int k = 0; k < len; ++k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      float acc[4][kRowsPerThread];
      gate_preacts<T>(acc, xt, ht, x, w_ih, w_hh, bg, row0, n_rows, n_steps,
                      t, e, h_dim, unit, rg, active);
      f32_sync(cl);  // every block of the cluster is done reading its h tile
      float* a_k = my_act + k * act_step;
      float hr[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = my_row0 + i;
        if (active && row < n_rows) {
          const size_t pos = (size_t)row * n_steps + t;
          const float ig = sigmoid_f32(acc[0][i]);
          const float fg = sigmoid_f32(acc[1][i]);
          const float gg = tanhf(acc[2][i]);
          const float og = sigmoid_f32(acc[3][i]);
          const float c_new = fg * c[i] + ig * gg;
          const float h_new = og * tanhf(c_new);
          h_prev_ws[pos * h_dim + unit] = from_f32<T>(h[i]);
          const size_t r = (size_t)(rg * kRowsPerThread + i) * hc + j;
          a_k[r] = ig;
          a_k[plane + r] = fg;
          a_k[2 * plane + r] = gg;
          a_k[3 * plane + r] = og;
          a_k[4 * plane + r] = c[i];
          a_k[5 * plane + r] = c_new;
          if (mask[pos] != 0) {
            h[i] = h_new;
            c[i] = c_new;
          }
        }
        hr[i] = round_to<T>(h[i]);
      }
      if (active) store_rows_all(ht, unit, rg, hr, cl ? n_ranks : 0);
      // the h tiles are whole (a single block: the next step's x staging
      // ends in a __syncthreads before h is read; after the last step the
      // reverse pass's dgates take the tile's place)
      if (cl || k + 1 == len) f32_sync(cl);
    }

    // --- reverse pass over the chunk --------------------------------------
    for (int k = len - 1; k >= 0; --k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      const float* a_k = my_act + k * act_step;
      float dg[4][kRowsPerThread];
      uint32_t valid = 0;  // bit i: row i is real and step t unmasked
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = my_row0 + i;
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
        if (active && row < n_rows) {
          const size_t pos = (size_t)row * n_steps + t;
          if (mask[pos] != 0) {
            valid |= 1u << i;
            const size_t r = (size_t)(rg * kRowsPerThread + i) * hc + j;
            const float ig = a_k[r];
            const float fg = a_k[plane + r];
            const float gg = a_k[2 * plane + r];
            const float og = a_k[3 * plane + r];
            const float c_prev = a_k[4 * plane + r];
            const float c_new = a_k[5 * plane + r];
            const float dh_new = to_f32(dout[pos * h_dim + unit]) + dh[i];
            const float tanh_c = tanhf(c_new);
            const float do_ = dh_new * tanh_c;
            const float dcn = dc[i] + dh_new * og * (1.0f - tanh_c * tanh_c);
            d0 = dcn * gg * ig * (1.0f - ig);
            d1 = dcn * c_prev * fg * (1.0f - fg);
            d2 = dcn * ig * (1.0f - gg * gg);
            d3 = do_ * og * (1.0f - og);
            dc[i] = dcn * fg;
          }
          T* dst = dgates_ws + pos * g4 + unit;
          dst[0] = from_f32<T>(d0);
          dst[h_dim] = from_f32<T>(d1);
          dst[2 * h_dim] = from_f32<T>(d2);
          dst[3 * h_dim] = from_f32<T>(d3);
        }
        dg[0][i] = d0;
        dg[1][i] = d1;
        dg[2][i] = d2;
        dg[3][i] = d3;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float v[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          dbs[g] += dg[g][i];
          v[i] = round_to<T>(dg[g][i]);
        }
        store_rows(tile, g * hc + j, rg, v);
      }
      // the dgates tile is whole; in a cluster, every rank is done reading
      // its dh partials of the step before
      f32_sync(cl);

      if constexpr (!cl) {
        // dh = (1 - m) dh + dgates_c @ W_hh^T (the product is 0 where m = 0)
        {
          float acc[1][kRowsPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) acc[0][i] = 0.0f;
          dot_rows<1, T>(acc, tile, 0, rg, w_hh_t + j, g4, h_dim, 0);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            if (valid & (1u << i)) dh[i] = acc[0][i];
        }
        // dx_t = dgates_c @ W_ih^T, columns j, j + H, ...
        for (int col = j; col < e; col += h_dim) {
          float acc[1][kRowsPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) acc[0][i] = 0.0f;
          dot_rows<1, T>(acc, tile, 0, rg, w_ih_t + col, g4, e, 0);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const int row = my_row0 + i;
            if (row < n_rows)
              dx[((size_t)row * n_steps + t) * e + col] =
                  from_f32<T>(acc[0][i]);
          }
        }
      } else {
        // the block's share of dh = dgates_c @ W_hh^T for every unit: unit
        // m*hc + j goes to rank m's tile of partials, row rank*hc + j; dx is
        // phase C's product
        for (int m = 0; m < n_ranks; ++m) {
          const int u = m * hc + j;
          if (u >= h_dim) continue;
          float acc[1][kRowsPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) acc[0][i] = 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            dot_rows<1, T>(acc, tile, g * hc, rg,
                           w_hh_t + ((size_t)g * h_dim + rank * hc) * h_dim + u,
                           own, h_dim, 0);
          const uint32_t a = tiles::map_rank(
              exch + (size_t)(rank * hc + j) * kStride + rg * kRowsPerThread,
              m);
#pragma unroll
          for (int p = 0; p < kRowsPerThread / 4; ++p)
            tiles::st_cluster_f4(a + 16 * p,
                                 make_float4(acc[0][4 * p], acc[0][4 * p + 1],
                                             acc[0][4 * p + 2],
                                             acc[0][4 * p + 3]));
        }
        f32_sync(cl);  // every partial of the block's units has arrived
        // the partials added in rank order
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (valid & (1u << i)) {
            float v = 0.0f;
            for (int src = 0; src < n_ranks; ++src)
              v += exch[(size_t)(src * hc + j) * kStride + rg * kRowsPerThread +
                        i];
            dh[i] = v;
          }
        }
      }
      __syncthreads();  // the next step overwrites the staged dgates
    }
  }

  // per-block db: the two row groups' sums, in a fixed order
  const int gc = 4 * hc;
#pragma unroll
  for (int g = 0; g < 4; ++g) tile[rg * gc + g * hc + j] = dbs[g];
  __syncthreads();
  if (rg == 0 && active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = g * hc + j;
      db_part[(size_t)(blockIdx.x / n_ranks) * g4 + g * h_dim + unit] =
          tile[col] + tile[gc + col];
    }
  }
}

// Phase A on bf16 tensor cores (see the header note).  Shared memory:
// weight ring (mbarriers, slabs, x slots) | union of {h tile (two in a
// cluster, kCl)} (recompute) and {dgates tile; in a cluster, the dh
// partials of the block's units from every rank, [C][M][hc + 8] f32}
// (reverse pass) | a single block's dh exchange (f32, rows h + 8 floats
// apart) | bias of the block's units.  In a cluster the reverse pass
// computes no dx (phase C's product) and streams the h slabs alone.
//
// The reverse pass's carried state -- dh, dc and the db sums, 8 MT G + 8 G
// floats a thread -- waits out each recompute in the block's park area of
// the workspace (kPark float4 a thread, stored and loaded once a chunk), so
// the recompute holds only its accumulators and c in registers.
constexpr int kPlanes = 5;  // per cell and step: i, f, g, o, c_prev

// float4 a thread: dh, dc [MT][G][4]; dbs [G][4][2]
__host__ __device__ constexpr int park_slots(int g, int mt) {
  return 2 * mt * g + 2 * g;
}

template <int G, int MT, bool kCl>
__global__ void __launch_bounds__(tiles::kThreads, 1)
lstm_bwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ w_staged,
                    const __nv_bfloat16* __restrict__ bias,
                    const float* __restrict__ hb, const float* __restrict__ cb,
                    const __nv_bfloat16* __restrict__ dout,
                    __nv_bfloat16* __restrict__ dx,
                    __nv_bfloat16* __restrict__ dgates_ws,
                    __nv_bfloat16* __restrict__ h_prev_ws,
                    float4* __restrict__ act, float* __restrict__ db_part,
                    int n_rows, int n_steps, int e, int h_dim, int reverse,
                    int tc, int ks) {
  using namespace tiles;
  extern __shared__ __align__(16) char smem[];
  constexpr int M = 16 * MT;
  const int n_ranks = kCl ? (int)cluster_size() : 1;
  const int rank = kCl ? (int)cluster_rank() : 0;
  const int hc = h_dim / n_ranks, u_off = rank * hc;
  const int hs = h_stride(h_dim);
  const int ws = w_stride(hc, kLstmGates);
  const int g4 = 4 * h_dim, gc = 4 * hc;
  const int ex_ld = (kCl ? hc : h_dim) + 8;  // floats per row of dh's tile
  const int row0 = (blockIdx.x / n_ranks) * M;
  // a cluster's reverse pass streams the h slabs alone (kHOnly)
  constexpr int kRev = kCl ? kHOnly : kNoX;
  WeightRing ring;
  ring.init(smem, w_staged + (size_t)rank * (e + h_dim) * (ws / 2), x, e,
            h_dim, hc, kLstmGates, ks, kCl ? n_steps : 2 * n_steps, row0, M,
            n_rows, n_steps, kCl ? n_steps : 0);
  char* uni = ring.end();
  char* h_buf[2];
  h_buf[0] = uni;
  h_buf[1] = uni + (kCl ? M * hs : 0);
  char* dg_tile = uni;
  const size_t staged =
      staged_bytes(h_dim, hc, kLstmGates, M, true, n_ranks);
  float* exch = reinterpret_cast<float*>(
      kCl ? uni + M * slot_stride(hc) : uni + staged);
  float* bias_s = reinterpret_cast<float*>(
      uni + staged + (kCl ? 0 : exch_bytes(h_dim, M)));
  uint32_t exch_at[4] = {0, 0, 0, 0};  // exch in each rank of the cluster
  if constexpr (kCl)
    for (int q = 0; q < n_ranks; ++q) exch_at[q] = map_rank(exch, q);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;
  const int n_chunks = (n_steps + tc - 1) / tc;
  // the block's activation planes, [tc][MT * G * kPlanes][kThreads] float4,
  // then its park area [kPark][kThreads] float4
  constexpr int kSlots = MT * G * kPlanes;
  constexpr int kPark = park_slots(G, MT);
  float4* my_act = act +
                   (size_t)blockIdx.x * (tc * kSlots + kPark) * kThreads +
                   threadIdx.x;
  float4* park = my_act + (size_t)tc * kSlots * kThreads;

  for (int i = threadIdx.x; i < gc; i += kThreads)
    bias_s[i] = __bfloat162float(bias[(i / hc) * h_dim + u_off + i % hc]);

  // the reverse pass's carried state (defined anew at each reverse pass:
  // zeros, or what the last one parked)
  float dh[MT][G][4], dc[MT][G][4], dbs[G][4][2];

  unsigned live = 0;  // bit mt*2 + half: row mt*16 + g + half*8 is real
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (row0 + mt * 16 + g + half * 8 < n_rows) live |= 1u << (mt * 2 + half);

  // the x step of chunk q's first recompute step (-1 past the last chunk)
  auto first_t = [&](int q) {
    if (q >= n_chunks) return -1;
    const int chunk = reverse ? q : n_chunks - 1 - q;
    const int t_lo = chunk * tc;
    return reverse ? t_lo + min(tc, n_steps - t_lo) - 1 : t_lo;
  };
  ring.prologue(first_t(0));
  int n = 0;

  for (int q = 0; q < n_chunks; ++q) {
    // chunks in the reverse of the forward's processing order
    const int chunk = reverse ? q : n_chunks - 1 - q;
    const int t_lo = chunk * tc;
    const int len = min(tc, n_steps - t_lo);

    // --- recompute the forward inside the chunk from its boundary -------
    __syncthreads();  // the last reverse step is done with the union
    float c[MT][G][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int unit = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2 cv = make_float2(0.0f, 0.0f);
          if (unit < hc && (live >> (mt * 2 + half) & 1u))
            cv = *reinterpret_cast<const float2*>(
                cb + ((size_t)chunk * n_rows + row0 + mt * 16 + g +
                      half * 8) * h_dim + u_off + unit);
          c[mt][gi][half * 2] = cv.x;
          c[mt][gi][half * 2 + 1] = cv.y;
        }
      }
    // h of every unit, rounded (rows past n_rows: 0)
    for (int idx = threadIdx.x; idx < M * (h_dim / 2); idx += kThreads) {
      const int r = idx / (h_dim / 2);
      const int u = (idx - r * (h_dim / 2)) * 2;
      float2 hv = make_float2(0.0f, 0.0f);
      if (row0 + r < n_rows)
        hv = *reinterpret_cast<const float2*>(
            hb + ((size_t)chunk * n_rows + row0 + r) * h_dim + u);
      *reinterpret_cast<bf162*>(h_buf[0] + r * hs + u * 2) =
          __floats2bfloat162_rn(hv.x, hv.y);
    }
    // a cluster: every rank is done with its reverse pass before the other
    // ranks' h lands in the union (a single block: the first slab's
    // hand-over orders the tile)
    if constexpr (kCl) cluster_sync();

    for (int k = 0; k < len; ++k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      unsigned mb = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          if ((live >> (mt * 2 + half) & 1u) &&
              mask[(size_t)(row0 + mt * 16 + g + half * 8) * n_steps + t] != 0)
            mb |= 1u << (mt * 2 + half);

      const char* h_cur = h_buf[kCl ? (k & 1) : 0];
      const int t_next = k + 1 < len ? (reverse ? t - 1 : t + 1) : kRev;
      float acc[MT][G][4][4];
      step_gates<kLstmGates, G, MT>(
          acc, ring, n, t, t_next, h_cur, bias_s, hc, ug0, lane, NoHook(),
          [&]() {
            if (kCl && k > 0) cluster_wait();  // the other ranks' h
            // h before this step, rounded, of the block's units: phase B's
            // operand for dW_hh
            const int cpr = hc / 8;
            for (int idx = threadIdx.x; idx < M * cpr; idx += kThreads) {
              const int r = idx / cpr, cc = idx - r * cpr;
              if (row0 + r < n_rows)
                *reinterpret_cast<uint4*>(
                    h_prev_ws + ((size_t)(row0 + r) * n_steps + t) * h_dim +
                    u_off + cc * 8) =
                    *reinterpret_cast<const uint4*>(h_cur + r * hs +
                                                    (u_off + cc * 8) * 2);
            }
          });
      // a single block rewrites its h tile in place: every warp must have
      // read it; a cluster writes the other tile
      if constexpr (!kCl) __syncthreads();
      const bool send = kCl && k + 1 < len;
      uint32_t dst[4] = {0, 0, 0, 0};  // the next h tile in each rank
      if (send)
        for (int p = 0; p < n_ranks; ++p)
          dst[p] = map_rank(h_buf[(k + 1) & 1], p);

      float4* a_k = my_act + (size_t)k * kSlots * kThreads;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int unit = (ug0 + gi) * 8 + 2 * tg;
          if (unit < hc) {
            float pl[kPlanes][4], hn[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float ig = sigmoid_f32(acc[mt][gi][0][i]);
              const float fg = sigmoid_f32(acc[mt][gi][1][i]);
              const float gg = tanhf(acc[mt][gi][2][i]);
              const float og = sigmoid_f32(acc[mt][gi][3][i]);
              pl[0][i] = ig;
              pl[1][i] = fg;
              pl[2][i] = gg;
              pl[3][i] = og;
              pl[4][i] = c[mt][gi][i];
              const float c_new = fg * c[mt][gi][i] + ig * gg;
              if (mb >> (mt * 2 + (i >> 1)) & 1u) c[mt][gi][i] = c_new;
              hn[i] = og * tanhf(c_new);
            }
#pragma unroll
            for (int p = 0; p < kPlanes; ++p)
              a_k[((mt * G + gi) * kPlanes + p) * kThreads] =
                  make_float4(pl[p][0], pl[p][1], pl[p][2], pl[p][3]);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const bool m = mb >> (mt * 2 + half) & 1u;
              const int r = mt * 16 + g + half * 8;
              const int col = u_off + unit;
              const bf162 v =
                  __floats2bfloat162_rn(hn[half * 2], hn[half * 2 + 1]);
              if constexpr (kCl) {
                if (send) {
                  const bf162 keep =
                      m ? v
                        : *reinterpret_cast<const bf162*>(h_cur + r * hs +
                                                          col * 2);
                  const uint32_t bits =
                      *reinterpret_cast<const uint32_t*>(&keep);
                  for (int p = 0; p < n_ranks; ++p)
                    st_cluster_b32(dst[p] + r * hs + col * 2, bits);
                }
              } else if (m) {
                *reinterpret_cast<bf162*>(h_buf[0] + r * hs + col * 2) = v;
              }
            }
          }
        }
      if (send) cluster_arrive();
    }
    __syncthreads();  // the recompute's tiles give way to the dgates tile

    // --- reverse pass over the chunk --------------------------------------
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
        if (q > 0) {
          a = ld_global_f4(park + (size_t)(mt * G + gi) * kThreads);
          b = ld_global_f4(park + (size_t)((MT + mt) * G + gi) * kThreads);
        }
        f4_to(dh[mt][gi], a);
        f4_to(dc[mt][gi], b);
      }
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q > 0)
          v = ld_global_f4(park + (size_t)(2 * MT * G + 2 * gi + p) * kThreads);
        dbs[gi][2 * p][0] = v.x;
        dbs[gi][2 * p][1] = v.y;
        dbs[gi][2 * p + 1][0] = v.z;
        dbs[gi][2 * p + 1][1] = v.w;
      }

    for (int k = len - 1; k >= 0; --k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      // the unit after this one: another reverse step, or the next chunk's
      // first recompute step
      const int t_next = k > 0 ? kRev : first_t(q + 1);
      unsigned mb = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          if ((live >> (mt * 2 + half) & 1u) &&
              mask[(size_t)(row0 + mt * 16 + g + half * 8) * n_steps + t] != 0)
            mb |= 1u << (mt * 2 + half);

      const float4* a_k = my_act + (size_t)k * kSlots * kThreads;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int unit = (ug0 + gi) * 8 + 2 * tg;
          if (unit < hc) {
            float d[4][4];  // [gate][cell]
#pragma unroll
            for (int qq = 0; qq < 4; ++qq)
#pragma unroll
              for (int i = 0; i < 4; ++i) d[qq][i] = 0.0f;
            if (mb >> (mt * 2) & 3u) {
              float pl[kPlanes][4];
#pragma unroll
              for (int p = 0; p < kPlanes; ++p) {
                const float4 v = a_k[((mt * G + gi) * kPlanes + p) * kThreads];
                pl[p][0] = v.x;
                pl[p][1] = v.y;
                pl[p][2] = v.z;
                pl[p][3] = v.w;
              }
#pragma unroll
              for (int half = 0; half < 2; ++half)
                if (mb >> (mt * 2 + half) & 1u) {
                  const int r = mt * 16 + g + half * 8;
                  const float2 dov = __bfloat1622float2(
                      *reinterpret_cast<const bf162*>(
                          dout + ((size_t)(row0 + r) * n_steps + t) * h_dim +
                          u_off + unit));
#pragma unroll
                  for (int u = 0; u < 2; ++u) {
                    const int i = half * 2 + u;
                    const float ig = pl[0][i], fg = pl[1][i], gg = pl[2][i];
                    const float og = pl[3][i], c_prev = pl[4][i];
                    const float tanh_c = tanhf(fg * c_prev + ig * gg);
                    const float dh_new = (u ? dov.y : dov.x) + dh[mt][gi][i];
                    const float do_ = dh_new * tanh_c;
                    const float dcn =
                        dc[mt][gi][i] + dh_new * og * (1.0f - tanh_c * tanh_c);
                    d[0][i] = dcn * gg * ig * (1.0f - ig);
                    d[1][i] = dcn * c_prev * fg * (1.0f - fg);
                    d[2][i] = dcn * ig * (1.0f - gg * gg);
                    d[3][i] = do_ * og * (1.0f - og);
                    dc[mt][gi][i] = dcn * fg;
                  }
                }
            }
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              dbs[gi][qq][0] += d[qq][0] + d[qq][2];
              dbs[gi][qq][1] += d[qq][1] + d[qq][3];
#pragma unroll
              for (int half = 0; half < 2; ++half)
                *reinterpret_cast<bf162*>(dg_tile +
                                          (mt * 16 + g + half * 8) * ws +
                                          (qq * hc + unit) * 2) =
                    __floats2bfloat162_rn(d[qq][half * 2], d[qq][half * 2 + 1]);
            }
          }
        }
      __syncthreads();  // the dgates tile is whole

      // dgates_c of (row, t) for phase B: a single block's rows are whole
      // rows of the workspace; a rank's are its columns of each gate
      if constexpr (kCl) {
        const int cpr = hc / 8;
        for (int idx = threadIdx.x; idx < M * 4 * cpr; idx += kThreads) {
          const int r = idx / (4 * cpr), rest = idx - r * 4 * cpr;
          const int qq = rest / cpr, cc = rest - qq * cpr;
          if (row0 + r < n_rows)
            *reinterpret_cast<uint4*>(
                dgates_ws + ((size_t)(row0 + r) * n_steps + t) * g4 +
                qq * h_dim + u_off + cc * 8) =
                *reinterpret_cast<const uint4*>(dg_tile + r * ws +
                                                (qq * hc + cc * 8) * 2);
        }
      } else {
        const int cpr = g4 / 8;
        for (int idx = threadIdx.x; idx < M * cpr; idx += kThreads) {
          const int r = idx / cpr, cc = idx - r * cpr;
          if (row0 + r < n_rows)
            *reinterpret_cast<uint4*>(
                dgates_ws + ((size_t)(row0 + r) * n_steps + t) * g4 +
                cc * 8) =
                *reinterpret_cast<const uint4*>(dg_tile + r * ws + cc * 16);
        }
      }
      // a cluster: every rank is done reading its dh partials of the step
      // before, so this step's may land
      if constexpr (kCl) cluster_sync();

      // dx_t = dgates_c @ W_ih^T and dh = dgates_c @ W_hh^T: a slab's ks
      // rows are ks output columns; a warp takes 16 rows x 16 columns.  In
      // a cluster a block's dgates are those of its units, so its products
      // are partials: dx is left to phase C, and the dh partial of unit u
      // goes to rank u / hc, into its row block of this rank.
      const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
      for (int sl = ring.first_slab(kRev); sl < ring.n_slabs; ++sl, ++n) {
        const char* slab = ring.acquire(n, sl, kRev, t_next);
        cp_async_commit();
        const int k0 = sl * ks;
        const bool is_x = k0 < e;
        const int col0 = is_x ? k0 : k0 - e;
        for (int wu = warp; wu < MT * (ks / 16); wu += kWarps) {
          const int mt = wu % MT, np = wu / MT;
          float o[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
          const char* a_base =
              dg_tile + (mt * 16 + (lane & 15)) * ws + (lane >> 4) * 16;
          const char* b_base = slab + (np * 16 + b_n) * ws + b_k * 2;
#pragma unroll 4
          for (int kk = 0; kk < gc; kk += 16) {
            uint32_t af[4], bfr[4];
            ldsm_x4(af, a_base + kk * 2);
            ldsm_x4(bfr, b_base + kk * 2);
            mma_bf16(o[0], af, bfr[0], bfr[1]);
            mma_bf16(o[1], af, bfr[2], bfr[3]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = mt * 16 + g + half * 8;
              const int col = col0 + np * 16 + j * 8 + 2 * tg;
              if constexpr (kCl) {
                const int owner = col / hc;
                st_cluster_f2(exch_at[owner] +
                                  ((rank * M + r) * ex_ld + col - owner * hc) *
                                      4,
                              o[j][half * 2], o[j][half * 2 + 1]);
              } else if (is_x) {
                if (row0 + r < n_rows)
                  *reinterpret_cast<bf162*>(
                      dx + ((size_t)(row0 + r) * n_steps + t) * e + col) =
                      __floats2bfloat162_rn(o[j][half * 2], o[j][half * 2 + 1]);
              } else {
                *reinterpret_cast<float2*>(exch + r * ex_ld + col) =
                    make_float2(o[j][half * 2], o[j][half * 2 + 1]);
              }
            }
        }
      }
      // dh is whole (a cluster: every rank's partials have landed); every
      // warp is done with the dgates
      if constexpr (kCl)
        cluster_sync();
      else
        __syncthreads();

      // dh = (1 - m) dh + dgates_c @ W_hh^T (the product is 0 where m = 0);
      // a cluster adds its ranks' partials in rank order
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int unit = (ug0 + gi) * 8 + 2 * tg;
          if (unit < hc) {
#pragma unroll
            for (int half = 0; half < 2; ++half)
              if (mb >> (mt * 2 + half) & 1u) {
                const int r = mt * 16 + g + half * 8;
                float2 v = *reinterpret_cast<const float2*>(
                    exch + r * ex_ld + unit);
                if constexpr (kCl)
                  for (int src = 1; src < n_ranks; ++src) {
                    const float2 p = *reinterpret_cast<const float2*>(
                        exch + (src * M + r) * ex_ld + unit);
                    v.x += p.x;
                    v.y += p.y;
                  }
                dh[mt][gi][half * 2] = v.x;
                dh[mt][gi][half * 2 + 1] = v.y;
              }
          }
        }
    }

    // park the carried state for the next chunk's reverse pass
    if (q + 1 < n_chunks) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          st_global_f4(park + (size_t)(mt * G + gi) * kThreads,
                       f4_of(dh[mt][gi]));
          st_global_f4(park + (size_t)((MT + mt) * G + gi) * kThreads,
                       f4_of(dc[mt][gi]));
        }
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          st_global_f4(park + (size_t)(2 * MT * G + 2 * gi + p) * kThreads,
                       make_float4(dbs[gi][2 * p][0], dbs[gi][2 * p][1],
                                   dbs[gi][2 * p + 1][0],
                                   dbs[gi][2 * p + 1][1]));
    }
  }

  // per-block db: a column's cells all sit in one warp; add its eight row
  // lanes in a fixed order
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int unit = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = dbs[gi][qq][u];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0 && unit < hc)
          db_part[(size_t)(blockIdx.x / n_ranks) * g4 + qq * h_dim + u_off +
                  unit + u] = v;
      }
  }
}

// Byte offsets of the workspace regions (each 256-B aligned).  `mma`: the
// bf16 tensor-core phase A (its own rows per block and activation planes).
// A row block of `c` blocks (a cluster when c > 1; lstm_cluster for bf16,
// f32_cluster for float32) has one activation area per block and one db
// partial per row block.  The step route (`step`, above H = 1,024) keeps
// its planes [tc][kStepSaved][rows, H] where the activation areas lie, one
// db partial per kDgRows rows, and after phase B's partials its own
// buffers (lstm_step.cuh's StepBwd): h in turn, c, dh, dc and the unit
// tiles' dh partials.
struct Layout {
  int row_blocks, n_blocks, c, splits, rows_per_split;
  bool step;
  size_t act, dgates, h_prev, db_part, part_ih, part_hh, hbuf, c_state, dh,
      dc, partial, total;
};

Layout layout(int n_rows, int n_steps, int e, int h_dim, int tc, size_t elt,
              bool mma) {
  Layout L;
  const long long n = (long long)n_rows * n_steps;
  L.step = tiles::lstm_route(h_dim, mma, true, false) == tiles::kRouteStep;
  L.c = L.step ? 1 : mma ? tiles::lstm_cluster(h_dim) : f32_cluster(h_dim, true);
  const tiles::Config cfg =
      L.c > 1 ? tiles::kClusterConfig : tiles::pick_config(h_dim);
  const int m_rows = L.step ? kDgRows : mma ? 16 * cfg.mt : kRows;
  L.row_blocks = (n_rows + m_rows - 1) / m_rows;
  L.n_blocks = L.row_blocks * L.c;
  const size_t plane = (size_t)n_rows * h_dim;
  const Splits sp = make_splits(n);
  L.splits = sp.splits;
  L.rows_per_split = sp.rows_per_split;
  const size_t g4 = 4 * (size_t)h_dim;
  size_t off = 0;
  L.act = off;
  off += align256(
      L.step ? (size_t)tc * kStepSaved * plane * 4
      : mma ? (size_t)L.n_blocks *
                (tc * cfg.mt * cfg.g * kPlanes + park_slots(cfg.g, cfg.mt)) *
                tiles::kThreads * 16
          : (size_t)L.n_blocks * tc * kSaved * kRows *
                f32_units(h_dim, true) * 4);
  L.dgates = off;
  off += align256((size_t)n * g4 * elt);
  L.h_prev = off;
  off += align256((size_t)n * h_dim * elt);
  L.db_part = off;
  off += align256((size_t)L.row_blocks * g4 * 4);
  L.part_ih = off;
  off += align256((size_t)L.splits * e * g4 * 4);
  L.part_hh = off;
  off += align256((size_t)L.splits * h_dim * g4 * 4);
  const size_t step_plane = L.step ? align256(plane * 4) : 0;
  L.hbuf = off;
  off += L.step ? align256(2 * plane * elt) : 0;
  L.c_state = off;
  off += step_plane;
  L.dh = off;
  off += step_plane;
  L.dc = off;
  off += step_plane;
  L.partial = off;
  off += L.step ? align256(step_unit_tiles(h_dim, mma ? 1 : 0) * plane * 4)
                : 0;
  L.total = off;
  return L;
}

bool valid_shape(int n_rows, int n_steps, int e, int h_dim, int tc) {
  return n_rows >= 0 && n_steps >= 0 && e > 0 && h_dim > 0 && tc > 0;
}

// bf16: E and H multiples of 32, and above kMaxClustered (the step route)
// H of 256; float32: any H
bool shape_ok(int e, int h_dim, int dtype) {
  if (tiles::lstm_route(h_dim, dtype == 1, true, false) == tiles::kRouteStep)
    return step_shape_ok(e, h_dim, dtype);
  if (dtype == 0) return f32_cluster(h_dim, true) > 0;
  return dtype == 1 && e % tiles::kAlign == 0 && h_dim % tiles::kAlign == 0 &&
         tiles::lstm_cluster(h_dim) > 0;
}

// phase A, float32: exact f32 FMAs
int launch_cell(const void* x, const void* mask, const void* w_ih,
                const void* b, const void* w_hh, const void* w_ih_t,
                const void* w_hh_t, const void* hb, const void* cb,
                const void* dout, void* dx, float* dgates, float* h_prev,
                float* act, float* db_part, const Layout& L, int n_rows,
                int n_steps, int e, int h_dim, int reverse, int tc,
                cudaStream_t stream) {
  using T = float;
  const int hc = f32_units(h_dim, true);
  const size_t recompute = (size_t)h_dim + f32_chunk_rows(e);
  const size_t rev = (size_t)4 * hc + (L.c > 1 ? (size_t)L.c * hc : 0);
  const size_t smem =
      (recompute > rev ? recompute : rev) * kStride * sizeof(float);
  // a rank of a cluster has at most 2 * kF32Units = 256 threads
  const int bound = row_tile_bound(kRowGroups * hc);
  if (bound == 0 || (L.c > 1 && bound > 256)) return (int)cudaErrorInvalidValue;
  auto* kernel = L.c > 1         ? lstm_bwd_cell_kernel<T, 256, true>
                 : bound == 256 ? lstm_bwd_cell_kernel<T, 256, false>
                 : bound == 512 ? lstm_bwd_cell_kernel<T, 512, false>
                                : lstm_bwd_cell_kernel<T, 1024, false>;
  return (int)launch_blocks(
      kernel, L.row_blocks, L.c, kRowGroups * hc, smem, stream,
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b),
      static_cast<const T*>(w_hh), static_cast<const T*>(w_ih_t),
      static_cast<const T*>(w_hh_t), static_cast<const float*>(hb),
      static_cast<const float*>(cb), static_cast<const T*>(dout),
      static_cast<T*>(dx), dgates, h_prev, act, db_part, n_rows, n_steps, e,
      h_dim, reverse, tc, hc);
}

// phase A, bfloat16: tensor cores
template <int G, int MT, bool kCl>
int launch_mma(const void* x, const void* mask, const void* w_ih,
               const void* b, const void* hb, const void* cb,
               const void* dout, void* dx,
               __nv_bfloat16* dgates, __nv_bfloat16* h_prev, float* act,
               float* db_part, const Layout& L, int n_rows, int n_steps,
               int e, int h_dim, int reverse, int tc, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  int ks = 0;
  const size_t smem = tiles::mma_smem(h_dim, h_dim / L.c, tiles::kLstmGates,
                                      16 * MT, true, L.c, &ks);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_blocks(
      lstm_bwd_mma_kernel<G, MT, kCl>, L.row_blocks, L.c, tiles::kThreads,
      smem, stream, static_cast<const bf16*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(w_ih),
      static_cast<const bf16*>(b), static_cast<const float*>(hb),
      static_cast<const float*>(cb), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dx), dgates, h_prev, reinterpret_cast<float4*>(act),
      db_part, n_rows, n_steps, e, h_dim, reverse, tc, ks);
}

template <typename T>
int launch(const void* x, const void* mask, const void* w_ih, const void* b,
           const void* w_hh, const void* w_ih_t, const void* w_hh_t,
           const void* hb, const void* cb, const void* dout, void* dx,
           void* dw_ih, void* db, void* dw_hh, void* workspace, int n_rows,
           int n_steps, int e, int h_dim, int reverse, int tc,
           cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  const Layout L = layout(n_rows, n_steps, e, h_dim, tc, sizeof(T), kMma);
  char* ws = static_cast<char*>(workspace);
  T* dgates = reinterpret_cast<T*>(ws + L.dgates);
  T* h_prev = reinterpret_cast<T*>(ws + L.h_prev);
  float* act = reinterpret_cast<float*>(ws + L.act);
  float* db_part = reinterpret_cast<float*>(ws + L.db_part);
  float* part_ih = reinterpret_cast<float*>(ws + L.part_ih);
  float* part_hh = reinterpret_cast<float*>(ws + L.part_hh);
  const int g4 = 4 * h_dim;
  const int n = n_rows * n_steps;

  if (n_rows > 0 && n_steps > 0) {
    int rc = (int)cudaErrorInvalidValue;
    if constexpr (kMma) {
      if (!tiles::aligned16(x) || !tiles::aligned16(w_ih) ||
          !tiles::aligned16(hb) ||
          !tiles::aligned16(cb) || !tiles::aligned16(dout) ||
          !tiles::aligned16(dx) || !tiles::aligned16(workspace))
        return rc;
    }
    if (L.step) {
      const StepBwd sb = {ws + L.hbuf, reinterpret_cast<float*>(ws + L.c_state),
                          nullptr, act, reinterpret_cast<float*>(ws + L.dh),
                          reinterpret_cast<float*>(ws + L.dc),
                          reinterpret_cast<float*>(ws + L.partial), db_part,
                          dgates, h_prev};
      rc = step_phase_a(x, mask, w_ih, b, nullptr, w_hh, w_hh_t, hb, cb, dout,
                        sb, n_rows, n_steps, e, h_dim, reverse, tc,
                        tiles::kLstmGates, kMma ? 1 : 0, stream);
    } else if constexpr (kMma) {
      if (L.c > 1) {
        rc = launch_mma<tiles::kClusterConfig.g, tiles::kClusterConfig.mt,
                        true>(x, mask, w_ih, b, hb, cb, dout, dx, dgates,
                              h_prev, act, db_part, L, n_rows, n_steps, e,
                              h_dim, reverse, tc, stream);
      } else {
        const tiles::Config cfg = tiles::pick_config(h_dim);
#define CAIR_BWD_CASE(G_, MT_)                                              \
  if (cfg.g == G_)                                                          \
    rc = launch_mma<G_, MT_, false>(x, mask, w_ih, b, hb, cb, dout, dx,     \
                                    dgates, h_prev, act, db_part, L, n_rows, \
                                    n_steps, e, h_dim, reverse, tc, stream);
        CAIR_BWD_CASE(1, 4)
        CAIR_BWD_CASE(2, 4)
        CAIR_BWD_CASE(4, 2)
        CAIR_BWD_CASE(8, 1)
#undef CAIR_BWD_CASE
      }
    } else {
      rc = launch_cell(x, mask, w_ih, b, w_hh, w_ih_t, w_hh_t, hb, cb, dout,
                       dx, dgates, h_prev, act, db_part, L, n_rows, n_steps,
                       e, h_dim, reverse, tc, stream);
    }
    if (rc != 0) return rc;
    if (L.c > 1 || L.step) {
      // phase C: a cluster's (the step route's) dx = dgates_c @ W_ih^T
      cudaError_t err =
          launch_matmul<T>(dgates, g4, static_cast<const T*>(w_ih_t), n, e,
                           g4, static_cast<T*>(dx), stream);
      if (err != cudaSuccess) return (int)err;
    }
  }

  const Splits sp = {L.splits, L.rows_per_split};
  cudaError_t err = launch_wgrad_partial<T>(static_cast<const T*>(x), e,
                                            dgates, g4, g4, n, sp, part_ih,
                                            g4, 0, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_wgrad_partial<T>(h_prev, h_dim, dgates, g4, g4, n, sp, part_hh,
                                g4, 0, stream);
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<T><<<(e * g4 + 255) / 256, 256, 0, stream>>>(
      part_ih, L.splits, e * g4, e * g4, static_cast<T*>(dw_ih));
  sum_partials_kernel<T><<<(h_dim * g4 + 255) / 256, 256, 0, stream>>>(
      part_hh, L.splits, h_dim * g4, h_dim * g4, static_cast<T*>(dw_hh));
  sum_partials_kernel<T><<<(g4 + 255) / 256, 256, 0, stream>>>(
      db_part, L.row_blocks, g4, g4, static_cast<T*>(db));
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of workspace cair_lstm_bwd needs for these shapes, or -1 if they
// are invalid (dtype 0 = float32, 1 = bfloat16): phase A's (the planes, or
// the activation areas and the parked sums), phase B's operands and
// partials, the db partials, and above H = 1,024 the step route's state --
// h in turn, c, dh, dc and the dh partials of H / 256 (bf16) or
// ceil(H / 128) (float32) unit tiles, each [rows, H].
extern "C" long long cair_lstm_bwd_workspace(int n_rows, int n_steps, int e,
                                             int h_dim, int tc, int dtype) {
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc) ||
      !shape_ok(e, h_dim, dtype))
    return -1;
  return (long long)layout(n_rows, n_steps, e, h_dim, tc, dtype == 0 ? 4 : 2,
                           dtype == 1)
      .total;
}

// Kernel 5.  x [B, T, E], mask uint8 [B, T], w_ih [E, 4H], b [4H],
// w_hh [H, 4H], w_ih_t [4H, E] and w_hh_t [4H, H] (the transposes), hb, cb
// float32 [ceil(T / tc), B, H] from cair_lstm_fwd_res, dout [B, T, H] ->
// dx [B, T, E], dw_ih [E, 4H], db [4H], dw_hh [H, 4H]; one dtype for all but
// mask, hb and cb; `workspace` holds cair_lstm_bwd_workspace(...) bytes.
// bfloat16: `w_ih` points at the staged weights as cair_lstm_fwd takes them
// (one matrix a rank of the cluster above H = 384; above H = 1,024 one a
// unit tile of 256, H a multiple of 256), `w_ih_t` is read by a cluster's
// (the step route's) dx product alone, and `w_hh`, `w_hh_t` are not read.
// float32 reads both transposes (w_ih_t in phase C above H = 403).  Returns
// the first cudaError_t (0 on success).
extern "C" int cair_lstm_bwd(const void* x, const void* mask,
                             const void* w_ih, const void* b,
                             const void* w_hh, const void* w_ih_t,
                             const void* w_hh_t, const void* hb,
                             const void* cb, const void* dout, void* dx,
                             void* dw_ih, void* db, void* dw_hh,
                             void* workspace, int n_rows, int n_steps, int e,
                             int h_dim, int reverse, int tc, int dtype,
                             void* stream) {
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc) ||
      !shape_ok(e, h_dim, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, w_ih, b, w_hh, w_ih_t, w_hh_t, hb, cb, dout,
                         dx, dw_ih, db, dw_hh, workspace, n_rows, n_steps, e,
                         h_dim, reverse, tc, s);
  return launch<__nv_bfloat16>(x, mask, w_ih, b, w_hh, w_ih_t, w_hh_t, hb, cb,
                               dout, dx, dw_ih, db, dw_hh, workspace, n_rows,
                               n_steps, e, h_dim, reverse, tc, s);
}
