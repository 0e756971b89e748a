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
// float32 (the configuration's default dtype) runs the same kernel,
// lstm_bwd_mma_kernel<float>, on split-TF32 tiles (tf32_mma.cuh): every
// product -- the recompute's [x_t | h] @ W, the reverse pass's dgates_c @
// W^T, phase B's dW and a cluster's phase C -- is `mma.sync.m16n8k8` TF32
// tiles on operands split where their fragments are loaded, hi = tf32(v)
// and lo = v - hi, three products a tile (lo*hi, hi*lo, hi*hi; about 21 of
// float32's 24 bits), in a fixed order.  What bounds it: at the doc
// encoder's shape -> 128, 5.66e11 flops in split TF32's 495 / 3 = 165
// TFLOP/s, 3.43 ms; bound by operations.  What the design does about it:
// the bf16 layout with f32 operands -- the weights staged f32, one matrix
// a rank (stage_lstm_weights), streamed through the bulk-copy ring in
// slabs of 32, 16 or 8 k-rows (f32 doubles a slab's bytes), the dgates
// tile f32, the slabs read untransposed by `ldmatrix` in the reverse pass
// and by two scalar loads a lane in the recompute (no transposing
// `ldmatrix` exists for 32-bit elements), so no transposed weights exist;
// one block of 64 or 32 rows (pick_config_f32) up to H = 128, then
// clusters of ranks of at most 128 units (f32_cluster, cluster_config_f32:
// 2 or 4 ranks of 32 rows to 512, 8 of 16 rows to 1,024; dh partials in
// rank order, dx in phase C against W_ih read as it lies): more rows a
// block stream the weights for more rows (phase A moves about 2 TB/s of
// slabs from L2, PERF.md).
// The reverse pass's few output tiles a slab (one of 16 x 8 in an 8-row
// slab) split their k extent over the warps they leave idle, partials
// added in warp order, small and large terms and even and odd k steps in
// accumulators of their own (tf32_rev_product), so no dependent chain of
// `mma`s is long.  The cell update and its gradient keep exact expf /
// tanhf in f32.  The recompute is kernel 4's float32 step (lstm_fwd.cu:
// the same step_gates on the same staged slabs, k steps and split in the
// same order; only the rows a block holds differ, which change no row's
// sums), so from kernel 4's boundaries it recomputes kernel 4's states
// bit for bit: kernel 5 fed kernel 4's boundaries at a time chunk of 1
// and of 6 gives the same bits (chip_smoke's f32 phase).  What holds it
// now: the slab hand-overs (an mbarrier wait and one or two barriers a
// slab, the slabs half as deep as bf16's) with one block of 8 warps an SM
// (PERF.md).

// Above H = 1,024, in both dtypes, phase A takes the step route
// (lstm_step.cu: the recompute a launch a step, the reverse pass two, with
// each unit tile's dh partial added in tile order), and phases B and C run
// as for a cluster: any H the JAX kernel takes.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"
#include "lstm_step.cuh"

namespace {

using namespace cair_lstm;

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

template <typename T, int G, int MT, bool kCl>
__global__ void __launch_bounds__(tiles::kThreads, 1)
lstm_bwd_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                    const T* __restrict__ w_staged, const T* __restrict__ bias,
                    const float* __restrict__ hb, const float* __restrict__ cb,
                    const T* __restrict__ dout, T* __restrict__ dx,
                    T* __restrict__ dgates_ws, T* __restrict__ h_prev_ws,
                    float4* __restrict__ act, float* __restrict__ db_part,
                    int n_rows, int n_steps, int e, int h_dim, int reverse,
                    int tc, int ks) {
  using namespace tiles;
  using E = Elt<T>;
  constexpr int kE = (int)sizeof(T);  // bytes an element
  constexpr int kPer = 16 / kE;       // elements a 16-byte copy
  // ranks a cluster may have: bf16 lstm_cluster / gru_cluster, float32
  // f32_cluster
  constexpr int kMaxC = kE == 4 ? kF32MaxRanks : 4;
  extern __shared__ __align__(16) char smem[];
  constexpr int M = 16 * MT;
  const int n_ranks = kCl ? (int)cluster_size() : 1;
  const int rank = kCl ? (int)cluster_rank() : 0;
  const int hc = h_dim / n_ranks, u_off = rank * hc;
  const int hs = h_stride(h_dim, kE);
  const int ws = w_stride(hc, kLstmGates, kE);
  const int ss = slot_stride(hc, kE);  // the dgates tile (bf16: ws)
  const int g4 = 4 * h_dim, gc = 4 * hc;
  const int ex_ld = (kCl ? hc : h_dim) + 8;  // floats per row of dh's tile
  const int row0 = (blockIdx.x / n_ranks) * M;
  // a cluster's reverse pass streams the h slabs alone (kHOnly)
  constexpr int kRev = kCl ? kHOnly : kNoX;
  WeightRingT<T> ring;
  ring.init(smem, w_staged + (size_t)rank * (e + h_dim) * (ws / kE), x, e,
            h_dim, hc, kLstmGates, ks, kCl ? n_steps : 2 * n_steps, row0, M,
            n_rows, n_steps, kCl ? n_steps : 0);
  char* uni = ring.end();
  char* h_buf[2];
  h_buf[0] = uni;
  h_buf[1] = uni + (kCl ? M * hs : 0);
  char* dg_tile = uni;
  const size_t staged =
      staged_bytes(h_dim, hc, kLstmGates, M, true, n_ranks, kE);
  float* exch = reinterpret_cast<float*>(
      kCl ? uni + M * ss : uni + staged);
  float* bias_s = reinterpret_cast<float*>(
      uni + staged + (kCl ? 0 : exch_bytes(h_dim, M)));
  // float32: the reverse products' partials of the warps of a tile
  float* red = bias_s + gc;
  uint32_t exch_at[kMaxC] = {};  // exch in each rank of the cluster
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
    bias_s[i] = to_f32(bias[(i / hc) * h_dim + u_off + i % hc]);

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
      E::store2(h_buf[0] + r * hs + u * kE, hv.x, hv.y);
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
            const int cpr = hc / kPer;
            for (int idx = threadIdx.x; idx < M * cpr; idx += kThreads) {
              const int r = idx / cpr, cc = idx - r * cpr;
              if (row0 + r < n_rows)
                *reinterpret_cast<uint4*>(
                    h_prev_ws + ((size_t)(row0 + r) * n_steps + t) * h_dim +
                    u_off + cc * kPer) =
                    *reinterpret_cast<const uint4*>(h_cur + r * hs +
                                                    (u_off + cc * kPer) * kE);
            }
          });
      // a single block rewrites its h tile in place: every warp must have
      // read it; a cluster writes the other tile
      if constexpr (!kCl) __syncthreads();
      const bool send = kCl && k + 1 < len;
      uint32_t dst[kMaxC] = {};  // the next h tile in each rank
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
              if constexpr (kCl) {
                if (send)
                  for (int p = 0; p < n_ranks; ++p)
                    E::send2(dst[p] + r * hs + col * kE, m, hn[half * 2],
                             hn[half * 2 + 1], h_cur + r * hs + col * kE);
              } else if (m) {
                E::store2(h_buf[0] + r * hs + col * kE, hn[half * 2],
                          hn[half * 2 + 1]);
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
                  const float2 dov = E::load2(
                      dout + ((size_t)(row0 + r) * n_steps + t) * h_dim +
                      u_off + unit);
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
                E::store2(dg_tile + (mt * 16 + g + half * 8) * ss +
                              (qq * hc + unit) * kE,
                          d[qq][half * 2], d[qq][half * 2 + 1]);
            }
          }
        }
      __syncthreads();  // the dgates tile is whole

      // dgates_c of (row, t) for phase B: a single block's rows are whole
      // rows of the workspace; a rank's are its columns of each gate
      if constexpr (kCl) {
        const int cpr = hc / kPer;
        for (int idx = threadIdx.x; idx < M * 4 * cpr; idx += kThreads) {
          const int r = idx / (4 * cpr), rest = idx - r * 4 * cpr;
          const int qq = rest / cpr, cc = rest - qq * cpr;
          if (row0 + r < n_rows)
            *reinterpret_cast<uint4*>(
                dgates_ws + ((size_t)(row0 + r) * n_steps + t) * g4 +
                qq * h_dim + u_off + cc * kPer) =
                *reinterpret_cast<const uint4*>(dg_tile + r * ss +
                                                (qq * hc + cc * kPer) * kE);
        }
      } else {
        const int cpr = g4 / kPer;
        for (int idx = threadIdx.x; idx < M * cpr; idx += kThreads) {
          const int r = idx / cpr, cc = idx - r * cpr;
          if (row0 + r < n_rows)
            *reinterpret_cast<uint4*>(
                dgates_ws + ((size_t)(row0 + r) * n_steps + t) * g4 +
                cc * kPer) =
                *reinterpret_cast<const uint4*>(dg_tile + r * ss + cc * 16);
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
      // a lane's row of the two n-tiles' B fragments and its byte offset
      const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 16;
      // 16-column groups of a slab (float32's slabs of 8 k-rows: one n-tile)
      const bool one = kE == 4 && ks == 8;
      const int n_np = one ? 1 : ks / 16;
      const int units = MT * n_np;       // output tiles of a slab
      const int parts = kE == 4 ? kWarps / units : 1;
      for (int sl = ring.first_slab(kRev); sl < ring.n_slabs; ++sl, ++n) {
        const char* slab = ring.acquire(n, sl, kRev, t_next);
        cp_async_commit();
        const int k0 = sl * ks;
        const bool is_x = k0 < e;
        const int col0 = is_x ? k0 : k0 - e;
        // a warp takes a tile of 16 rows x 16 columns (8 in float32's
        // 8-row slabs); float32 splits a tile's k extent over the warps the
        // tiles leave idle, `parts` a tile, whose partials the first adds in
        // warp order through `red`
        if (warp < units * parts) {
          const int wu = warp % units, part = warp / units;
          const int mt = wu % MT, np = wu / MT;
          const int k_steps = gc / E::kK;
          const int k_lo = part * k_steps / parts * E::kK;
          const int k_hi = (part + 1) * k_steps / parts * E::kK;
          float o[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
          const char* a_base =
              dg_tile + (mt * 16 + (lane & 15)) * ss + (lane >> 4) * 16;
          const char* b_base = slab + (np * 16 + b_n) * ws + b_k;
          if constexpr (kE == 4) {
            tf32_rev_product(o, a_base, b_base, k_lo, k_hi, one,
                             [](int kk) { return kk; });
          } else {
#pragma unroll 4
            for (int kk = k_lo; kk < k_hi; kk += E::kK) {
              uint32_t af[4], bfr[4];
              ldsm_x4(af, a_base + kk * 2);
              ldsm_x4(bfr, b_base + kk * 2);
              mma_bf16(o[0], af, bfr[0], bfr[1]);
              mma_bf16(o[1], af, bfr[2], bfr[3]);
            }
          }
          if (parts > 1) {
            // the partials of the warps past the first part, warp order
            if (part > 0) {
              float4* mine = reinterpret_cast<float4*>(red) +
                             ((warp - units) * 32 + lane) * 2;
              mine[0] = f4_of(o[0]);
              mine[1] = f4_of(o[1]);
            }
            __syncthreads();
            if (part == 0)
              for (int p = 1; p < parts; ++p) {
                const float4* src = reinterpret_cast<const float4*>(red) +
                                    (((p - 1) * units + wu) * 32 + lane) * 2;
                const float4 v0 = src[0], v1 = src[1];
                o[0][0] += v0.x;
                o[0][1] += v0.y;
                o[0][2] += v0.z;
                o[0][3] += v0.w;
                o[1][0] += v1.x;
                o[1][1] += v1.y;
                o[1][2] += v1.z;
                o[1][3] += v1.w;
              }
          }
          if (part == 0) {
#pragma unroll
            for (int j = 0; j < (one ? 1 : 2); ++j)
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
                    E::store2(dx + ((size_t)(row0 + r) * n_steps + t) * e + col,
                              o[j][half * 2], o[j][half * 2 + 1]);
                } else {
                  *reinterpret_cast<float2*>(exch + r * ex_ld + col) =
                      make_float2(o[j][half * 2], o[j][half * 2 + 1]);
                }
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

// Byte offsets of the workspace regions (each 256-B aligned).  Phase A up
// to H = 1,024 is the tensor-core kernel in both dtypes (its rows per block
// and activation planes: pick_config for bf16, pick_config_f32 for float32,
// kClusterConfig for a cluster's ranks).  A row block of `c` blocks (a
// cluster when c > 1; lstm_cluster for bf16, f32_cluster for float32) has
// one activation area per block and one db partial per row block.  The
// step route (`step`, above H = 1,024) keeps its planes [tc][kStepSaved]
// [rows, H] where the activation areas lie, one db partial per kDgRows
// rows, and after phase B's partials its own buffers (lstm_step.cuh's
// StepBwd): h in turn, c, dh, dc and the unit tiles' dh partials.
struct Layout {
  int row_blocks, n_blocks, c, splits, rows_per_split;
  bool step;
  tiles::Config cfg;
  size_t act, dgates, h_prev, db_part, part_ih, part_hh, hbuf, c_state, dh,
      dc, partial, total;
};

Layout layout(int n_rows, int n_steps, int e, int h_dim, int tc, size_t elt,
              bool bf16) {
  Layout L;
  const long long n = (long long)n_rows * n_steps;
  L.step = tiles::lstm_route(h_dim, bf16, false) == tiles::kRouteStep;
  L.c = L.step ? 1 : bf16 ? tiles::lstm_cluster(h_dim) : f32_cluster(h_dim);
  L.cfg = bf16 ? (L.c > 1 ? tiles::kClusterConfig : tiles::pick_config(h_dim))
         : L.c > 1 ? tiles::cluster_config_f32(L.c)
                   : tiles::pick_config_f32(h_dim);
  const int m_rows = L.step ? kDgRows : 16 * L.cfg.mt;
  L.row_blocks = (n_rows + m_rows - 1) / m_rows;
  L.n_blocks = L.row_blocks * L.c;
  const size_t plane = (size_t)n_rows * h_dim;
  const Splits sp = make_splits(n);
  L.splits = sp.splits;
  L.rows_per_split = sp.rows_per_split;
  const size_t g4 = 4 * (size_t)h_dim;
  size_t off = 0;
  L.act = off;
  off += align256(L.step ? (size_t)tc * kStepSaved * plane * 4
                         : (size_t)L.n_blocks *
                               (tc * L.cfg.mt * L.cfg.g * kPlanes +
                                park_slots(L.cfg.g, L.cfg.mt)) *
                               tiles::kThreads * 16);
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
  off += L.step ? align256(step_unit_tiles(h_dim, bf16 ? 1 : 0) * plane * 4)
                : 0;
  L.total = off;
  return L;
}

bool valid_shape(int n_rows, int n_steps, int e, int h_dim, int tc) {
  return n_rows >= 0 && n_steps >= 0 && e > 0 && h_dim > 0 && tc > 0;
}

// Up to H = 1,024 the tensor-core tiles: E and H multiples of 32 (float32
// in a cluster of C blocks H of 16 C, so a rank's units are a multiple of
// 16; f32_cluster), whose shared memory fits; above it the step route
// (bf16 H of 256, float32 any)
bool shape_ok(int e, int h_dim, int dtype) {
  if (tiles::lstm_route(h_dim, dtype == 1, false) == tiles::kRouteStep)
    return step_shape_ok(e, h_dim, dtype);
  if (e % tiles::kAlign != 0 || h_dim % tiles::kAlign != 0) return false;
  if (dtype == 1) return tiles::lstm_cluster(h_dim) > 0;
  const int c = f32_cluster(h_dim);
  if (dtype != 0 || c == 0 || h_dim % (16 * c) != 0) return false;
  int ks = 0;
  return tiles::mma_smem(h_dim, h_dim / c, tiles::kLstmGates,
                         16 * (c > 1 ? tiles::cluster_config_f32(c)
                                     : tiles::pick_config_f32(h_dim)).mt,
                         true, c, &ks, 4) != 0;
}

// phase A up to H = 1,024: tensor cores (float32: split TF32)
template <typename T, int G, int MT, bool kCl>
int launch_mma(const void* x, const void* mask, const void* w_ih,
               const void* b, const void* hb, const void* cb,
               const void* dout, void* dx, T* dgates, T* h_prev, float* act,
               float* db_part, const Layout& L, int n_rows, int n_steps,
               int e, int h_dim, int reverse, int tc, cudaStream_t stream) {
  int ks = 0;
  const size_t smem =
      tiles::mma_smem(h_dim, h_dim / L.c, tiles::kLstmGates, 16 * MT, true,
                      L.c, &ks, (int)sizeof(T));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_blocks(
      lstm_bwd_mma_kernel<T, G, MT, kCl>, L.row_blocks, L.c, tiles::kThreads,
      smem, stream, static_cast<const T*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(w_ih),
      static_cast<const T*>(b), static_cast<const float*>(hb),
      static_cast<const float*>(cb), static_cast<const T*>(dout),
      static_cast<T*>(dx), dgates, h_prev, reinterpret_cast<float4*>(act),
      db_part, n_rows, n_steps, e, h_dim, reverse, tc, ks);
}

template <typename T>
int launch(const void* x, const void* mask, const void* w_ih, const void* b,
           const void* w_hh, const void* w_dx, const void* w_hh_t,
           const void* hb, const void* cb, const void* dout, void* dx,
           void* dw_ih, void* db, void* dw_hh, void* workspace, int n_rows,
           int n_steps, int e, int h_dim, int reverse, int tc,
           cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const Layout L = layout(n_rows, n_steps, e, h_dim, tc, sizeof(T), kBf16);
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
    // the tiles' bulk and 16-byte copies (the float32 step route reads its
    // operands as they lie)
    if ((kBf16 || !L.step) &&
        (!tiles::aligned16(x) || !tiles::aligned16(w_ih) ||
         !tiles::aligned16(hb) || !tiles::aligned16(cb) ||
         !tiles::aligned16(dout) || !tiles::aligned16(dx) ||
         !tiles::aligned16(workspace)))
      return rc;
    if (L.step) {
      const StepBwd sb = {ws + L.hbuf, reinterpret_cast<float*>(ws + L.c_state),
                          nullptr, act, reinterpret_cast<float*>(ws + L.dh),
                          reinterpret_cast<float*>(ws + L.dc),
                          reinterpret_cast<float*>(ws + L.partial), db_part,
                          dgates, h_prev};
      rc = step_phase_a(x, mask, w_ih, b, nullptr, w_hh, w_hh_t, hb, cb, dout,
                        sb, n_rows, n_steps, e, h_dim, reverse, tc,
                        tiles::kLstmGates, kBf16 ? 1 : 0, stream);
    } else if (L.c > 1) {
      if constexpr (kBf16)
        rc = launch_mma<T, tiles::kClusterConfig.g, tiles::kClusterConfig.mt,
                        true>(x, mask, w_ih, b, hb, cb, dout, dx, dgates,
                              h_prev, act, db_part, L, n_rows, n_steps, e,
                              h_dim, reverse, tc, stream);
      else if (L.cfg.mt == 2)
        rc = launch_mma<T, 2, 2, true>(x, mask, w_ih, b, hb, cb, dout, dx,
                                       dgates, h_prev, act, db_part, L,
                                       n_rows, n_steps, e, h_dim, reverse, tc,
                                       stream);
      else
        rc = launch_mma<T, 2, 1, true>(x, mask, w_ih, b, hb, cb, dout, dx,
                                       dgates, h_prev, act, db_part, L,
                                       n_rows, n_steps, e, h_dim, reverse, tc,
                                       stream);
    } else {
#define CAIR_BWD_CASE(G_, MT_)                                               \
  if (L.cfg.g == G_ && L.cfg.mt == MT_)                                      \
    rc = launch_mma<T, G_, MT_, false>(x, mask, w_ih, b, hb, cb, dout, dx,   \
                                       dgates, h_prev, act, db_part, L,      \
                                       n_rows, n_steps, e, h_dim, reverse,   \
                                       tc, stream);
      if constexpr (kBf16) {
        CAIR_BWD_CASE(1, 4)
        CAIR_BWD_CASE(2, 4)
        CAIR_BWD_CASE(4, 2)
        CAIR_BWD_CASE(8, 1)
      } else {
        CAIR_BWD_CASE(1, 4)
        CAIR_BWD_CASE(2, 2)
      }
#undef CAIR_BWD_CASE
    }
    if (rc != 0) return rc;
    if (L.c > 1 || L.step) {
      // phase C: a cluster's (the step route's) dx = dgates_c @ W_ih^T;
      // float32 reads W_ih as it lies
      cudaError_t err;
      if constexpr (kBf16)
        err = launch_matmul(dgates, g4, static_cast<const T*>(w_dx), n, e,
                            g4, static_cast<T*>(dx), stream);
      else
        err = launch_matmul_tf32(dgates, g4, static_cast<const float*>(w_dx),
                                 g4, n, e, g4, static_cast<float*>(dx),
                                 stream);
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
// w_hh [H, 4H], w_dx and w_hh_t [4H, H] (W_hh's transpose), hb, cb float32
// [ceil(T / tc), B, H] from cair_lstm_fwd_res, dout [B, T, H] -> dx
// [B, T, E], dw_ih [E, 4H], db [4H], dw_hh [H, 4H]; one dtype for all but
// mask, hb and cb; `workspace` holds cair_lstm_bwd_workspace(...) bytes.
// Up to H = 1,024 (both dtypes) and on the bf16 step route, `w_ih` points
// at the staged weights as cair_lstm_fwd takes them (one matrix a rank of
// a cluster -- bf16 above H = 384, float32 above 256 -- or, bf16 above H =
// 1,024, a unit tile of 256, H a multiple of 256), and `w_hh`, `w_hh_t`
// are not read; the float32 step route reads w_ih and w_hh as given and
// w_hh_t.  `w_dx` is read by a cluster's (the step route's) dx product
// alone: bf16 W_ih^T [4H, E], float32 W_ih itself.  Returns the first
// cudaError_t (0 on success).
extern "C" int cair_lstm_bwd(const void* x, const void* mask,
                             const void* w_ih, const void* b,
                             const void* w_hh, const void* w_dx,
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
    return launch<float>(x, mask, w_ih, b, w_hh, w_dx, w_hh_t, hb, cb, dout,
                         dx, dw_ih, db, dw_hh, workspace, n_rows, n_steps, e,
                         h_dim, reverse, tc, s);
  return launch<__nv_bfloat16>(x, mask, w_ih, b, w_hh, w_dx, w_hh_t, hb, cb,
                               dout, dx, dw_ih, db, dw_hh, workspace, n_rows,
                               n_steps, e, h_dim, reverse, tc, s);
}
