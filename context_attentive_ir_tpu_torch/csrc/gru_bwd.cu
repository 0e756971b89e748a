// Chunked-rematerialization GRU backward for Hopper (sm_90a): kernel 9.
//
// Replaces the TPU kernel `_gru_fused_bwd_kernel` / `_gru_fused_bwd_impl`
// in context_attentive_ir_tpu/ops/pallas/gru.py (the backward of the
// `gru_pallas_fused` custom_vjp).  Given the forward's chunk-boundary state
// (hb from kernel 8, gru_fwd.cu) and dout = dL/d out, it returns dx
// [B, T, E] and dW_ih, db_ih, dW_hh, db_hh.  Per time chunk, in reverse
// processing order: recompute the forward inside the chunk from its boundary
// state, then run the cell backward step by step:
//
//   dh' = m * (dout_t + dh);  dz = dh' * (h_prev - n)
//   da_n = dh' * (1 - z) * (1 - n^2);  da_r = da_n * hn * r(1-r)
//   da_z = dz * z(1-z)                        (hn = h_prev_c @ W_hn + b_hn)
//   dg_ih = [da_r, da_z, da_n];  dg_hh = [da_r, da_z, da_n * r]      (f32)
//   dx_t = dg_ih_c @ W_ih^T;  dh = (1-m) dh + m (dh' z + dg_hh_c @ W_hh^T)
//   dW_ih += x_t^T dg_ih_c;  dW_hh += h_prev_c^T dg_hh_c
//   db_ih += sum dg_ih;  db_hh += sum dg_hh
//
// The ih and hh gate gradients differ only in the n slot, because r
// multiplies h_n and not x_n.  Rounding follows the TPU kernel in both
// dtypes: h is rounded to the compute dtype before h @ W_hh (in the
// recompute) and before the dW_hh product; the gate gradients are rounded
// to it (dg_c) before the dx, dh and dW products; db sums the f32
// gradients; dW accumulates in f32 and is cast to the weight dtype at the
// end.
//
// What bounds it on the H100, doc encoder [16000, 30, 256] -> 128, one
// direction, bf16: recompute 1.42e11 + dx 9.4e10 + dh 4.7e10 + dW_ih 9.4e10
// + dW_hh 4.7e10 = 4.25e11 flops, 0.429 ms at 989 TFLOP/s, against ~0.55 GB
// of x, dout, dx and boundary traffic (0.16 ms): bound by operations, which
// only the tensor cores deliver.
//
// The TPU accumulates dW in VMEM-resident output blocks across a
// sequential grid; on Hopper blocks run in parallel and nothing carries
// between them, and dW_ih alone (256 x 384 f32 = 384 KB) exceeds a block's
// shared memory.  So the work is split:
//
// - Phase A walks the chunks in reverse, recomputes each one from hb and
//   runs the cell backward; it writes dx, and the four gradient slots
//   [da_r, da_z, da_n, da_n * r] rounded (slots 0-2 are dg_ih_c, slots 0, 1,
//   3 dg_hh_c) and h_prev_c per (row, step) to a workspace for phase B, and
//   a per-block partial of each slot's sum (the db's).
// - Phase B (lstm_common.cuh's launch_wgrad_partial): dW_ih = X^T G[0:3]
//   and dW_hh = Hp^T G[0, 1, 3] over all B*T (row, step) pairs as output
//   tiles (bf16: 128 x 128 on tensor cores; float32: the same in split
//   TF32, tf32_mma.cuh),
//   split over up to 32 row ranges to fill the card;
//   sum_partials_kernel then adds the splits (and the per-block db partials)
//   in a fixed order.
//
// No atomics and a fixed instruction order: the gradients are the same bits
// from run to run.
//
// Design of phase A, bfloat16 (gru_bwd_mma_kernel; lstm_mma.cuh's tiles,
// as kernel 5's lstm_bwd_mma_kernel with the GRU's three gate blocks): a
// block of 8 warps owns M = 64 rows (32 or 16 for H above 128 or 256; 16
// at every H when that layout would give fewer blocks than the card has
// SMs, bwd_row_tiles).  The recompute is kernel 8's step (step_gates on
// the staged [E + H, 3H + 8] weights streamed through the `cp.async.bulk`
// ring, x_t's columns streamed beside each x slab, the n gate's x @ W_in and
// h @ W_hn in their own slots, so hn = h_prev_c @ W_hn + b_hn comes out of
// the product), with h carried in f32 registers.  It keeps h_prev, r, z, n
// and hn of each cell -- five f32 planes, none of which the other four
// give back (h_prev from h' needs a division by z, n needs x @ W_in) -- in
// a global workspace written and read back by the owning thread as whole
// float4 fragments, consecutive threads on consecutive 16 bytes.  In the
// reverse pass a thread computes the four gradient slots of its cells from
// registers and rounds them to bf16 into a staged [M x 4H] tile (which
// takes the place of the recompute's [x | h] tiles); dx_t = slots 0..2 @
// W_ih^T and the product of dh = dh' z + slots {0, 1, 3} @ W_hh^T (the
// k-block of slot 3 in the place of slot 2) are `mma.sync.m16n8k16` tiles
// against the same slabs the recompute streams, read untransposed by
// `ldmatrix` (a slab's rows are the product's output columns): no
// transposed copy of the weights exists.  dh returns to the owning threads
// through a small f32 tile inside the staged area; masked steps carry dh.
// The slots tile and the h tile go to the workspace for phase B with
// 16-byte coalesced stores.  E and H are multiples of 32 here: the wrapper
// zero-pads other sizes.  What holds it now, as kernel 5: the (E + H) / ks
// slab hand-overs of every step in both passes (an mbarrier wait and a
// barrier each) and the cell updates between them, more than the products
// or the planes' traffic (PERF.md).
//
// Above H = 448 (gru_cluster: 2 or 4 blocks of 16 rows, H a multiple of 64
// in a cluster of 4) the gate columns split over a thread-block cluster as
// in kernel 5 (lstm_mma.cuh): the recompute is kernel 8's clustered step;
// in the reverse pass a block's gradient slots are those of its Hc units,
// so slots {0, 1, 3} @ W_hh^T over its slabs' h rows is a partial of every
// unit's dh: each block sends the partials of rank r's units into rank r's
// tile of partials (distributed shared memory, one tile of Hc columns a
// source rank, so no full-H dh tile is staged) and rank r adds them in
// rank order, then dh' z (the same bits every run); the reverse pass
// streams the h slabs alone, and dx = slots 0..2 @ W_ih^T over all B*T
// rows is one tensor-core product after phase A (phase C, launch_matmul on
// the workspace's slots, rows 4H apart).
//
// Above H = 1,024 (gru_route), in both dtypes, phase A takes the step route
// (lstm_step.cu with three gate blocks): each chunk recomputed from hb a
// launch a step by kernel 8's step kernel, which keeps the planes h_prev,
// r, z, n, hn and h_prev_c; then a step at a time an elementwise kernel
// forms the four gradient slots and the db partials of each 16-row group,
// and a product kernel writes each unit tile's partial of dh_{t-1} from
// slots 0, 1 and 3 against its staged slabs read untransposed (float32:
// exact FMAs against W_hh^T), which the next step adds in tile order, then
// dh' z.  Phases B and C run as a cluster's.
//
// float32 (the configuration's default dtype) runs the same kernel,
// gru_bwd_mma_kernel<float>, on split-TF32 tiles as kernel 5 does
// (tf32_mma.cuh; lstm_bwd.cu states the design): every product, phases B
// and C too, `mma.sync.m16n8k8` TF32 tiles of split operands, three
// products a tile in a fixed order; one block up to H = 128 (64 or 32
// rows), clusters of 2, 4 or 8 ranks of at most 128 units to 1,024
// (f32_cluster; 32 rows a rank up to 4 ranks, 16 in 8).  Bound at the
// doc encoder's shape -> 128: 4.25e11 flops at 165 TFLOP/s, 2.57 ms.  The
// recompute is kernel 8's float32 step (gru_fwd.cu), so from kernel 8's
// boundaries it recomputes kernel 8's states bit for bit (chip_smoke's
// f32 phase: kernel 9 the same bits at a time chunk of 1 and of 6).

#include "lstm_common.cuh"
#include "lstm_mma.cuh"
#include "lstm_step.cuh"

namespace {

using namespace cair_lstm;

// Phase A on bf16 tensor cores (see the header note).  Shared memory:
// weight ring (mbarriers, slabs, x slots) | union of {h tile (two in a
// cluster, kCl)} (recompute) and {slots tile; a single block's dh exchange
// (f32, rows h + 8 floats apart); in a cluster, the dh partials of the
// block's units from every rank, [C][M][hc + 8] f32} (reverse pass) | bias
// slots r, z, xn, hn of the block's units (f32).  In a cluster the reverse
// pass computes no dx (phase C's product) and streams the h slabs alone.
// As in kernel 5, the reverse pass's dh and slot sums wait out each
// recompute in the block's park area of the workspace (kPark float4 a
// thread, once a chunk), so the recompute's accumulators keep their
// registers.
constexpr int kPlanes = 5;  // per cell and step: h_prev, r, z, n, hn

// float4 a thread: dh [MT][G][4]; dbs [G][4][2]
__host__ __device__ constexpr int park_slots(int g, int mt) {
  return mt * g + 2 * g;
}

template <typename T, int G, int MT, bool kCl>
__global__ void __launch_bounds__(tiles::kThreads, 1)
gru_bwd_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                   const T* __restrict__ w_staged, const T* __restrict__ b_ih,
                   const T* __restrict__ b_hh, const float* __restrict__ hb,
                   const T* __restrict__ dout, T* __restrict__ dx,
                   T* __restrict__ dg_ws, T* __restrict__ h_prev_ws,
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
  const int hs = h_stride(h_dim, kE), ss = slot_stride(hc, kE);
  const int gk = 3 * hc;  // the products' k extent: three slots of hc
  const int g4 = 4 * h_dim;
  const int ex_ld = hc + 8;  // floats per row of dh's tile
  const int row0 = (blockIdx.x / n_ranks) * M;
  // a cluster's reverse pass streams the h slabs alone (kHOnly)
  constexpr int kRev = kCl ? kHOnly : kNoX;
  WeightRingT<T> ring;
  ring.init(smem,
            w_staged + (size_t)rank * (e + h_dim) *
                           (w_stride(hc, kGruGates, kE) / kE),
            x, e, h_dim, hc, kGruGates, ks, kCl ? n_steps : 2 * n_steps, row0,
            M, n_rows, n_steps, kCl ? n_steps : 0);
  char* uni = ring.end();
  char* h_buf[2];
  h_buf[0] = uni;
  h_buf[1] = uni + (kCl ? M * hs : 0);
  char* dg_tile = uni;
  float* exch = reinterpret_cast<float*>(uni + M * ss);
  float* bias_s = reinterpret_cast<float*>(
      uni + staged_bytes(h_dim, hc, kGruGates, M, true, n_ranks, kE));
  // float32: the reverse products' partials of the warps of a tile
  float* red = bias_s + 4 * hc;
  uint32_t exch_at[kMaxC] = {};  // exch in each rank of the cluster
  if constexpr (kCl)
    for (int q = 0; q < n_ranks; ++q) exch_at[q] = map_rank(exch, q);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;
  const int n_chunks = (n_steps + tc - 1) / tc;
  // the x step of chunk q's first recompute step (-1 past the last chunk)
  auto first_t = [&](int q) {
    if (q >= n_chunks) return -1;
    const int chunk = reverse ? q : n_chunks - 1 - q;
    const int t_lo = chunk * tc;
    return reverse ? t_lo + min(tc, n_steps - t_lo) - 1 : t_lo;
  };
  // the block's activation planes, [tc][MT * G * kPlanes][kThreads] float4,
  // then its park area [kPark][kThreads] float4
  constexpr int kSlots = MT * G * kPlanes;
  constexpr int kPark = park_slots(G, MT);
  float4* my_act = act +
                   (size_t)blockIdx.x * (tc * kSlots + kPark) * kThreads +
                   threadIdx.x;
  float4* park = my_act + (size_t)tc * kSlots * kThreads;

  for (int i = threadIdx.x; i < hc; i += kThreads) {
    const int u = u_off + i;
#pragma unroll
    for (int q = 0; q < 2; ++q)  // r, z: both biases
      bias_s[q * hc + i] = to_f32(b_ih[q * h_dim + u]) +
                           to_f32(b_hh[q * h_dim + u]);
    bias_s[2 * hc + i] = to_f32(b_ih[2 * h_dim + u]);  // xn
    bias_s[3 * hc + i] = to_f32(b_hh[2 * h_dim + u]);  // hn
  }

  // the reverse pass's carried state (defined anew at each reverse pass:
  // zeros, or what the last one parked)
  float dh[MT][G][4], dbs[G][4][2];

  unsigned live = 0;  // bit mt*2 + half: row mt*16 + g + half*8 is real
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (row0 + mt * 16 + g + half * 8 < n_rows) live |= 1u << (mt * 2 + half);

  // h before step t, rounded, columns col0 .. col0 + cols - 1 of the staged
  // tile: phase B's operand for dW_hh
  auto copy_h_prev = [&](const char* h_cur, int t, int col0, int cols) {
    const int cpr = cols / kPer;
    for (int idx = threadIdx.x; idx < M * cpr; idx += kThreads) {
      const int r = idx / cpr, cc = idx - r * cpr;
      if (row0 + r < n_rows)
        *reinterpret_cast<uint4*>(
            h_prev_ws + ((size_t)(row0 + r) * n_steps + t) * h_dim + col0 +
            cc * kPer) =
            *reinterpret_cast<const uint4*>(h_cur + r * hs +
                                            (col0 + cc * kPer) * kE);
    }
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
    float h[MT][G][4];  // the carried state of the block's units, f32
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int unit = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + half * 8;
          float2 hv = make_float2(0.0f, 0.0f);
          if (unit < hc && (live >> (mt * 2 + half) & 1u))
            hv = *reinterpret_cast<const float2*>(
                hb + ((size_t)chunk * n_rows + row0 + r) * h_dim + u_off +
                unit);
          h[mt][gi][half * 2] = hv.x;
          h[mt][gi][half * 2 + 1] = hv.y;
          if (!kCl && unit < hc)
            E::store2(h_buf[0] + r * hs + unit * kE, hv.x, hv.y);
        }
      }
    if constexpr (kCl) {
      // h of every unit, rounded (rows past n_rows: 0); every rank is done
      // with its reverse pass before the other ranks' h lands in the union
      for (int idx = threadIdx.x; idx < M * (h_dim / 2); idx += kThreads) {
        const int r = idx / (h_dim / 2);
        const int u = (idx - r * (h_dim / 2)) * 2;
        float2 hv = make_float2(0.0f, 0.0f);
        if (row0 + r < n_rows)
          hv = *reinterpret_cast<const float2*>(
              hb + ((size_t)chunk * n_rows + row0 + r) * h_dim + u);
        E::store2(h_buf[0] + r * hs + u * kE, hv.x, hv.y);
      }
      cluster_sync();
    }
    // a single block's h tile is visible after the first slab's hand-over

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
      float acc[MT][G][4][4];  // slots r, z, xn, hn
      const int t_next = k + 1 < len ? (reverse ? t - 1 : t + 1) : kRev;
      step_gates<kGruGates, G, MT>(
          acc, ring, n, t, t_next, h_cur, bias_s, hc, ug0, lane,
          [&]() {
            if constexpr (!kCl) copy_h_prev(h_cur, t, 0, h_dim);
          },
          [&]() {
            if constexpr (kCl) {
              if (k > 0) cluster_wait();  // the other ranks' h
              copy_h_prev(h_cur, t, u_off, hc);
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
              const float rg = sigmoid_f32(acc[mt][gi][0][i]);
              const float zg = sigmoid_f32(acc[mt][gi][1][i]);
              const float ng =
                  tanhf(acc[mt][gi][2][i] + rg * acc[mt][gi][3][i]);
              const float hp = h[mt][gi][i];
              pl[0][i] = hp;
              pl[1][i] = rg;
              pl[2][i] = zg;
              pl[3][i] = ng;
              pl[4][i] = acc[mt][gi][3][i];
              hn[i] = (1.0f - zg) * ng + zg * hp;
              if (mb >> (mt * 2 + (i >> 1)) & 1u) h[mt][gi][i] = hn[i];
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
    __syncthreads();  // the recompute's tiles give way to the slots tile

    // --- reverse pass over the chunk --------------------------------------
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        f4_to(dh[mt][gi],
              q > 0 ? ld_global_f4(park + (size_t)(mt * G + gi) * kThreads)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float4 v =
            q > 0 ? ld_global_f4(park + (size_t)(MT * G + 2 * gi + p) *
                                            kThreads)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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
      float dhz[MT][G][4];  // dh' * z, the carried part of dh
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int unit = (ug0 + gi) * 8 + 2 * tg;
          float d[4][4];  // [slot][cell]
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
#pragma unroll
            for (int i = 0; i < 4; ++i) d[qq][i] = 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) dhz[mt][gi][i] = 0.0f;
          if (unit < hc) {
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
                    const float hp = pl[0][i], rg = pl[1][i], zg = pl[2][i];
                    const float ng = pl[3][i], hn = pl[4][i];
                    const float dh_new = (u ? dov.y : dov.x) + dh[mt][gi][i];
                    const float dz = dh_new * (hp - ng);
                    const float da_n = dh_new * (1.0f - zg) * (1.0f - ng * ng);
                    d[0][i] = da_n * hn * rg * (1.0f - rg);
                    d[1][i] = dz * zg * (1.0f - zg);
                    d[2][i] = da_n;
                    d[3][i] = da_n * rg;
                    dhz[mt][gi][i] = dh_new * zg;
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
      __syncthreads();  // the slots tile is whole

      // the slots of (row, t) for phase B: a single block's rows are whole
      // rows of the workspace; a rank's are its columns of each slot
      if constexpr (kCl) {
        const int cpr = hc / kPer;
        for (int idx = threadIdx.x; idx < M * 4 * cpr; idx += kThreads) {
          const int r = idx / (4 * cpr), rest = idx - r * 4 * cpr;
          const int qq = rest / cpr, cc = rest - qq * cpr;
          if (row0 + r < n_rows)
            *reinterpret_cast<uint4*>(
                dg_ws + ((size_t)(row0 + r) * n_steps + t) * g4 +
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
                dg_ws + ((size_t)(row0 + r) * n_steps + t) * g4 +
                cc * kPer) =
                *reinterpret_cast<const uint4*>(dg_tile + r * ss + cc * 16);
        }
      }
      // a cluster: every rank is done reading its dh partials of the step
      // before, so this step's may land
      if constexpr (kCl) cluster_sync();

      // dx_t = slots 0..2 @ W_ih^T and slots {0, 1, 3} @ W_hh^T: a slab's
      // ks rows are ks output columns; a warp takes 16 rows x 16 columns.
      // In a cluster a block's slots are those of its units, so its
      // products are partials: dx is left to phase C, and the dh partial
      // of unit u goes to rank u / hc, into its row block of this rank.
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
        // the third k-block: slot 2 (da_n) against W_in, slot 3 (da_n * r)
        // against W_hn
        const int shift = is_x ? 0 : hc;
        // a warp takes a tile of 16 rows x 16 columns (8 in float32's
        // 8-row slabs); float32 splits a tile's k extent over the warps the
        // tiles leave idle, `parts` a tile, whose partials the first adds in
        // warp order through `red`
        if (warp < units * parts) {
          const int wu = warp % units, part = warp / units;
          const int mt = wu % MT, np = wu / MT;
          const int k_steps = gk / E::kK;
          const int k_lo = part * k_steps / parts * E::kK;
          const int k_hi = (part + 1) * k_steps / parts * E::kK;
          float o[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
          const char* a_base =
              dg_tile + (mt * 16 + (lane & 15)) * ss + (lane >> 4) * 16;
          const char* b_base = slab + (np * 16 + b_n) * ring.ws + b_k;
          if constexpr (kE == 4) {
            tf32_rev_product(o, a_base, b_base, k_lo, k_hi, one,
                             [&](int kk) {
                               return kk < 2 * hc ? kk : kk + shift;
                             });
          } else {
#pragma unroll 4
            for (int kk = k_lo; kk < k_hi; kk += E::kK) {
              const int ka = kk < 2 * hc ? kk : kk + shift;
              uint32_t af[4], bfr[4];
              ldsm_x4(af, a_base + ka * 2);
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
      // dh's product is whole (a cluster: every rank's partials have
      // landed); every warp is done with the slots
      if constexpr (kCl)
        cluster_sync();
      else
        __syncthreads();

      // dh = (1 - m) dh + m (dh' z + slots {0, 1, 3} @ W_hh^T); a cluster
      // adds its ranks' partials in rank order, then dh' z
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
                dh[mt][gi][half * 2] = v.x + dhz[mt][gi][half * 2];
                dh[mt][gi][half * 2 + 1] = v.y + dhz[mt][gi][half * 2 + 1];
              }
          }
        }
    }

    // park the carried state for the next chunk's reverse pass
    if (q + 1 < n_chunks) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          st_global_f4(park + (size_t)(mt * G + gi) * kThreads,
                       f4_of(dh[mt][gi]));
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          st_global_f4(park + (size_t)(MT * G + 2 * gi + p) * kThreads,
                       make_float4(dbs[gi][2 * p][0], dbs[gi][2 * p][1],
                                   dbs[gi][2 * p + 1][0],
                                   dbs[gi][2 * p + 1][1]));
    }
  }

  // per-block slot sums: a column's cells all sit in one warp; add its
  // eight row lanes in a fixed order
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

// 16-row tiles a block of the bf16 phase A takes for n_rows rows: the
// tiles' own layout (pick_config), unless that gives fewer blocks than
// kSmallGrid (one H100's SMs): then 16-row blocks, four times as many, each
// walking the same T steps with a quarter of the rows.  `forced` (1 or the
// layout's own, for timing the two) overrides the rule; -1: not a choice.
// A cluster's ranks (H above kGruMaxSingle) take 16 rows, as pick_config
// gives every H above 256.  `bwd_row_tiles` in ops/kernels/gru.py states the
// same rule.
constexpr int kSmallGrid = 132;

int bwd_row_tiles(int h_dim, int n_rows, int forced) {
  const int own = tiles::pick_config(h_dim).mt;
  if (forced != 0) return forced == 1 || forced == own ? forced : -1;
  const long long blocks = ((long long)n_rows + 16 * own - 1) / (16 * own);
  return blocks < kSmallGrid ? 1 : own;
}

// Byte offsets of the workspace regions (each 256-B aligned).  `mt`: phase
// A's 16-row tiles per block (its rows per block and activation planes):
// bf16 bwd_row_tiles's, float32 pick_config_f32's, a cluster's ranks 1; 0
// on the step route.  A row block of `c` blocks (a cluster when c > 1;
// gru_cluster for bf16, f32_cluster for float32) has one activation area
// per block and one db partial per row block.  The step route (`step`,
// above H = 1,024) keeps its planes [tc][kGruStepSaved][rows, H] where the
// activation areas lie, one db partial per kDgRows rows, and after phase
// B's partials its own buffers (lstm_step.cuh's StepBwd): h in turn, bf16's
// f32 h, dh, dh' z and the unit tiles' dh partials.
struct Layout {
  int row_blocks, n_blocks, c, splits, rows_per_split;
  bool step;
  size_t act, dg, h_prev, db_part, part_ih, part_hh, hbuf, h32, dh, dhz,
      partial, total;
};

Layout layout(int n_rows, int n_steps, int e, int h_dim, int tc, size_t elt,
              int mt) {
  Layout L;
  const long long n = (long long)n_rows * n_steps;
  const bool bf16 = elt == 2;
  L.step = tiles::gru_route(h_dim, bf16) == tiles::kRouteStep;
  L.c = L.step ? 1 : bf16 ? tiles::gru_cluster(h_dim) : f32_cluster(h_dim);
  const int m_rows = L.step ? kDgRows : 16 * mt;
  L.row_blocks = (n_rows + m_rows - 1) / m_rows;
  L.n_blocks = L.row_blocks * L.c;
  const Splits sp = make_splits(n);
  L.splits = sp.splits;
  L.rows_per_split = sp.rows_per_split;
  const size_t plane = (size_t)n_rows * h_dim;
  const size_t g3 = 3 * (size_t)h_dim, g4 = 4 * (size_t)h_dim;
  size_t off = 0;
  L.act = off;
  const int g = bf16 ? (L.c > 1 ? tiles::kClusterConfig.g
                               : tiles::pick_config(h_dim).g)
                : L.c > 1 ? tiles::cluster_config_f32(L.c).g
                          : tiles::pick_config_f32(h_dim).g;
  off += align256(L.step ? (size_t)tc * kGruStepSaved * plane * 4
                         : (size_t)L.n_blocks *
                               (tc * mt * g * kPlanes + park_slots(g, mt)) *
                               tiles::kThreads * 16);
  L.dg = off;
  off += align256((size_t)n * g4 * elt);
  L.h_prev = off;
  off += align256((size_t)n * h_dim * elt);
  L.db_part = off;
  off += align256((size_t)L.row_blocks * g4 * 4);
  L.part_ih = off;
  off += align256((size_t)L.splits * e * g3 * 4);
  L.part_hh = off;
  off += align256((size_t)L.splits * h_dim * g3 * 4);
  const size_t step_plane = L.step ? align256(plane * 4) : 0;
  L.hbuf = off;
  off += L.step ? align256(2 * plane * elt) : 0;
  L.h32 = off;
  off += bf16 ? step_plane : 0;
  L.dh = off;
  off += step_plane;
  L.dhz = off;
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

// the step route (above H = 1,024): step_shape_ok (bf16 E a multiple of 32
// and H of 256); up to it the tensor-core tiles: bf16 their shapes
// (gru_tiles_ok) and shared memory -- the layout's own tiles fit a block's,
// whatever tile the row count then takes, so the limit is one of E and H
// alone; float32 (split TF32) E and H multiples of 32, a cluster's ranks'
// units of 16 (f32_cluster), whose shared memory fits
bool shape_ok(int e, int h_dim, int dtype) {
  if (tiles::gru_route(h_dim, dtype == 1) == tiles::kRouteStep)
    return step_shape_ok(e, h_dim, dtype);
  int ks = 0;
  if (dtype == 0) {
    const int c = f32_cluster(h_dim);
    if (c == 0 || e % tiles::kAlign != 0 || h_dim % tiles::kAlign != 0 ||
        h_dim % (16 * c) != 0)
      return false;
    const int mt = c > 1 ? tiles::cluster_config_f32(c).mt
                         : tiles::pick_config_f32(h_dim).mt;
    return tiles::mma_smem(h_dim, h_dim / c, tiles::kGruGates, 16 * mt, true,
                           c, &ks, 4) != 0;
  }
  if (dtype != 1 || !tiles::gru_tiles_ok(e, h_dim)) return false;
  const int c = tiles::gru_cluster(h_dim);
  const int mt = c > 1 ? tiles::kClusterConfig.mt
                       : tiles::pick_config(h_dim).mt;
  return tiles::mma_smem(h_dim, h_dim / c, tiles::kGruGates, 16 * mt, true,
                         c, &ks) != 0;
}

// phase A up to H = 1,024: tensor cores (float32: split TF32)
template <typename T, int G, int MT, bool kCl>
int launch_mma(const void* x, const void* mask, const void* w_staged,
               const void* b_ih, const void* b_hh, const void* hb,
               const void* dout, void* dx, T* dg, T* h_prev, float* act,
               float* db_part, const Layout& L, int n_rows, int n_steps,
               int e, int h_dim, int reverse, int tc, cudaStream_t stream) {
  int ks = 0;
  const size_t smem =
      tiles::mma_smem(h_dim, h_dim / L.c, tiles::kGruGates, 16 * MT, true,
                      L.c, &ks, (int)sizeof(T));
  if (smem == 0) return (int)cudaErrorInvalidValue;  // H too large
  return (int)launch_blocks(
      gru_bwd_mma_kernel<T, G, MT, kCl>, L.row_blocks, L.c, tiles::kThreads,
      smem, stream, static_cast<const T*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(w_staged),
      static_cast<const T*>(b_ih), static_cast<const T*>(b_hh),
      static_cast<const float*>(hb), static_cast<const T*>(dout),
      static_cast<T*>(dx), dg, h_prev, reinterpret_cast<float4*>(act),
      db_part, n_rows, n_steps, e, h_dim, reverse, tc, ks);
}

template <typename T>
int launch(const void* x, const void* mask, const void* w_ih,
           const void* b_ih, const void* w_hh, const void* b_hh,
           const void* w_dx, const void* w_hh_t, const void* hb,
           const void* dout, void* dx, void* dw_ih, void* db_ih, void* dw_hh,
           void* db_hh, void* workspace, int n_rows, int n_steps, int e,
           int h_dim, int reverse, int tc, int mt, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const Layout L = layout(n_rows, n_steps, e, h_dim, tc, sizeof(T), mt);
  char* ws = static_cast<char*>(workspace);
  T* dg = reinterpret_cast<T*>(ws + L.dg);
  T* h_prev = reinterpret_cast<T*>(ws + L.h_prev);
  float* act = reinterpret_cast<float*>(ws + L.act);
  float* db_part = reinterpret_cast<float*>(ws + L.db_part);
  float* part_ih = reinterpret_cast<float*>(ws + L.part_ih);
  float* part_hh = reinterpret_cast<float*>(ws + L.part_hh);
  const int g3 = 3 * h_dim;
  const int g4 = 4 * h_dim;
  const int n = n_rows * n_steps;
  cudaError_t err;

  if (n_rows > 0 && n_steps > 0) {
    int rc = (int)cudaErrorInvalidValue;
    // the tiles' bulk and 16-byte copies (the float32 step route reads its
    // operands as they lie)
    if ((kBf16 || !L.step) &&
        (!tiles::aligned16(x) || !tiles::aligned16(w_ih) ||
         !tiles::aligned16(hb) || !tiles::aligned16(dout) ||
         !tiles::aligned16(dx) || !tiles::aligned16(workspace)))
      return rc;
    if (L.step) {
      const StepBwd sb = {ws + L.hbuf, nullptr,
                          kBf16 ? reinterpret_cast<float*>(ws + L.h32)
                                : nullptr,
                          act, reinterpret_cast<float*>(ws + L.dh),
                          reinterpret_cast<float*>(ws + L.dhz),
                          reinterpret_cast<float*>(ws + L.partial), db_part,
                          dg, h_prev};
      rc = step_phase_a(x, mask, w_ih, b_ih, b_hh, w_hh, w_hh_t, hb, nullptr,
                        dout, sb, n_rows, n_steps, e, h_dim, reverse, tc,
                        tiles::kGruGates, kBf16 ? 1 : 0, stream);
    } else if (L.c > 1) {
      if constexpr (kBf16)
        rc = launch_mma<T, tiles::kClusterConfig.g, tiles::kClusterConfig.mt,
                        true>(x, mask, w_ih, b_ih, b_hh, hb, dout, dx, dg,
                              h_prev, act, db_part, L, n_rows, n_steps, e,
                              h_dim, reverse, tc, stream);
      else if (mt == 2)
        rc = launch_mma<T, 2, 2, true>(x, mask, w_ih, b_ih, b_hh, hb, dout,
                                       dx, dg, h_prev, act, db_part, L,
                                       n_rows, n_steps, e, h_dim, reverse,
                                       tc, stream);
      else
        rc = launch_mma<T, 2, 1, true>(x, mask, w_ih, b_ih, b_hh, hb, dout,
                                       dx, dg, h_prev, act, db_part, L,
                                       n_rows, n_steps, e, h_dim, reverse,
                                       tc, stream);
    } else {
      const tiles::Config cfg = kBf16 ? tiles::pick_config(h_dim)
                                      : tiles::pick_config_f32(h_dim);
#define CAIR_GRU_BWD_CASE(G_, MT_)                                           \
  if (cfg.g == G_ && mt == MT_)                                              \
    rc = launch_mma<T, G_, MT_, false>(x, mask, w_ih, b_ih, b_hh, hb, dout,  \
                                       dx, dg, h_prev, act, db_part, L,      \
                                       n_rows, n_steps, e, h_dim, reverse,   \
                                       tc, stream);
      if constexpr (kBf16) {
        CAIR_GRU_BWD_CASE(1, 4)
        CAIR_GRU_BWD_CASE(2, 4)
        CAIR_GRU_BWD_CASE(4, 2)
        CAIR_GRU_BWD_CASE(8, 1)
        CAIR_GRU_BWD_CASE(1, 1)
        CAIR_GRU_BWD_CASE(2, 1)
        CAIR_GRU_BWD_CASE(4, 1)
      } else {
        CAIR_GRU_BWD_CASE(1, 4)
        CAIR_GRU_BWD_CASE(2, 2)
      }
#undef CAIR_GRU_BWD_CASE
    }
    if (rc != 0) return rc;
    if (L.c > 1 || L.step) {
      // phase C: a cluster's (the step route's) dx = slots 0..2 @ W_ih^T
      // (rows of four slots); float32 reads W_ih as it lies
      if constexpr (kBf16)
        err = launch_matmul(dg, g4, static_cast<const T*>(w_dx), n, e, g3,
                            static_cast<T*>(dx), stream);
      else
        err = launch_matmul_tf32(dg, g4, static_cast<const float*>(w_dx), g3,
                                 n, e, g3, static_cast<float*>(dx), stream);
      if (err != cudaSuccess) return (int)err;
    }
  }

  const Splits sp = {L.splits, L.rows_per_split};
  // dW_ih [E, 3H] from slots 0..2 (launch_wgrad_partial: tensor-core tiles,
  // float32 in split TF32)
  err = launch_wgrad_partial<T>(static_cast<const T*>(x), e, dg, g3, g4, n,
                                sp, part_ih, g3, 0, stream);
  if (err != cudaSuccess) return (int)err;
  // dW_hh [H, 3H]: columns 0..2H-1 from slots 0, 1; 2H..3H-1 from slot 3
  err = launch_wgrad_partial<T>(h_prev, h_dim, dg, 2 * h_dim, g4, n, sp,
                                part_hh, g3, 0, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_wgrad_partial<T>(h_prev, h_dim, dg + g3, h_dim, g4, n, sp,
                                part_hh, g3, 2 * h_dim, stream);
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<T><<<(e * g3 + 255) / 256, 256, 0, stream>>>(
      part_ih, L.splits, e * g3, e * g3, static_cast<T*>(dw_ih));
  sum_partials_kernel<T><<<(h_dim * g3 + 255) / 256, 256, 0, stream>>>(
      part_hh, L.splits, h_dim * g3, h_dim * g3, static_cast<T*>(dw_hh));
  // db_ih = slots 0..2; db_hh = slots 0, 1 and 3
  sum_partials_kernel<T><<<(g3 + 255) / 256, 256, 0, stream>>>(
      db_part, L.row_blocks, g4, g3, static_cast<T*>(db_ih));
  sum_partials_kernel<T><<<(2 * h_dim + 255) / 256, 256, 0, stream>>>(
      db_part, L.row_blocks, g4, 2 * h_dim, static_cast<T*>(db_hh));
  sum_partials_kernel<T><<<(h_dim + 255) / 256, 256, 0, stream>>>(
      db_part + g3, L.row_blocks, g4, h_dim,
      static_cast<T*>(db_hh) + 2 * h_dim);
  return (int)cudaGetLastError();
}

// The 16-row tiles per block of phase A for these arguments (0 on the step
// route), or -1 if they are invalid: float32 and the step route take no
// tile choice (row_tiles 0; float32 pick_config_f32's, a cluster's ranks
// 1); bfloat16 needs the tiles' shapes (shape_ok).
int row_tiles_of(int n_rows, int n_steps, int e, int h_dim, int tc,
                 int dtype, int row_tiles) {
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc) ||
      !shape_ok(e, h_dim, dtype))
    return -1;
  if (tiles::gru_route(h_dim, dtype == 1) == tiles::kRouteStep)
    return row_tiles == 0 ? 0 : -1;
  if (dtype == 0) {
    if (row_tiles != 0) return -1;
    const int c = f32_cluster(h_dim);
    return c > 1 ? tiles::cluster_config_f32(c).mt
                 : tiles::pick_config_f32(h_dim).mt;
  }
  return bwd_row_tiles(h_dim, n_rows, row_tiles);
}

}  // namespace

// Bytes of workspace cair_gru_bwd needs for these shapes, or -1 if they are
// invalid (dtype 0 = float32, 1 = bfloat16; row_tiles as for cair_gru_bwd).
extern "C" long long cair_gru_bwd_workspace(int n_rows, int n_steps, int e,
                                            int h_dim, int tc, int dtype,
                                            int row_tiles) {
  const int mt = row_tiles_of(n_rows, n_steps, e, h_dim, tc, dtype,
                              row_tiles);
  if (mt < 0) return -1;
  return (long long)layout(n_rows, n_steps, e, h_dim, tc, dtype == 0 ? 4 : 2,
                           mt)
      .total;
}

// Kernel 9.  x [B, T, E], mask uint8 [B, T], w_ih [E, 3H], b_ih [3H],
// w_hh [H, 3H], b_hh [3H], w_dx and w_hh_t [3H, H] (W_hh's transpose), hb
// float32 [ceil(T / tc), B, H] from cair_gru_fwd_res, dout [B, T, H] ->
// dx [B, T, E], dw_ih [E, 3H], db_ih [3H], dw_hh [H, 3H], db_hh [3H]; one
// dtype for all but mask and hb; `workspace` holds
// cair_gru_bwd_workspace(...) bytes.  Up to H = 1,024 (both dtypes) and
// on the bf16 step route, `w_ih` points at the staged weights as
// cair_gru_fwd (cair_gru_step) takes them (one matrix a rank of a cluster
// -- bf16 above H = 448, float32 above 256 -- or a unit tile of 256), and
// `w_hh`, `w_hh_t` are not read; E and H are multiples of 32 (bf16 64 in
// a cluster of 4, float32 16 C in a cluster of C, 256 on the bf16 step
// route); the float32 step route reads w_ih and w_hh as given and w_hh_t.
// `w_dx` is read by a cluster's (the step route's) dx product alone: bf16
// W_ih^T [3H, E], float32 W_ih itself.  row_tiles: bf16 0 (the rule of
// bwd_row_tiles), 1 or the tiles' own (for timing; the step route takes
// 0); float32 0.  Returns the first cudaError_t (0 on success).
extern "C" int cair_gru_bwd(const void* x, const void* mask,
                            const void* w_ih, const void* b_ih,
                            const void* w_hh, const void* b_hh,
                            const void* w_dx, const void* w_hh_t,
                            const void* hb, const void* dout, void* dx,
                            void* dw_ih, void* db_ih, void* dw_hh,
                            void* db_hh, void* workspace, int n_rows,
                            int n_steps, int e, int h_dim, int reverse,
                            int tc, int dtype, int row_tiles, void* stream) {
  const int mt = row_tiles_of(n_rows, n_steps, e, h_dim, tc, dtype,
                              row_tiles);
  if (mt < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, w_ih, b_ih, w_hh, b_hh, w_dx, w_hh_t, hb,
                         dout, dx, dw_ih, db_ih, dw_hh, db_hh, workspace,
                         n_rows, n_steps, e, h_dim, reverse, tc, mt, s);
  return launch<__nv_bfloat16>(x, mask, w_ih, b_ih, w_hh, b_hh, w_dx,
                               w_hh_t, hb, dout, dx, dw_ih, db_ih, dw_hh,
                               db_hh, workspace, n_rows, n_steps, e, h_dim,
                               reverse, tc, mt, s);
}
