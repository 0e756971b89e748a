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
//   tiles (bf16: 128 x 128 on tensor cores; float32: 64 x 64 of f32 FMAs),
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
// ring, x double-buffered by `cp.async`, the n gate's x @ W_in and
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
// float32 keeps exact f32 FMAs (no TF32) on the first version's layout
// (gru_bwd_cell_kernel: one block per 32 rows, thread (rg, j) owning unit j
// of 16 rows, five activation planes, host-made transposes of the weights
// for the dx and dh products) and wgrad_partial_kernel.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"

namespace {

using namespace cair_lstm;

constexpr int kSaved = 5;  // per step: h_prev, r, z, n, hn

// kBound: the launch bound (row_tile_bound)
template <typename T, int kBound>
__global__ void __launch_bounds__(kBound)
gru_bwd_cell_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                    const T* __restrict__ w_ih, const T* __restrict__ b_ih,
                    const T* __restrict__ w_hh, const T* __restrict__ b_hh,
                    const T* __restrict__ w_ih_t, const T* __restrict__ w_hh_t,
                    const float* __restrict__ hb, const T* __restrict__ dout,
                    T* __restrict__ dx, T* __restrict__ dg_ws,
                    T* __restrict__ h_prev_ws, float* __restrict__ act,
                    float* __restrict__ db_part, int n_rows, int n_steps, int e,
                    int h_dim, int reverse, int tc) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);

  const int j = threadIdx.x % h_dim;
  const int rg = threadIdx.x / h_dim;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;
  const int g3 = 3 * h_dim;
  const int g4 = 4 * h_dim;
  const int n_chunks = (n_steps + tc - 1) / tc;
  const size_t plane = (size_t)kRows * h_dim;
  const size_t act_step = kSaved * plane;
  float* my_act = act + (size_t)blockIdx.x * tc * act_step;

  float bx[3], bh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bx[g] = to_f32(b_ih[g * h_dim + j]);
    bh[g] = to_f32(b_hh[g * h_dim + j]);
  }
  float dh[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) dh[i] = 0.0f;
  float dbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int q = 0; q < n_chunks; ++q) {
    // chunks in the reverse of the forward's processing order
    const int chunk = reverse ? q : n_chunks - 1 - q;
    const int t_lo = chunk * tc;
    const int len = min(tc, n_steps - t_lo);

    // --- recompute the forward inside the chunk from its boundary -------
    float h[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      h[i] = row < n_rows ? hb[((size_t)chunk * n_rows + row) * h_dim + j]
                          : 0.0f;
    }
    for (int k = 0; k < len; ++k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      float ax[3][kRowsPerThread], ah[3][kRowsPerThread];
      stage_x_h<T>(tile, x, h, row0, n_rows, n_steps, t, e, j, rg);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          ax[g][i] = bx[g];
          ah[g][i] = bh[g];
        }
      }
      dot_rows<3, T>(ax, tile, 0, rg, w_ih + j, e, g3, h_dim);
      dot_rows<3, T>(ah, tile, e, rg, w_hh + j, h_dim, g3, h_dim);
      float* a_k = my_act + k * act_step;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = my_row0 + i;
        if (row < n_rows) {
          const size_t pos = (size_t)row * n_steps + t;
          const float r = sigmoid_f32(ax[0][i] + ah[0][i]);
          const float z = sigmoid_f32(ax[1][i] + ah[1][i]);
          const float hn = ah[2][i];
          const float n = tanhf(ax[2][i] + r * hn);
          const float h_new = (1.0f - z) * n + z * h[i];
          h_prev_ws[pos * h_dim + j] = from_f32<T>(h[i]);
          const size_t at = (size_t)(rg * kRowsPerThread + i) * h_dim + j;
          a_k[at] = h[i];
          a_k[plane + at] = r;
          a_k[2 * plane + at] = z;
          a_k[3 * plane + at] = n;
          a_k[4 * plane + at] = hn;
          if (mask[pos] != 0) h[i] = h_new;
        }
      }
      __syncthreads();  // the next step overwrites the staged tile
    }

    // --- reverse pass over the chunk --------------------------------------
    for (int k = len - 1; k >= 0; --k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      const float* a_k = my_act + k * act_step;
      float dg[4][kRowsPerThread];
      float dh_z[kRowsPerThread];
      uint32_t valid = 0;  // bit i: row i is real and step t unmasked
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = my_row0 + i;
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f, dz_h = 0.0f;
        if (row < n_rows) {
          const size_t pos = (size_t)row * n_steps + t;
          if (mask[pos] != 0) {
            valid |= 1u << i;
            const size_t at = (size_t)(rg * kRowsPerThread + i) * h_dim + j;
            const float h_prev = a_k[at];
            const float r = a_k[plane + at];
            const float z = a_k[2 * plane + at];
            const float n = a_k[3 * plane + at];
            const float hn = a_k[4 * plane + at];
            const float dh_new = to_f32(dout[pos * h_dim + j]) + dh[i];
            const float dz = dh_new * (h_prev - n);
            const float da_n = dh_new * (1.0f - z) * (1.0f - n * n);
            d0 = da_n * hn * r * (1.0f - r);
            d1 = dz * z * (1.0f - z);
            d2 = da_n;
            d3 = da_n * r;
            dz_h = dh_new * z;
          }
          T* dst = dg_ws + pos * g4 + j;
          dst[0] = from_f32<T>(d0);
          dst[h_dim] = from_f32<T>(d1);
          dst[2 * h_dim] = from_f32<T>(d2);
          dst[3 * h_dim] = from_f32<T>(d3);
        }
        dg[0][i] = d0;
        dg[1][i] = d1;
        dg[2][i] = d2;
        dg[3][i] = d3;
        dh_z[i] = dz_h;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float v[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          dbs[g] += dg[g][i];
          v[i] = round_to<T>(dg[g][i]);
        }
        store_rows(tile, g * h_dim + j, rg, v);
      }
      __syncthreads();

      // dh = dh' z + dg_hh_c @ W_hh^T where unmasked (slots r, z against
      // W_hh^T rows 0..2H-1, slot 3 against rows 2H..3H-1); masked steps
      // carry dh
      {
        float acc[1][kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[0][i] = dh_z[i];
        dot_rows<1, T>(acc, tile, 0, rg, w_hh_t + j, 2 * h_dim, h_dim, 0);
        dot_rows<1, T>(acc, tile, g3, rg, w_hh_t + (size_t)2 * h_dim * h_dim
                       + j, h_dim, h_dim, 0);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          if (valid & (1u << i)) dh[i] = acc[0][i];
      }
      // dx_t = dg_ih_c @ W_ih^T (slots 0..2), columns j, j + H, ...
      for (int col = j; col < e; col += h_dim) {
        float acc[1][kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[0][i] = 0.0f;
        dot_rows<1, T>(acc, tile, 0, rg, w_ih_t + col, g3, e, 0);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = my_row0 + i;
          if (row < n_rows)
            dx[((size_t)row * n_steps + t) * e + col] = from_f32<T>(acc[0][i]);
        }
      }
      __syncthreads();  // the next step overwrites the staged gradients
    }
  }

  // per-block slot sums: the two row groups' sums, in a fixed order
#pragma unroll
  for (int g = 0; g < 4; ++g) tile[rg * g4 + g * h_dim + j] = dbs[g];
  __syncthreads();
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = g * h_dim + j;
      db_part[(size_t)blockIdx.x * g4 + col] = tile[col] + tile[g4 + col];
    }
  }
}

// Phase A on bf16 tensor cores (see the header note).  Shared memory:
// weight ring (mbarriers, slabs) | union of {x tile twice, h tile}
// (recompute) and {slots tile, dh exchange (f32, rows h + 8 floats apart)}
// (reverse pass) | bias slots r, z, xn, hn (f32).
constexpr int kPlanes = 5;  // per cell and step: h_prev, r, z, n, hn

template <int G, int MT>
__global__ void __launch_bounds__(tiles::kThreads, 1)
gru_bwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ w_staged,
                   const __nv_bfloat16* __restrict__ b_ih,
                   const __nv_bfloat16* __restrict__ b_hh,
                   const float* __restrict__ hb,
                   const __nv_bfloat16* __restrict__ dout,
                   __nv_bfloat16* __restrict__ dx,
                   __nv_bfloat16* __restrict__ dg_ws,
                   __nv_bfloat16* __restrict__ h_prev_ws,
                   float4* __restrict__ act, float* __restrict__ db_part,
                   int n_rows, int n_steps, int e, int h_dim, int reverse,
                   int tc, int ks) {
  using namespace tiles;
  extern __shared__ __align__(16) char smem[];
  constexpr int M = 16 * MT;
  const int xs = x_stride(e), hs = h_stride(h_dim), ss = slot_stride(h_dim);
  const int g3 = 3 * h_dim, g4 = 4 * h_dim;
  const int ex_ld = h_dim + 8;  // floats per row of the dh exchange
  WeightRing ring;
  ring.init(smem, w_staged, e, h_dim, kGruGates, ks, 2LL * n_steps);
  char* uni = ring.base + kStages * ring.slab_bytes;
  char* xbuf[2];
  xbuf[0] = uni;
  xbuf[1] = uni + M * xs;
  char* h_tile = uni + 2 * M * xs;
  char* dg_tile = uni;
  float* exch = reinterpret_cast<float*>(uni + M * ss);
  float* bias_s = reinterpret_cast<float*>(
      uni + staged_bytes(e, h_dim, kGruGates, M, true));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;
  const int row0 = blockIdx.x * M;
  const int n_chunks = (n_steps + tc - 1) / tc;
  // the block's activation planes: [tc][MT * G * kPlanes][kThreads] float4
  constexpr int kSlots = MT * G * kPlanes;
  float4* my_act =
      act + (size_t)blockIdx.x * tc * kSlots * kThreads + threadIdx.x;

  for (int i = threadIdx.x; i < h_dim; i += kThreads) {
#pragma unroll
    for (int q = 0; q < 2; ++q)  // r, z: both biases
      bias_s[q * h_dim + i] = __bfloat162float(b_ih[q * h_dim + i]) +
                              __bfloat162float(b_hh[q * h_dim + i]);
    bias_s[2 * h_dim + i] = __bfloat162float(b_ih[2 * h_dim + i]);  // xn
    bias_s[3 * h_dim + i] = __bfloat162float(b_hh[2 * h_dim + i]);  // hn
  }

  float dh[MT][G][4], dbs[G][4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) dh[mt][gi][i] = 0.0f;
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int q = 0; q < 4; ++q) dbs[gi][q][0] = dbs[gi][q][1] = 0.0f;

  unsigned live = 0;  // bit mt*2 + half: row mt*16 + g + half*8 is real
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (row0 + mt * 16 + g + half * 8 < n_rows) live |= 1u << (mt * 2 + half);

  ring.prologue();
  long long n = 0;

  for (int q = 0; q < n_chunks; ++q) {
    // chunks in the reverse of the forward's processing order
    const int chunk = reverse ? q : n_chunks - 1 - q;
    const int t_lo = chunk * tc;
    const int len = min(tc, n_steps - t_lo);

    // --- recompute the forward inside the chunk from its boundary -------
    __syncthreads();  // the last reverse step is done with the union
    float h[MT][G][4];  // the carried state, f32
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int unit = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + half * 8;
          float2 hv = make_float2(0.0f, 0.0f);
          if (unit < h_dim && (live >> (mt * 2 + half) & 1u))
            hv = *reinterpret_cast<const float2*>(
                hb + ((size_t)chunk * n_rows + row0 + r) * h_dim + unit);
          h[mt][gi][half * 2] = hv.x;
          h[mt][gi][half * 2 + 1] = hv.y;
          if (unit < h_dim)
            *reinterpret_cast<bf162*>(h_tile + r * hs + unit * 2) =
                __floats2bfloat162_rn(hv.x, hv.y);
        }
      }
    load_x_tile(xbuf[0], x, row0, M, n_rows, n_steps,
                reverse ? t_lo + len - 1 : t_lo, e);
    cp_async_commit();
    cp_async_wait<0>();  // visible after the first slab's hand-over

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

      float acc[MT][G][4][4];  // slots r, z, xn, hn
      step_gates<kGruGates, G, MT>(
          acc, ring, n, xbuf[k & 1], h_tile, bias_s, ug0, lane, [&]() {
            if (k + 1 < len)
              load_x_tile(xbuf[(k + 1) & 1], x, row0, M, n_rows, n_steps,
                          reverse ? t - 1 : t + 1, e);
            // h before this step, rounded: phase B's operand for dW_hh
            const int cpr = h_dim / 8;
            for (int idx = threadIdx.x; idx < M * cpr; idx += kThreads) {
              const int r = idx / cpr, cc = idx - r * cpr;
              if (row0 + r < n_rows)
                *reinterpret_cast<uint4*>(
                    h_prev_ws +
                    ((size_t)(row0 + r) * n_steps + t) * h_dim + cc * 8) =
                    *reinterpret_cast<const uint4*>(h_tile + r * hs + cc * 16);
            }
          });
      __syncthreads();  // every warp has read the h tile of this step

      float4* a_k = my_act + (size_t)k * kSlots * kThreads;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int unit = (ug0 + gi) * 8 + 2 * tg;
          if (unit < h_dim) {
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
            for (int half = 0; half < 2; ++half)
              if (mb >> (mt * 2 + half) & 1u)
                *reinterpret_cast<bf162*>(
                    h_tile + (mt * 16 + g + half * 8) * hs + unit * 2) =
                    __floats2bfloat162_rn(hn[half * 2], hn[half * 2 + 1]);
          }
        }
    }
    __syncthreads();  // the recompute's tiles give way to the slots tile

    // --- reverse pass over the chunk --------------------------------------
    for (int k = len - 1; k >= 0; --k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
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
          if (unit < h_dim) {
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
                          unit));
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
                *reinterpret_cast<bf162*>(dg_tile +
                                          (mt * 16 + g + half * 8) * ss +
                                          (qq * h_dim + unit) * 2) =
                    __floats2bfloat162_rn(d[qq][half * 2], d[qq][half * 2 + 1]);
            }
          }
        }
      __syncthreads();  // the slots tile is whole

      // the slots of (row, t) for phase B
      {
        const int cpr = g4 / 8;
        for (int idx = threadIdx.x; idx < M * cpr; idx += kThreads) {
          const int r = idx / cpr, cc = idx - r * cpr;
          if (row0 + r < n_rows)
            *reinterpret_cast<uint4*>(
                dg_ws + ((size_t)(row0 + r) * n_steps + t) * g4 + cc * 8) =
                *reinterpret_cast<const uint4*>(dg_tile + r * ss + cc * 16);
        }
      }

      // dx_t = slots 0..2 @ W_ih^T and slots {0, 1, 3} @ W_hh^T: a slab's
      // ks rows are ks output columns; a warp takes 16 rows x 16 columns
      const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
      for (int sl = 0; sl < ring.n_slabs; ++sl, ++n) {
        const char* slab = ring.acquire(n);
        cp_async_commit();
        const int k0 = sl * ks;
        const bool is_x = k0 < e;
        const int col0 = is_x ? k0 : k0 - e;
        // the third k-block: slot 2 (da_n) against W_in, slot 3 (da_n * r)
        // against W_hn
        const int shift = is_x ? 0 : h_dim;
        for (int wu = warp; wu < MT * (ks / 16); wu += kWarps) {
          const int mt = wu % MT, np = wu / MT;
          float o[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
          const char* a_base =
              dg_tile + (mt * 16 + (lane & 15)) * ss + (lane >> 4) * 16;
          const char* b_base = slab + (np * 16 + b_n) * ring.ws + b_k * 2;
#pragma unroll 4
          for (int kk = 0; kk < g3; kk += 16) {
            const int ka = kk < 2 * h_dim ? kk : kk + shift;
            uint32_t af[4], bfr[4];
            ldsm_x4(af, a_base + ka * 2);
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
              if (is_x) {
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
      __syncthreads();  // dh's product is whole; the slots are read

      // dh = (1 - m) dh + m (dh' z + slots {0, 1, 3} @ W_hh^T)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int unit = (ug0 + gi) * 8 + 2 * tg;
          if (unit < h_dim) {
#pragma unroll
            for (int half = 0; half < 2; ++half)
              if (mb >> (mt * 2 + half) & 1u) {
                const float2 v = *reinterpret_cast<const float2*>(
                    exch + (mt * 16 + g + half * 8) * ex_ld + unit);
                dh[mt][gi][half * 2] = v.x + dhz[mt][gi][half * 2];
                dh[mt][gi][half * 2 + 1] = v.y + dhz[mt][gi][half * 2 + 1];
              }
          }
        }
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
        if (g == 0 && unit < h_dim)
          db_part[(size_t)blockIdx.x * g4 + qq * h_dim + unit + u] = v;
      }
  }
}

// 16-row tiles a block of the bf16 phase A takes for n_rows rows: the
// tiles' own layout (pick_config), unless that gives fewer blocks than
// kSmallGrid (one H100's SMs): then 16-row blocks, four times as many, each
// walking the same T steps with a quarter of the rows.  `forced` (1 or the
// layout's own, for timing the two) overrides the rule; -1: not a choice.
// `bwd_row_tiles` in ops/kernels/gru.py states the same rule.
constexpr int kSmallGrid = 132;

int bwd_row_tiles(int h_dim, int n_rows, int forced) {
  const int own = tiles::pick_config(h_dim).mt;
  if (forced != 0) return forced == 1 || forced == own ? forced : -1;
  const long long blocks = ((long long)n_rows + 16 * own - 1) / (16 * own);
  return blocks < kSmallGrid ? 1 : own;
}

// Byte offsets of the workspace regions (each 256-B aligned).  `mt`: the
// bf16 tensor-core phase A's 16-row tiles per block (its own rows per
// block and activation planes); 0: float32's row-tile kernel.
struct Layout {
  int n_blocks, splits, rows_per_split;
  size_t act, dg, h_prev, db_part, part_ih, part_hh, total;
};

Layout layout(int n_rows, int n_steps, int e, int h_dim, int tc, size_t elt,
              int mt) {
  Layout L;
  const long long n = (long long)n_rows * n_steps;
  const int m_rows = mt ? 16 * mt : kRows;
  L.n_blocks = (n_rows + m_rows - 1) / m_rows;
  const Splits sp = make_splits(n);
  L.splits = sp.splits;
  L.rows_per_split = sp.rows_per_split;
  const size_t g3 = 3 * (size_t)h_dim, g4 = 4 * (size_t)h_dim;
  size_t off = 0;
  L.act = off;
  off += align256(mt ? (size_t)L.n_blocks * tc * mt *
                           tiles::pick_config(h_dim).g * kPlanes *
                           tiles::kThreads * 16
                     : (size_t)L.n_blocks * tc * kSaved * kRows * h_dim * 4);
  L.dg = off;
  off += align256((size_t)n * g4 * elt);
  L.h_prev = off;
  off += align256((size_t)n * h_dim * elt);
  L.db_part = off;
  off += align256((size_t)L.n_blocks * g4 * 4);
  L.part_ih = off;
  off += align256((size_t)L.splits * e * g3 * 4);
  L.part_hh = off;
  off += align256((size_t)L.splits * h_dim * g3 * 4);
  L.total = off;
  return L;
}

bool valid_shape(int n_rows, int n_steps, int e, int h_dim, int tc) {
  return n_rows >= 0 && n_steps >= 0 && e > 0 && h_dim > 0 && tc > 0;
}

// bf16: E and H multiples of 32, H <= 512
bool mma_shape(int e, int h_dim) {
  return e % tiles::kAlign == 0 && h_dim % tiles::kAlign == 0 &&
         h_dim <= tiles::kMaxHidden;
}

// bf16: the layout's own tiles fit a block's shared memory, whatever tile
// the row count then takes, so the limit is one of E and H alone
bool mma_fits(int e, int h_dim) {
  int ks = 0;
  return tiles::mma_smem(e, h_dim, tiles::kGruGates,
                         16 * tiles::pick_config(h_dim).mt, true, &ks) != 0;
}

// phase A, float32: exact f32 FMAs
int launch_cell(const void* x, const void* mask, const void* w_ih,
                const void* b_ih, const void* w_hh, const void* b_hh,
                const void* w_ih_t, const void* w_hh_t, const void* hb,
                const void* dout, void* dx, float* dg, float* h_prev,
                float* act, float* db_part, const Layout& L, int n_rows,
                int n_steps, int e, int h_dim, int reverse, int tc,
                cudaStream_t stream) {
  using T = float;
  const int g4 = 4 * h_dim;
  const int tile_rows = (e + h_dim) > g4 ? (e + h_dim) : g4;
  const size_t smem = (size_t)tile_rows * kStride * sizeof(float);
  const int bound = row_tile_bound(kRowGroups * h_dim);
  if (bound == 0) return (int)cudaErrorInvalidValue;
  auto* kernel = bound == 256   ? gru_bwd_cell_kernel<T, 256>
                 : bound == 512 ? gru_bwd_cell_kernel<T, 512>
                                : gru_bwd_cell_kernel<T, 1024>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {  // E + H or 4H too large for the shared tile
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<L.n_blocks, kRowGroups * h_dim, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b_ih),
      static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
      static_cast<const T*>(w_ih_t), static_cast<const T*>(w_hh_t),
      static_cast<const float*>(hb), static_cast<const T*>(dout),
      static_cast<T*>(dx), dg, h_prev, act, db_part, n_rows, n_steps, e,
      h_dim, reverse, tc);
  return (int)cudaGetLastError();
}

// phase A, bfloat16: tensor cores
template <int G, int MT>
int launch_mma(const void* x, const void* mask, const void* w_staged,
               const void* b_ih, const void* b_hh, const void* hb,
               const void* dout, void* dx, __nv_bfloat16* dg,
               __nv_bfloat16* h_prev, float* act, float* db_part,
               const Layout& L, int n_rows, int n_steps, int e, int h_dim,
               int reverse, int tc, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  int ks = 0;
  const size_t smem =
      tiles::mma_smem(e, h_dim, tiles::kGruGates, 16 * MT, true, &ks);
  if (smem == 0) return (int)cudaErrorInvalidValue;  // E + H too large
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_mma_kernel<G, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  gru_bwd_mma_kernel<G, MT><<<L.n_blocks, tiles::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(w_staged), static_cast<const bf16*>(b_ih),
      static_cast<const bf16*>(b_hh), static_cast<const float*>(hb),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx), dg, h_prev,
      reinterpret_cast<float4*>(act), db_part, n_rows, n_steps, e, h_dim,
      reverse, tc, ks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* mask, const void* w_ih,
           const void* b_ih, const void* w_hh, const void* b_hh,
           const void* w_ih_t, const void* w_hh_t, const void* hb,
           const void* dout, void* dx, void* dw_ih, void* db_ih, void* dw_hh,
           void* db_hh, void* workspace, int n_rows, int n_steps, int e,
           int h_dim, int reverse, int tc, int mt, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
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
  cudaError_t err;

  if (n_rows > 0 && n_steps > 0) {
    int rc = (int)cudaErrorInvalidValue;
    if constexpr (kMma) {
      if (!tiles::aligned16(x) || !tiles::aligned16(w_ih) ||
          !tiles::aligned16(hb) || !tiles::aligned16(dout) ||
          !tiles::aligned16(dx) || !tiles::aligned16(workspace))
        return rc;
      const tiles::Config cfg = tiles::pick_config(h_dim);
#define CAIR_GRU_BWD_CASE(G_, MT_)                                          \
  if (cfg.g == G_ && mt == MT_)                                             \
    rc = launch_mma<G_, MT_>(x, mask, w_ih, b_ih, b_hh, hb, dout, dx, dg,   \
                             h_prev, act, db_part, L, n_rows, n_steps, e,   \
                             h_dim, reverse, tc, stream);
      CAIR_GRU_BWD_CASE(1, 4)
      CAIR_GRU_BWD_CASE(2, 4)
      CAIR_GRU_BWD_CASE(4, 2)
      CAIR_GRU_BWD_CASE(8, 1)
      CAIR_GRU_BWD_CASE(1, 1)
      CAIR_GRU_BWD_CASE(2, 1)
      CAIR_GRU_BWD_CASE(4, 1)
#undef CAIR_GRU_BWD_CASE
    } else {
      rc = launch_cell(x, mask, w_ih, b_ih, w_hh, b_hh, w_ih_t, w_hh_t, hb,
                       dout, dx, dg, h_prev, act, db_part, L, n_rows, n_steps,
                       e, h_dim, reverse, tc, stream);
    }
    if (rc != 0) return rc;
  }

  const int n = n_rows * n_steps;
  const Splits sp = {L.splits, L.rows_per_split};
  // bf16 operands go through the tensor-core tiles, float32 stays on exact
  // f32 FMAs (launch_wgrad_partial).  dW_ih [E, 3H] from slots 0..2
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
      db_part, L.n_blocks, g4, g3, static_cast<T*>(db_ih));
  sum_partials_kernel<T><<<(2 * h_dim + 255) / 256, 256, 0, stream>>>(
      db_part, L.n_blocks, g4, 2 * h_dim, static_cast<T*>(db_hh));
  sum_partials_kernel<T><<<(h_dim + 255) / 256, 256, 0, stream>>>(
      db_part + g3, L.n_blocks, g4, h_dim, static_cast<T*>(db_hh) + 2 * h_dim);
  return (int)cudaGetLastError();
}

// The 16-row tiles per block of phase A for these arguments (0: float32's
// row-tile kernel), or -1 if they are invalid: float32 takes no tile
// choice; bfloat16 needs the tiles' shapes (mma_shape).
int row_tiles_of(int n_rows, int n_steps, int e, int h_dim, int tc,
                 int dtype, int row_tiles) {
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc)) return -1;
  if (dtype == 0) return row_tiles == 0 ? 0 : -1;
  if (dtype != 1 || !mma_shape(e, h_dim)) return -1;
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
// w_hh [H, 3H], b_hh [3H], w_ih_t [3H, E] and w_hh_t [3H, H] (the
// transposes), hb float32 [ceil(T / tc), B, H] from cair_gru_fwd_res, dout
// [B, T, H] -> dx [B, T, E], dw_ih [E, 3H], db_ih [3H], dw_hh [H, 3H],
// db_hh [3H]; one dtype for all but mask and hb; `workspace` holds
// cair_gru_bwd_workspace(...) bytes.  bfloat16: `w_ih` points at the staged
// weights [E + H, 3H + 8] (W_ih over W_hh, 8 zero columns a row); `w_hh`
// and the transposes are not read; E and H are multiples of 32; row_tiles
// is 0 (the rule of bwd_row_tiles), 1 or the tiles' own (for timing).
// float32: row_tiles is 0.  Returns the first cudaError_t (0 on success).
extern "C" int cair_gru_bwd(const void* x, const void* mask,
                            const void* w_ih, const void* b_ih,
                            const void* w_hh, const void* b_hh,
                            const void* w_ih_t, const void* w_hh_t,
                            const void* hb, const void* dout, void* dx,
                            void* dw_ih, void* db_ih, void* dw_hh,
                            void* db_hh, void* workspace, int n_rows,
                            int n_steps, int e, int h_dim, int reverse,
                            int tc, int dtype, int row_tiles, void* stream) {
  const int mt = row_tiles_of(n_rows, n_steps, e, h_dim, tc, dtype,
                              row_tiles);
  // float32: a block has 2H threads (at most 1024); bfloat16: E + H fit
  // the tiles
  if (mt < 0 || (dtype == 0 ? kRowGroups * h_dim > 1024
                            : !mma_fits(e, h_dim)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, w_ih, b_ih, w_hh, b_hh, w_ih_t, w_hh_t, hb,
                         dout, dx, dw_ih, db_ih, dw_hh, db_hh, workspace,
                         n_rows, n_steps, e, h_dim, reverse, tc, 0, s);
  return launch<__nv_bfloat16>(x, mask, w_ih, b_ih, w_hh, b_hh, w_ih_t,
                               w_hh_t, hb, dout, dx, dw_ih, db_ih, dw_hh,
                               db_hh, workspace, n_rows, n_steps, e, h_dim,
                               reverse, tc, mt, s);
}
