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
// wrapper zero-pads other sizes.
//
// float32 keeps exact f32 FMAs (no TF32) on the first version's layout
// (lstm_bwd_cell_kernel: one block per 32 rows, thread (rg, j) owning unit
// j of 16 rows, six activation planes, host-made transposes of the weights
// for the dx and dh products) and wgrad_partial_kernel.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"

namespace {

using namespace cair_lstm;

constexpr int kSaved = 6;  // per step: i, f, g, o, c_prev, c_new

// kBound: the launch bound (row_tile_bound)
template <typename T, int kBound>
__global__ void __launch_bounds__(kBound)
lstm_bwd_cell_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                     const T* __restrict__ w_ih, const T* __restrict__ bias,
                     const T* __restrict__ w_hh, const T* __restrict__ w_ih_t,
                     const T* __restrict__ w_hh_t, const float* __restrict__ hb,
                     const float* __restrict__ cb, const T* __restrict__ dout,
                     T* __restrict__ dx, T* __restrict__ dgates_ws,
                     T* __restrict__ h_prev_ws, float* __restrict__ act,
                     float* __restrict__ db_part, int n_rows, int n_steps,
                     int e, int h_dim, int reverse, int tc) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);

  const int j = threadIdx.x % h_dim;
  const int rg = threadIdx.x / h_dim;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;
  const int g4 = 4 * h_dim;
  const int n_chunks = (n_steps + tc - 1) / tc;
  const size_t act_step = (size_t)kSaved * kRows * h_dim;
  float* my_act = act + (size_t)blockIdx.x * tc * act_step;

  float bg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bg[g] = to_f32(bias[g * h_dim + j]);
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
    float h[kRowsPerThread], c[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      const size_t at = ((size_t)chunk * n_rows + row) * h_dim + j;
      h[i] = row < n_rows ? hb[at] : 0.0f;
      c[i] = row < n_rows ? cb[at] : 0.0f;
    }
    for (int k = 0; k < len; ++k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      float acc[4][kRowsPerThread];
      gate_preacts<T>(acc, tile, x, w_ih, w_hh, bg, h, row0, n_rows, n_steps,
                      t, e, h_dim, j, rg);
      float* a_k = my_act + k * act_step;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = my_row0 + i;
        if (row < n_rows) {
          const size_t pos = (size_t)row * n_steps + t;
          const float ig = sigmoid_f32(acc[0][i]);
          const float fg = sigmoid_f32(acc[1][i]);
          const float gg = tanhf(acc[2][i]);
          const float og = sigmoid_f32(acc[3][i]);
          const float c_new = fg * c[i] + ig * gg;
          const float h_new = og * tanhf(c_new);
          h_prev_ws[pos * h_dim + j] = from_f32<T>(h[i]);
          const size_t r = (size_t)(rg * kRowsPerThread + i) * h_dim + j;
          const size_t plane = (size_t)kRows * h_dim;
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
      }
      __syncthreads();  // the next step overwrites the staged tile
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
        if (row < n_rows) {
          const size_t pos = (size_t)row * n_steps + t;
          if (mask[pos] != 0) {
            valid |= 1u << i;
            const size_t r = (size_t)(rg * kRowsPerThread + i) * h_dim + j;
            const size_t plane = (size_t)kRows * h_dim;
            const float ig = a_k[r];
            const float fg = a_k[plane + r];
            const float gg = a_k[2 * plane + r];
            const float og = a_k[3 * plane + r];
            const float c_prev = a_k[4 * plane + r];
            const float c_new = a_k[5 * plane + r];
            const float dh_new = to_f32(dout[pos * h_dim + j]) + dh[i];
            const float tanh_c = tanhf(c_new);
            const float do_ = dh_new * tanh_c;
            const float dcn = dc[i] + dh_new * og * (1.0f - tanh_c * tanh_c);
            d0 = dcn * gg * ig * (1.0f - ig);
            d1 = dcn * c_prev * fg * (1.0f - fg);
            d2 = dcn * ig * (1.0f - gg * gg);
            d3 = do_ * og * (1.0f - og);
            dc[i] = dcn * fg;
          }
          T* dst = dgates_ws + pos * g4 + j;
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
        store_rows(tile, g * h_dim + j, rg, v);
      }
      __syncthreads();

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
            dx[((size_t)row * n_steps + t) * e + col] = from_f32<T>(acc[0][i]);
        }
      }
      __syncthreads();  // the next step overwrites the staged dgates
    }
  }

  // per-block db: the two row groups' sums, in a fixed order
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
// (recompute) and the dgates
// tile (reverse pass) | dh exchange (f32, rows h + 8 floats apart) | bias.
constexpr int kPlanes = 5;  // per cell and step: i, f, g, o, c_prev

template <int G, int MT>
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
  const int xs = x_stride(e), hs = h_stride(h_dim);
  const int ws = w_stride(h_dim, kLstmGates);
  const int g4 = 4 * h_dim;
  const int ex_ld = h_dim + 8;  // floats per row of the dh exchange
  WeightRing ring;
  ring.init(smem, w_staged, e, h_dim, kLstmGates, ks, 2LL * n_steps);
  char* uni = ring.base + kStages * ring.slab_bytes;
  char* xbuf[2];
  xbuf[0] = uni;
  xbuf[1] = uni + M * xs;
  char* h_tile = uni + 2 * M * xs;
  char* dg_tile = uni;
  float* exch = reinterpret_cast<float*>(
      uni + staged_bytes(e, h_dim, kLstmGates, M, true));
  float* bias_s = exch + M * ex_ld;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;
  const int row0 = blockIdx.x * M;
  const int n_chunks = (n_steps + tc - 1) / tc;
  // the block's activation planes: [tc][MT * G * kPlanes][kThreads] float4
  constexpr int kSlots = MT * G * kPlanes;
  float4* my_act =
      act + (size_t)blockIdx.x * tc * kSlots * kThreads + threadIdx.x;

  for (int i = threadIdx.x; i < g4; i += kThreads)
    bias_s[i] = __bfloat162float(bias[i]);

  float dh[MT][G][4], dc[MT][G][4], dbs[G][4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dh[mt][gi][i] = 0.0f;
        dc[mt][gi][i] = 0.0f;
      }
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
    float c[MT][G][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int unit = (ug0 + gi) * 8 + 2 * tg;
        if (unit < h_dim) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = mt * 16 + g + half * 8;
            float2 hv = make_float2(0.0f, 0.0f), cv = hv;
            if (live >> (mt * 2 + half) & 1u) {
              const size_t at =
                  ((size_t)chunk * n_rows + row0 + r) * h_dim + unit;
              hv = *reinterpret_cast<const float2*>(hb + at);
              cv = *reinterpret_cast<const float2*>(cb + at);
            }
            c[mt][gi][half * 2] = cv.x;
            c[mt][gi][half * 2 + 1] = cv.y;
            *reinterpret_cast<bf162*>(h_tile + r * hs + unit * 2) =
                __floats2bfloat162_rn(hv.x, hv.y);
          }
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

      float acc[MT][G][4][4];
      step_gates<kLstmGates, G, MT>(
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
            for (int half = 0; half < 2; ++half)
              if (mb >> (mt * 2 + half) & 1u)
                *reinterpret_cast<bf162*>(
                    h_tile + (mt * 16 + g + half * 8) * hs + unit * 2) =
                    __floats2bfloat162_rn(hn[half * 2], hn[half * 2 + 1]);
          }
        }
    }
    __syncthreads();  // the recompute's tiles give way to the dgates tile

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
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int unit = (ug0 + gi) * 8 + 2 * tg;
          if (unit < h_dim) {
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
                          unit));
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
                                          (qq * h_dim + unit) * 2) =
                    __floats2bfloat162_rn(d[qq][half * 2], d[qq][half * 2 + 1]);
            }
          }
        }
      __syncthreads();  // the dgates tile is whole

      // dgates_c of (row, t) for phase B
      {
        const int cpr = g4 / 8;
        for (int idx = threadIdx.x; idx < M * cpr; idx += kThreads) {
          const int r = idx / cpr, cc = idx - r * cpr;
          if (row0 + r < n_rows)
            *reinterpret_cast<uint4*>(
                dgates_ws + ((size_t)(row0 + r) * n_steps + t) * g4 + cc * 8) =
                *reinterpret_cast<const uint4*>(dg_tile + r * ws + cc * 16);
        }
      }

      // dx_t = dgates_c @ W_ih^T and dh = dgates_c @ W_hh^T: a slab's ks
      // rows are ks output columns; a warp takes 16 rows x 16 columns
      const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
      for (int sl = 0; sl < ring.n_slabs; ++sl, ++n) {
        const char* slab = ring.acquire(n);
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
          for (int kk = 0; kk < g4; kk += 16) {
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
      __syncthreads();  // dh is whole; every warp is done with the dgates

      // dh = (1 - m) dh + dgates_c @ W_hh^T (the product is 0 where m = 0)
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
                dh[mt][gi][half * 2] = v.x;
                dh[mt][gi][half * 2 + 1] = v.y;
              }
          }
        }
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
        if (g == 0 && unit < h_dim)
          db_part[(size_t)blockIdx.x * g4 + qq * h_dim + unit + u] = v;
      }
  }
}

// Byte offsets of the workspace regions (each 256-B aligned).  `mma`: the
// bf16 tensor-core phase A (its own rows per block and activation planes).
struct Layout {
  int n_blocks, splits, rows_per_split;
  size_t act, dgates, h_prev, db_part, part_ih, part_hh, total;
};

Layout layout(int n_rows, int n_steps, int e, int h_dim, int tc, size_t elt,
              bool mma) {
  Layout L;
  const long long n = (long long)n_rows * n_steps;
  const tiles::Config cfg = tiles::pick_config(h_dim);
  const int m_rows = mma ? 16 * cfg.mt : kRows;
  L.n_blocks = (n_rows + m_rows - 1) / m_rows;
  const Splits sp = make_splits(n);
  L.splits = sp.splits;
  L.rows_per_split = sp.rows_per_split;
  const size_t g4 = 4 * (size_t)h_dim;
  size_t off = 0;
  L.act = off;
  off += align256(
      mma ? (size_t)L.n_blocks * tc * cfg.mt * cfg.g * kPlanes *
                tiles::kThreads * 16
          : (size_t)L.n_blocks * tc * kSaved * kRows * h_dim * 4);
  L.dgates = off;
  off += align256((size_t)n * g4 * elt);
  L.h_prev = off;
  off += align256((size_t)n * h_dim * elt);
  L.db_part = off;
  off += align256((size_t)L.n_blocks * g4 * 4);
  L.part_ih = off;
  off += align256((size_t)L.splits * e * g4 * 4);
  L.part_hh = off;
  off += align256((size_t)L.splits * h_dim * g4 * 4);
  L.total = off;
  return L;
}

bool valid_shape(int n_rows, int n_steps, int e, int h_dim, int tc) {
  return n_rows >= 0 && n_steps >= 0 && e > 0 && h_dim > 0 && tc > 0;
}

// bf16: E and H multiples of 32, H <= 512, 16-byte aligned pointers
bool mma_shape(int e, int h_dim) {
  return e % tiles::kAlign == 0 && h_dim % tiles::kAlign == 0 &&
         h_dim <= tiles::kMaxHidden;
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
  const int g4 = 4 * h_dim;
  const int tile_rows = (e + h_dim) > g4 ? (e + h_dim) : g4;
  const size_t smem = (size_t)tile_rows * kStride * sizeof(float);
  const int bound = row_tile_bound(kRowGroups * h_dim);
  if (bound == 0) return (int)cudaErrorInvalidValue;
  auto* kernel = bound == 256   ? lstm_bwd_cell_kernel<T, 256>
                 : bound == 512 ? lstm_bwd_cell_kernel<T, 512>
                                : lstm_bwd_cell_kernel<T, 1024>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {  // E + H or 4H too large for the shared tile
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<L.n_blocks, kRowGroups * h_dim, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b),
      static_cast<const T*>(w_hh), static_cast<const T*>(w_ih_t),
      static_cast<const T*>(w_hh_t), static_cast<const float*>(hb),
      static_cast<const float*>(cb), static_cast<const T*>(dout),
      static_cast<T*>(dx), dgates, h_prev, act, db_part, n_rows, n_steps, e,
      h_dim, reverse, tc);
  return (int)cudaGetLastError();
}

// phase A, bfloat16: tensor cores
template <int G, int MT>
int launch_mma(const void* x, const void* mask, const void* w_ih,
               const void* b, const void* hb, const void* cb,
               const void* dout, void* dx,
               __nv_bfloat16* dgates, __nv_bfloat16* h_prev, float* act,
               float* db_part, const Layout& L, int n_rows, int n_steps,
               int e, int h_dim, int reverse, int tc, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  int ks = 0;
  const size_t smem =
      tiles::mma_smem(e, h_dim, tiles::kLstmGates, 16 * MT, true, &ks);
  if (smem == 0) return (int)cudaErrorInvalidValue;  // E + H too large
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_mma_kernel<G, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  lstm_bwd_mma_kernel<G, MT><<<L.n_blocks, tiles::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(w_ih), static_cast<const bf16*>(b),
      static_cast<const float*>(hb), static_cast<const float*>(cb),
      static_cast<const bf16*>(dout),
      static_cast<bf16*>(dx), dgates, h_prev, reinterpret_cast<float4*>(act),
      db_part, n_rows, n_steps, e, h_dim, reverse, tc, ks);
  return (int)cudaGetLastError();
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

  if (n_rows > 0 && n_steps > 0) {
    int rc = (int)cudaErrorInvalidValue;
    if constexpr (kMma) {
      if (!tiles::aligned16(x) || !tiles::aligned16(w_ih) ||
          !tiles::aligned16(hb) ||
          !tiles::aligned16(cb) || !tiles::aligned16(dout) ||
          !tiles::aligned16(dx) || !tiles::aligned16(workspace))
        return rc;
      const tiles::Config cfg = tiles::pick_config(h_dim);
#define CAIR_BWD_CASE(G_, MT_)                                              \
  if (cfg.g == G_)                                                          \
    rc = launch_mma<G_, MT_>(x, mask, w_ih, b, hb, cb, dout, dx, dgates,    \
                             h_prev, act, db_part, L, n_rows, n_steps, e,   \
                             h_dim, reverse, tc, stream);
      CAIR_BWD_CASE(1, 4)
      CAIR_BWD_CASE(2, 4)
      CAIR_BWD_CASE(4, 2)
      CAIR_BWD_CASE(8, 1)
#undef CAIR_BWD_CASE
    } else {
      rc = launch_cell(x, mask, w_ih, b, w_hh, w_ih_t, w_hh_t, hb, cb, dout,
                       dx, dgates, h_prev, act, db_part, L, n_rows, n_steps,
                       e, h_dim, reverse, tc, stream);
    }
    if (rc != 0) return rc;
  }

  const int n = n_rows * n_steps;
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
      db_part, L.n_blocks, g4, g4, static_cast<T*>(db));
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of workspace cair_lstm_bwd needs for these shapes, or -1 if they
// are invalid (dtype 0 = float32, 1 = bfloat16).
extern "C" long long cair_lstm_bwd_workspace(int n_rows, int n_steps, int e,
                                             int h_dim, int tc, int dtype) {
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc) || (dtype != 0 && dtype != 1))
    return -1;
  if (dtype == 1 && !mma_shape(e, h_dim)) return -1;
  return (long long)layout(n_rows, n_steps, e, h_dim, tc, dtype == 0 ? 4 : 2,
                           dtype == 1)
      .total;
}

// Kernel 5.  x [B, T, E], mask uint8 [B, T], w_ih [E, 4H], b [4H],
// w_hh [H, 4H], w_ih_t [4H, E] and w_hh_t [4H, H] (the transposes), hb, cb
// float32 [ceil(T / tc), B, H] from cair_lstm_fwd_res, dout [B, T, H] ->
// dx [B, T, E], dw_ih [E, 4H], db [4H], dw_hh [H, 4H]; one dtype for all but
// mask, hb and cb; `workspace` holds cair_lstm_bwd_workspace(...) bytes.
// bfloat16: `w_ih` points at the staged weights [E + H, 4H + 8] (W_ih over
// W_hh, 8 zero columns a row); `w_hh` and the transposes are not read.
// Returns the first cudaError_t (0 on success).
extern "C" int cair_lstm_bwd(const void* x, const void* mask,
                             const void* w_ih, const void* b,
                             const void* w_hh, const void* w_ih_t,
                             const void* w_hh_t, const void* hb,
                             const void* cb, const void* dout, void* dx,
                             void* dw_ih, void* db, void* dw_hh,
                             void* workspace, int n_rows, int n_steps, int e,
                             int h_dim, int reverse, int tc, int dtype,
                             void* stream) {
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc))
    return (int)cudaErrorInvalidValue;
  // float32: a block has 2H threads (at most 1024); bfloat16: the tiles'
  // contract
  if (dtype == 0 ? kRowGroups * h_dim > 1024 : !mma_shape(e, h_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, w_ih, b, w_hh, w_ih_t, w_hh_t, hb, cb, dout,
                         dx, dw_ih, db, dw_hh, workspace, n_rows, n_steps, e,
                         h_dim, reverse, tc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, w_ih, b, w_hh, w_ih_t, w_hh_t, hb,
                                 cb, dout, dx, dw_ih, db, dw_hh, workspace,
                                 n_rows, n_steps, e, h_dim, reverse, tc, s);
  return (int)cudaErrorInvalidValue;
}
