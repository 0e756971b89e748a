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
// ~0.70 GB of x, dout, dx and boundary traffic (0.21 ms): compute-bound.
//
// Design (first, simple version).  The TPU accumulates dW in one
// VMEM-resident output block across a sequential grid; on Hopper blocks run
// in parallel and nothing carries between them, and dW_ih alone (256 x 512
// f32 = 512 KB) exceeds a block's shared memory.  So the work is split:
//
// - Phase A (lstm_bwd_cell_kernel): kernel 1's layout -- one block owns 32
//   rows, thread (rg, j) owns unit j of 16 rows with dh and dc in
//   registers -- walks the chunks in reverse, recomputes each one from
//   (hb, cb) and keeps the chunk's per-step activations (i, f, g, o, c_prev,
//   c_new: 590 KB for 32 rows at H = 128, TC = 6, too much for shared
//   memory) in a global workspace that only the owning thread reads back.
//   The cell backward is elementwise per unit; dgates_c is staged in shared
//   memory (k-major, like kernel 1's [x | h]) for the dx and dh products.
//   It writes dx, and dgates_c and h_prev_c per (row, step) to the
//   workspace for phase B, and a per-block partial db.
// - Phase B (lstm_common.cuh's wgrad_partial_kernel, shared with the GRU
//   backward): dW_ih = X^T G and dW_hh = Hp^T G over
//   all B*T (row, step) pairs as 64 x 64 output tiles, split over up to 32
//   row ranges to fill the card; sum_partials_kernel then adds the splits
//   (and the per-block db partials) in a fixed order.
//
// No atomics: the gradients are the same bits from run to run.  All
// products are f32 FMAs on the CUDA cores; tensor cores (wgmma), TMA and a
// fused dW reduction are later work.

#include "lstm_common.cuh"

namespace {

using namespace cair_lstm;

constexpr int kSaved = 6;  // per step: i, f, g, o, c_prev, c_new

template <typename T>
__global__ void lstm_bwd_cell_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask,
    const T* __restrict__ w_ih, const T* __restrict__ bias,
    const T* __restrict__ w_hh, const T* __restrict__ w_ih_t,
    const T* __restrict__ w_hh_t, const float* __restrict__ hb,
    const float* __restrict__ cb, const T* __restrict__ dout,
    T* __restrict__ dx, T* __restrict__ dgates_ws, T* __restrict__ h_prev_ws,
    float* __restrict__ act, float* __restrict__ db_part, int n_rows,
    int n_steps, int e, int h_dim, int reverse, int tc) {
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

// Byte offsets of the workspace regions (each 256-B aligned).
struct Layout {
  int n_blocks, splits, rows_per_split;
  size_t act, dgates, h_prev, db_part, part_ih, part_hh, total;
};

Layout layout(int n_rows, int n_steps, int e, int h_dim, int tc, size_t elt) {
  Layout L;
  const long long n = (long long)n_rows * n_steps;
  L.n_blocks = (n_rows + kRows - 1) / kRows;
  const Splits sp = make_splits(n);
  L.splits = sp.splits;
  L.rows_per_split = sp.rows_per_split;
  const size_t g4 = 4 * (size_t)h_dim;
  size_t off = 0;
  L.act = off;
  off += align256((size_t)L.n_blocks * tc * kSaved * kRows * h_dim * 4);
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

template <typename T>
int launch(const void* x, const void* mask, const void* w_ih, const void* b,
           const void* w_hh, const void* w_ih_t, const void* w_hh_t,
           const void* hb, const void* cb, const void* dout, void* dx,
           void* dw_ih, void* db, void* dw_hh, void* workspace, int n_rows,
           int n_steps, int e, int h_dim, int reverse, int tc,
           cudaStream_t stream) {
  const Layout L = layout(n_rows, n_steps, e, h_dim, tc, sizeof(T));
  char* ws = static_cast<char*>(workspace);
  T* dgates = reinterpret_cast<T*>(ws + L.dgates);
  T* h_prev = reinterpret_cast<T*>(ws + L.h_prev);
  float* db_part = reinterpret_cast<float*>(ws + L.db_part);
  float* part_ih = reinterpret_cast<float*>(ws + L.part_ih);
  float* part_hh = reinterpret_cast<float*>(ws + L.part_hh);
  const int g4 = 4 * h_dim;
  cudaError_t err;

  if (n_rows > 0 && n_steps > 0) {
    const int tile_rows = (e + h_dim) > g4 ? (e + h_dim) : g4;
    const size_t smem = (size_t)tile_rows * kStride * sizeof(float);
    err = cudaFuncSetAttribute(lstm_bwd_cell_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {  // E + H or 4H too large for the shared tile
      cudaGetLastError();
      return (int)err;
    }
    lstm_bwd_cell_kernel<T><<<L.n_blocks, kRowGroups * h_dim, smem,
                              stream>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const T*>(w_ih), static_cast<const T*>(b),
        static_cast<const T*>(w_hh), static_cast<const T*>(w_ih_t),
        static_cast<const T*>(w_hh_t), static_cast<const float*>(hb),
        static_cast<const float*>(cb), static_cast<const T*>(dout),
        static_cast<T*>(dx), dgates, h_prev,
        reinterpret_cast<float*>(ws + L.act), db_part, n_rows, n_steps, e,
        h_dim, reverse, tc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const int n = n_rows * n_steps;
  const int tiles_g = (g4 + kTile - 1) / kTile;
  wgrad_partial_kernel<T><<<dim3((e + kTile - 1) / kTile, tiles_g, L.splits),
                            256, 0, stream>>>(static_cast<const T*>(x), e,
                                              dgates, g4, g4, n,
                                              L.rows_per_split, part_ih, g4,
                                              0);
  wgrad_partial_kernel<T>
      <<<dim3((h_dim + kTile - 1) / kTile, tiles_g, L.splits), 256, 0,
         stream>>>(h_prev, h_dim, dgates, g4, g4, n, L.rows_per_split,
                   part_hh, g4, 0);
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
  return (long long)layout(n_rows, n_steps, e, h_dim, tc, dtype == 0 ? 4 : 2)
      .total;
}

// Kernel 5.  x [B, T, E], mask uint8 [B, T], w_ih [E, 4H], b [4H],
// w_hh [H, 4H], w_ih_t [4H, E] and w_hh_t [4H, H] (the transposes), hb, cb
// float32 [ceil(T / tc), B, H] from cair_lstm_fwd_res, dout [B, T, H] ->
// dx [B, T, E], dw_ih [E, 4H], db [4H], dw_hh [H, 4H]; one dtype for all but
// mask, hb and cb; `workspace` holds cair_lstm_bwd_workspace(...) bytes.
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
  // a block has 2H threads (at most 1024)
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc) || kRowGroups * h_dim > 1024)
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
