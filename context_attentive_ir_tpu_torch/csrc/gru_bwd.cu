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
// multiplies h_n and not x_n.  Rounding follows the TPU kernel: h is rounded
// to the compute dtype before h @ W_hh (in the recompute) and before the
// dW_hh product; the gate gradients are rounded to it (dg_c) before the dx,
// dh and dW products; db sums the f32 gradients; dW accumulates in f32 and is
// cast to the weight dtype at the end.
//
// What bounds it on the H100, doc encoder [16000, 30, 256] -> 128, one
// direction, bf16: recompute 1.42e11 + dx 9.4e10 + dh 4.7e10 + dW_ih 9.4e10
// + dW_hh 4.7e10 = 4.25e11 flops, 0.429 ms at 989 TFLOP/s, against ~0.55 GB
// of x, dout, dx and boundary traffic (0.16 ms): compute-bound.
//
// Design (first, simple version): kernel 5's (lstm_bwd.cu).  The TPU
// accumulates dW in VMEM-resident output blocks across a sequential grid; on
// Hopper blocks run in parallel and nothing carries between them, and dW_ih
// alone (256 x 384 f32 = 384 KB) exceeds a block's shared memory.  So:
//
// - Phase A (gru_bwd_cell_kernel): kernel 7's layout -- one block owns 32
//   rows, thread (rg, j) owns unit j of 16 rows with dh in registers --
//   walks the chunks in reverse, recomputes each one from hb and keeps the
//   chunk's per-step (h_prev, r, z, n, hn) (491 KB for 32 rows at H = 128,
//   TC = 6, too much for shared memory) in a global workspace that only the
//   owning thread reads back.  The cell backward is elementwise per unit;
//   the four gradient slots [da_r, da_z, da_n, da_n * r] are staged rounded
//   in shared memory (k-major, like kernel 7's [x | h]): slots 0-2 feed the
//   dx product, slots 0, 1, 3 the dh product.  It writes dx, and the four
//   slots and h_prev_c per (row, step) to the workspace for phase B, and a
//   per-block partial of each slot's sum (the db's).
// - Phase B (lstm_common.cuh's launch_wgrad_partial): dW_ih = X^T G[0:3]
//   and dW_hh = Hp^T G[0, 1, 3] over all B*T (row, step) pairs as output
//   tiles (bf16: 128 x 128 on tensor cores; float32: 64 x 64 of f32 FMAs),
//   split over up to 32 row ranges to fill the card;
//   sum_partials_kernel then adds the splits (and the per-block db partials)
//   in a fixed order.
//
// No atomics: the gradients are the same bits from run to run.  Phase A's
// products are f32 FMAs on the CUDA cores; tensor-core tiles for them (as in
// lstm_bwd.cu) are later work.

#include "lstm_common.cuh"

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

// Byte offsets of the workspace regions (each 256-B aligned).
struct Layout {
  int n_blocks, splits, rows_per_split;
  size_t act, dg, h_prev, db_part, part_ih, part_hh, total;
};

Layout layout(int n_rows, int n_steps, int e, int h_dim, int tc, size_t elt) {
  Layout L;
  const long long n = (long long)n_rows * n_steps;
  L.n_blocks = (n_rows + kRows - 1) / kRows;
  const Splits sp = make_splits(n);
  L.splits = sp.splits;
  L.rows_per_split = sp.rows_per_split;
  const size_t g3 = 3 * (size_t)h_dim, g4 = 4 * (size_t)h_dim;
  size_t off = 0;
  L.act = off;
  off += align256((size_t)L.n_blocks * tc * kSaved * kRows * h_dim * 4);
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

template <typename T>
int launch(const void* x, const void* mask, const void* w_ih,
           const void* b_ih, const void* w_hh, const void* b_hh,
           const void* w_ih_t, const void* w_hh_t, const void* hb,
           const void* dout, void* dx, void* dw_ih, void* db_ih, void* dw_hh,
           void* db_hh, void* workspace, int n_rows, int n_steps, int e,
           int h_dim, int reverse, int tc, cudaStream_t stream) {
  const Layout L = layout(n_rows, n_steps, e, h_dim, tc, sizeof(T));
  char* ws = static_cast<char*>(workspace);
  T* dg = reinterpret_cast<T*>(ws + L.dg);
  T* h_prev = reinterpret_cast<T*>(ws + L.h_prev);
  float* db_part = reinterpret_cast<float*>(ws + L.db_part);
  float* part_ih = reinterpret_cast<float*>(ws + L.part_ih);
  float* part_hh = reinterpret_cast<float*>(ws + L.part_hh);
  const int g3 = 3 * h_dim;
  const int g4 = 4 * h_dim;
  cudaError_t err;

  if (n_rows > 0 && n_steps > 0) {
    const int tile_rows = (e + h_dim) > g4 ? (e + h_dim) : g4;
    const size_t smem = (size_t)tile_rows * kStride * sizeof(float);
    const int bound = row_tile_bound(kRowGroups * h_dim);
    if (bound == 0) return (int)cudaErrorInvalidValue;
    auto* kernel = bound == 256   ? gru_bwd_cell_kernel<T, 256>
                   : bound == 512 ? gru_bwd_cell_kernel<T, 512>
                                  : gru_bwd_cell_kernel<T, 1024>;
    err = cudaFuncSetAttribute(
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
        static_cast<T*>(dx), dg, h_prev, reinterpret_cast<float*>(ws + L.act),
        db_part, n_rows, n_steps, e, h_dim, reverse, tc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
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

}  // namespace

// Bytes of workspace cair_gru_bwd needs for these shapes, or -1 if they are
// invalid (dtype 0 = float32, 1 = bfloat16).
extern "C" long long cair_gru_bwd_workspace(int n_rows, int n_steps, int e,
                                            int h_dim, int tc, int dtype) {
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc) || (dtype != 0 && dtype != 1))
    return -1;
  return (long long)layout(n_rows, n_steps, e, h_dim, tc, dtype == 0 ? 4 : 2)
      .total;
}

// Kernel 9.  x [B, T, E], mask uint8 [B, T], w_ih [E, 3H], b_ih [3H],
// w_hh [H, 3H], b_hh [3H], w_ih_t [3H, E] and w_hh_t [3H, H] (the
// transposes), hb float32 [ceil(T / tc), B, H] from cair_gru_fwd_res, dout
// [B, T, H] -> dx [B, T, E], dw_ih [E, 3H], db_ih [3H], dw_hh [H, 3H],
// db_hh [3H]; one dtype for all but mask and hb; `workspace` holds
// cair_gru_bwd_workspace(...) bytes.  Returns the first cudaError_t (0 on
// success).
extern "C" int cair_gru_bwd(const void* x, const void* mask,
                            const void* w_ih, const void* b_ih,
                            const void* w_hh, const void* b_hh,
                            const void* w_ih_t, const void* w_hh_t,
                            const void* hb, const void* dout, void* dx,
                            void* dw_ih, void* db_ih, void* dw_hh,
                            void* db_hh, void* workspace, int n_rows,
                            int n_steps, int e, int h_dim, int reverse,
                            int tc, int dtype, void* stream) {
  // a block has 2H threads (at most 1024)
  if (!valid_shape(n_rows, n_steps, e, h_dim, tc) || kRowGroups * h_dim > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, w_ih, b_ih, w_hh, b_hh, w_ih_t, w_hh_t, hb,
                         dout, dx, dw_ih, db_ih, dw_hh, db_hh, workspace,
                         n_rows, n_steps, e, h_dim, reverse, tc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, w_ih, b_ih, w_hh, b_hh, w_ih_t,
                                 w_hh_t, hb, dout, dx, dw_ih, db_ih, dw_hh,
                                 db_hh, workspace, n_rows, n_steps, e, h_dim,
                                 reverse, tc, s);
  return (int)cudaErrorInvalidValue;
}
