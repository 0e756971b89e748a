// Fused masked GRU forward for Hopper (sm_90a): kernel 7 and, with
// chunk-boundary residuals, kernel 8.
//
// Kernel 7 replaces the TPU kernel `_gru_fused_kernel` / `_gru_fused_impl`
// in context_attentive_ir_tpu/ops/pallas/gru.py (the `gru_pallas_fused`
// forward).  Kernel 8 replaces `_gru_fused_res_kernel` /
// `_gru_fused_res_impl` (the training forward of the same custom_vjp): the
// same computation plus the carried h at every time-chunk boundary, which
// the chunked-remat backward (gru_bwd.cu) restarts from.  Per step t and
// row b, torch gate order r, z, n:
//
//   xp = x[b, t] @ W_ih + b_ih;  hp = h @ W_hh + b_hh          (both f32)
//   r = sigmoid(xp_r + hp_r);  z = sigmoid(xp_z + hp_z)
//   n = tanh(xp_n + r * hp_n);  h' = (1 - z) * n + z * h
//   masked steps carry h; out[b, t] = h * mask[b, t]
//
// The input projection is computed inside the kernel, so the [B, T, 3H] gate
// tensor never reaches device memory: traffic is one read of x and one write
// of h, as on the TPU.
//
// What bounds it on the H100: at the serving doc-encoder shape
// [16000, 30, 256] -> 128 one direction is 2*B*T*(E+H)*3H = 1.42e11 flops
// (0.143 ms at the 989 TFLOP/s bf16 tensor-core peak) against 0.37 GB of
// x + h traffic (0.11 ms at 3.35 TB/s): compute-bound.  Kernel 8's
// boundaries add n_chunks * B * H f32 (41 MB at TC = 6, 0.01 ms).
//
// Design (first, simple version): kernel 1's (lstm_fwd.cu).  The TPU walks
// (batch_tile, time_chunk) in order with h in VMEM scratch; here one thread
// block owns kRows = 32 rows and runs all T steps itself, blocks in parallel
// over row tiles.  The block has 2*H threads; thread (rg, j) owns hidden unit
// j of rows rg*16 .. rg*16+15, keeps their h in registers (f32) and computes
// the three gates of unit j, so the cell update needs no exchange.  The n
// slot needs x_n and h_n apart (r multiplies only h_n), so the thread keeps
// xp and hp in separate accumulators (6 x 16 f32), each started from its
// bias as the TPU kernel adds b_ih and b_hh.  Each step stages [x_t | h] for
// the block's rows in shared memory (lstm_common.cuh) and accumulates with
// f32 FMAs; W_ih and W_hh (576 KB at f32) stay resident in the 50 MB L2.
// Kernel 8 writes hb[c] (h before time chunk c in processing order, zeros
// for the first chunk processed) straight from registers.  No tensor cores
// yet: the sequential T loop and the FMA path are what a later version
// replaces (wgmma on bf16 tiles, W_hh resident in shared memory).
//
// As in the TPU kernel, h is rounded to the input dtype before the
// recurrent product (`hs.astype(whh_ref.dtype)`); everything else is f32.

#include "lstm_common.cuh"

namespace {

using namespace cair_lstm;

// One GRU step's projections for the thread's 16 rows and unit j:
// ax[g][i] = b_ih[g*H + j] + x_t @ W_ih[:, g*H + j] and ah[g][i] = b_hh[g*H +
// j] + h @ W_hh[:, g*H + j], g = r, z, n.  Stages [x_t | h] (stage_x_h);
// the caller synchronises before the tile is overwritten.
template <typename T>
__device__ __forceinline__ void gru_preacts(
    float ax[3][kRowsPerThread], float ah[3][kRowsPerThread], float* tile,
    const T* __restrict__ x, const T* __restrict__ w_ih,
    const T* __restrict__ w_hh, const float bx[3], const float bh[3],
    const float h[kRowsPerThread], int row0, int n_rows, int n_steps, int t,
    int e, int h_dim, int j, int rg) {
  stage_x_h<T>(tile, x, h, row0, n_rows, n_steps, t, e, j, rg);
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      ax[g][i] = bx[g];
      ah[g][i] = bh[g];
    }
  }
  const int g3 = 3 * h_dim;
  dot_rows<3, T>(ax, tile, 0, rg, w_ih + j, e, g3, h_dim);
  dot_rows<3, T>(ah, tile, e, rg, w_hh + j, h_dim, g3, h_dim);
}

// kRes: also store h before each time chunk into hb [n_chunks, B, H].
// Chunk c holds time steps c*tc .. min((c+1)*tc, T) - 1.
template <typename T, bool kRes>
__global__ void gru_fwd_kernel(const T* __restrict__ x,
                               const uint8_t* __restrict__ mask,
                               const T* __restrict__ w_ih,
                               const T* __restrict__ b_ih,
                               const T* __restrict__ w_hh,
                               const T* __restrict__ b_hh,
                               T* __restrict__ out, float* __restrict__ hb,
                               int n_rows, int n_steps, int e, int h_dim,
                               int reverse, int tc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [(e + h_dim)][kStride]

  const int j = threadIdx.x % h_dim;
  const int rg = threadIdx.x / h_dim;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;

  float h[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) h[i] = 0.0f;
  float bx[3], bh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bx[g] = to_f32(b_ih[g * h_dim + j]);
    bh[g] = to_f32(b_hh[g * h_dim + j]);
  }

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    if (kRes) {
      // first step of a chunk in processing order: record the carried h
      const bool first = reverse ? (t == n_steps - 1 || (t + 1) % tc == 0)
                                 : (t % tc == 0);
      if (first) {
        const size_t base = (size_t)(t / tc) * n_rows;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = my_row0 + i;
          if (row < n_rows) hb[(base + row) * h_dim + j] = h[i];
        }
      }
    }

    float ax[3][kRowsPerThread], ah[3][kRowsPerThread];
    gru_preacts<T>(ax, ah, xs, x, w_ih, w_hh, bx, bh, h, row0, n_rows,
                   n_steps, t, e, h_dim, j, rg);

    // cell update; masked steps carry the state and write zeros
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      if (row < n_rows) {
        const size_t pos = (size_t)row * n_steps + t;
        const float r = sigmoid_f32(ax[0][i] + ah[0][i]);
        const float z = sigmoid_f32(ax[1][i] + ah[1][i]);
        const float n = tanhf(ax[2][i] + r * ah[2][i]);
        const float h_new = (1.0f - z) * n + z * h[i];
        const bool m = mask[pos] != 0;
        if (m) h[i] = h_new;
        out[pos * h_dim + j] = from_f32<T>(m ? h[i] : 0.0f);
      }
    }
    __syncthreads();  // the next step overwrites the staged tile
  }
}

template <typename T, bool kRes>
int launch(const void* x, const void* mask, const void* w_ih,
           const void* b_ih, const void* w_hh, const void* b_hh, void* out,
           void* hb, int n_rows, int n_steps, int e, int h_dim, int reverse,
           int tc, cudaStream_t stream) {
  const size_t smem = (size_t)(e + h_dim) * kStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<T, kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {  // e.g. E + H too large for the shared tile
    cudaGetLastError();      // clear it so the next launch reads clean
    return (int)err;
  }
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const dim3 block(kRowGroups * h_dim);
  gru_fwd_kernel<T, kRes><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b_ih),
      static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
      static_cast<T*>(out), static_cast<float*>(hb), n_rows, n_steps, e,
      h_dim, reverse, tc);
  return (int)cudaGetLastError();
}

template <bool kRes>
int dispatch(const void* x, const void* mask, const void* w_ih,
             const void* b_ih, const void* w_hh, const void* b_hh, void* out,
             void* hb, int n_rows, int n_steps, int e, int h_dim, int reverse,
             int tc, int dtype, void* stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  // a block has 2H threads (at most 1024)
  if (h_dim <= 0 || kRowGroups * h_dim > 1024 || e <= 0 || tc <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kRes>(x, mask, w_ih, b_ih, w_hh, b_hh, out, hb,
                               n_rows, n_steps, e, h_dim, reverse, tc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kRes>(x, mask, w_ih, b_ih, w_hh, b_hh, out,
                                       hb, n_rows, n_steps, e, h_dim, reverse,
                                       tc, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 7.  x [B, T, E], mask uint8 [B, T], w_ih [E, 3H], b_ih [3H],
// w_hh [H, 3H], b_hh [3H], out [B, T, H]; all contiguous, one dtype
// (0 = float32, 1 = bfloat16).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int cair_gru_fwd(const void* x, const void* mask,
                            const void* w_ih, const void* b_ih,
                            const void* w_hh, const void* b_hh, void* out,
                            int n_rows, int n_steps, int e, int h_dim,
                            int reverse, int dtype, void* stream) {
  return dispatch<false>(x, mask, w_ih, b_ih, w_hh, b_hh, out, nullptr,
                         n_rows, n_steps, e, h_dim, reverse, n_steps, dtype,
                         stream);
}

// Kernel 8: kernel 7 plus hb float32 [ceil(T / tc), B, H], the carried h
// before each time chunk of tc steps in processing order.
extern "C" int cair_gru_fwd_res(const void* x, const void* mask,
                                const void* w_ih, const void* b_ih,
                                const void* w_hh, const void* b_hh,
                                void* out, void* hb, int n_rows, int n_steps,
                                int e, int h_dim, int reverse, int tc,
                                int dtype, void* stream) {
  return dispatch<true>(x, mask, w_ih, b_ih, w_hh, b_hh, out, hb, n_rows,
                        n_steps, e, h_dim, reverse, tc, dtype, stream);
}
