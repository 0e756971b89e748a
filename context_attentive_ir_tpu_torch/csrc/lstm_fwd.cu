// Fused masked LSTM forward for Hopper (sm_90a): kernel 1 and, with
// chunk-boundary residuals, kernel 4.
//
// Kernel 1 replaces the TPU kernel `_lstm_fused_kernel` / `_lstm_fused_impl`
// in context_attentive_ir_tpu/ops/pallas/lstm.py (the `lstm_pallas_fused`
// forward).  Kernel 4 replaces `_lstm_fused_res_kernel` /
// `_lstm_fused_res_impl` (the training forward of the same custom_vjp): the
// same computation plus the carried (h, c) at every time-chunk boundary,
// which the chunked-remat backward (lstm_bwd.cu) restarts from.  Per step t
// and row b:
//
//   gates = x[b, t] @ W_ih + bias + h @ W_hh          (gate order i, f, g, o)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//   masked steps carry (h, c); out[b, t] = h * mask[b, t]
//
// The input projection is computed inside the kernel, so the [B, T, 4H] gate
// tensor never reaches device memory: traffic is one read of x and one write
// of h, as on the TPU.
//
// What bounds it on the H100: at the serving doc-encoder shape
// [16000, 30, 256] -> 128 one direction is 2*B*T*(E+H)*4H = 1.9e11 flops
// (0.19 ms at the 989 TFLOP/s bf16 tensor-core peak) against 0.37 GB of
// x + h traffic (0.11 ms at 3.35 TB/s): compute-bound.  Kernel 4's
// boundaries add 2 * n_chunks * B * H f32 (82 MB at TC = 6, 0.02 ms).
//
// Design (first, simple version): the TPU walks (batch_tile, time_chunk) in
// order with h/c in VMEM scratch.  Here one thread block owns kRows = 32 rows
// and runs all T steps itself; blocks run in parallel over row tiles.  The
// block has 2*H threads; thread (rg, j) owns hidden unit j of rows
// rg*16 .. rg*16+15, keeps their h and c in registers (f32) and computes all
// four gates of unit j, so the cell update needs no exchange.  Each step
// stages [x_t | h] for the block's rows in shared memory (lstm_common.cuh)
// and accumulates the gates with f32 FMAs; W_ih and W_hh (768 KB at f32) are
// streamed from global memory and stay resident in the 50 MB L2.  Because a
// block holds the carried state of its rows for the whole sequence, kernel 4
// writes hb[j] / cb[j] (the state before time chunk j in processing order,
// zeros for the first chunk processed) straight from registers.  No tensor
// cores yet, so the kernels run at the CUDA-core FMA rate, far above the
// bound: the sequential T loop and the FMA path are what a later version
// replaces (wgmma on bf16 tiles, W_hh resident in shared memory).
//
// As in the TPU kernel, h is rounded to the input dtype before the
// recurrent product (`hs.astype(whh_ref.dtype)`); everything else is f32.

#include "lstm_common.cuh"

namespace {

using namespace cair_lstm;

// kRes: also store the chunk-boundary state into hb / cb [n_chunks, B, H].
// Chunk c holds time steps c*tc .. min((c+1)*tc, T) - 1.
template <typename T, bool kRes>
__global__ void lstm_fwd_kernel(const T* __restrict__ x,
                                const uint8_t* __restrict__ mask,
                                const T* __restrict__ w_ih,
                                const T* __restrict__ bias,
                                const T* __restrict__ w_hh,
                                T* __restrict__ out, float* __restrict__ hb,
                                float* __restrict__ cb, int n_rows,
                                int n_steps, int e, int h_dim, int reverse,
                                int tc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [(e + h_dim)][kStride]

  const int j = threadIdx.x % h_dim;
  const int rg = threadIdx.x / h_dim;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;

  float h[kRowsPerThread];
  float c[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    h[i] = 0.0f;
    c[i] = 0.0f;
  }
  float bg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bg[g] = to_f32(bias[g * h_dim + j]);

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    if (kRes) {
      // first step of a chunk in processing order: record the carried state
      const bool first = reverse ? (t == n_steps - 1 || (t + 1) % tc == 0)
                                 : (t % tc == 0);
      if (first) {
        const size_t base = (size_t)(t / tc) * n_rows;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = my_row0 + i;
          if (row < n_rows) {
            hb[(base + row) * h_dim + j] = h[i];
            cb[(base + row) * h_dim + j] = c[i];
          }
        }
      }
    }

    float acc[4][kRowsPerThread];
    gate_preacts<T>(acc, xs, x, w_ih, w_hh, bg, h, row0, n_rows, n_steps, t,
                    e, h_dim, j, rg);

    // cell update; masked steps carry the state and write zeros
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      if (row < n_rows) {
        const size_t pos = (size_t)row * n_steps + t;
        const bool m = mask[pos] != 0;
        const float ig = sigmoid_f32(acc[0][i]);
        const float fg = sigmoid_f32(acc[1][i]);
        const float gg = tanhf(acc[2][i]);
        const float og = sigmoid_f32(acc[3][i]);
        const float c_new = fg * c[i] + ig * gg;
        const float h_new = og * tanhf(c_new);
        if (m) {
          h[i] = h_new;
          c[i] = c_new;
        }
        out[pos * h_dim + j] = from_f32<T>(m ? h[i] : 0.0f);
      }
    }
    __syncthreads();  // the next step overwrites the staged tile
  }
}

template <typename T, bool kRes>
int launch(const void* x, const void* mask, const void* w_ih, const void* b,
           const void* w_hh, void* out, void* hb, void* cb, int n_rows,
           int n_steps, int e, int h_dim, int reverse, int tc,
           cudaStream_t stream) {
  const size_t smem = (size_t)(e + h_dim) * kStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T, kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {  // e.g. E + H too large for the shared tile
    cudaGetLastError();      // clear it so the next launch reads clean
    return (int)err;
  }
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const dim3 block(kRowGroups * h_dim);
  lstm_fwd_kernel<T, kRes><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b),
      static_cast<const T*>(w_hh), static_cast<T*>(out),
      static_cast<float*>(hb), static_cast<float*>(cb), n_rows, n_steps, e,
      h_dim, reverse, tc);
  return (int)cudaGetLastError();
}

template <bool kRes>
int dispatch(const void* x, const void* mask, const void* w_ih, const void* b,
             const void* w_hh, void* out, void* hb, void* cb, int n_rows,
             int n_steps, int e, int h_dim, int reverse, int tc, int dtype,
             void* stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  if (h_dim <= 0 || kRowGroups * h_dim > 1024 || tc <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kRes>(x, mask, w_ih, b, w_hh, out, hb, cb, n_rows,
                               n_steps, e, h_dim, reverse, tc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kRes>(x, mask, w_ih, b, w_hh, out, hb, cb,
                                       n_rows, n_steps, e, h_dim, reverse, tc,
                                       s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 1.  x [B, T, E], mask uint8 [B, T], w_ih [E, 4H], b [4H],
// w_hh [H, 4H], out [B, T, H]; all contiguous, one dtype (0 = float32,
// 1 = bfloat16).  Returns the cudaError_t of the launch (0 on success).
extern "C" int cair_lstm_fwd(const void* x, const void* mask,
                             const void* w_ih, const void* b,
                             const void* w_hh, void* out, int n_rows,
                             int n_steps, int e, int h_dim, int reverse,
                             int dtype, void* stream) {
  return dispatch<false>(x, mask, w_ih, b, w_hh, out, nullptr, nullptr,
                         n_rows, n_steps, e, h_dim, reverse, n_steps, dtype,
                         stream);
}

// Kernel 4: kernel 1 plus hb, cb float32 [ceil(T / tc), B, H], the carried
// (h, c) before each time chunk of tc steps in processing order.
extern "C" int cair_lstm_fwd_res(const void* x, const void* mask,
                                 const void* w_ih, const void* b,
                                 const void* w_hh, void* out, void* hb,
                                 void* cb, int n_rows, int n_steps, int e,
                                 int h_dim, int reverse, int tc, int dtype,
                                 void* stream) {
  return dispatch<true>(x, mask, w_ih, b, w_hh, out, hb, cb, n_rows, n_steps,
                        e, h_dim, reverse, tc, dtype, stream);
}
