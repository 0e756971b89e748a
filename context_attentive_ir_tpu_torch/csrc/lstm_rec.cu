// Masked LSTM recurrence on precomputed gates for Hopper (sm_90a): kernel 6.
//
// Replaces the TPU kernel `_lstm_kernel` / `_lstm_pallas_fwd_impl` in
// context_attentive_ir_tpu/ops/pallas/lstm.py (the `lstm_pallas` forward).
// The input projection x @ W_ih + b is applied outside (one matmul over all
// steps); the kernel reads it as x_proj [B, T, 4H] and runs the serial part.
// Per step t and row b:
//
//   gates = f32(x_proj[b, t]) + h @ W_hh                (gate order i, f, g, o)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//   masked steps carry (h, c); out[b, t] = h * mask[b, t]
//
// What bounds it on the H100: at the doc-encoder shape B = 16000, T = 30,
// H = 128 in bf16 it reads 491.5 MB of x_proj and writes 122.9 MB of h
// (0.183 ms at 3.35 TB/s) against 2*B*T*H*4H = 6.3e10 flops (0.064 ms at the
// 989 TFLOP/s bf16 tensor-core peak): bound by bytes.
//
// Design (first, simple version): kernel 1's layout (lstm_fwd.cu) without the
// [x | h] staging.  A block owns kRows = 32 rows for all T steps; thread
// (rg, j) owns hidden unit j of rows rg*16 .. rg*16+15 with their h and c in
// registers (f32).  Its four gate accumulators start from the thread's own
// x_proj values -- for one row and gate the block's threads read H consecutive
// elements, so every warp reads one contiguous segment -- and add h @ W_hh
// from the staged h tile, W_hh streamed from L2.  The product runs on
// CUDA-core FMAs; tensor-core tiles with W_hh resident in shared memory are
// what a later version replaces it with.
//
// As in the TPU kernel, h is rounded to W_hh's dtype before the product
// (`h.astype(whh_ref.dtype)`); gates and state are f32.

#include "lstm_common.cuh"

namespace {

using namespace cair_lstm;

template <typename T>
__global__ void lstm_rec_kernel(const T* __restrict__ x_proj,
                                const uint8_t* __restrict__ mask,
                                const T* __restrict__ w_hh,
                                T* __restrict__ out, int n_rows, int n_steps,
                                int h_dim, int reverse) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [h_dim][kStride]

  const int j = threadIdx.x % h_dim;
  const int rg = threadIdx.x / h_dim;
  const int my_row0 = blockIdx.x * kRows + rg * kRowsPerThread;
  const int g4 = 4 * h_dim;

  float h[kRowsPerThread];
  float c[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    h[i] = 0.0f;
    c[i] = 0.0f;
  }

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;

    // the accumulators start from the projected input (rows past the end: 0)
    float acc[4][kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      if (row < n_rows) {
        const T* xp = x_proj + ((size_t)row * n_steps + t) * g4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][i] = to_f32(__ldg(xp + g * h_dim));
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][i] = 0.0f;
      }
    }

    float hr[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) hr[i] = round_to<T>(h[i]);
    store_rows(hs, j, rg, hr);
    __syncthreads();
    dot_rows<4, T>(acc, hs, 0, rg, w_hh + j, h_dim, g4, h_dim);

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
    __syncthreads();  // the next step overwrites the staged h
  }
}

template <typename T>
int launch(const void* x_proj, const void* mask, const void* w_hh, void* out,
           int n_rows, int n_steps, int h_dim, int reverse,
           cudaStream_t stream) {
  const size_t smem = (size_t)h_dim * kStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_rec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it so the next launch reads clean
    return (int)err;
  }
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const dim3 block(kRowGroups * h_dim);
  lstm_rec_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_hh), static_cast<T*>(out), n_rows, n_steps,
      h_dim, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 6.  x_proj [B, T, 4H], mask uint8 [B, T], w_hh [H, 4H],
// out [B, T, H]; all contiguous, one dtype (0 = float32, 1 = bfloat16).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cair_lstm_rec(const void* x_proj, const void* mask,
                             const void* w_hh, void* out, int n_rows,
                             int n_steps, int h_dim, int reverse, int dtype,
                             void* stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  if (h_dim <= 0 || kRowGroups * h_dim > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x_proj, mask, w_hh, out, n_rows, n_steps, h_dim,
                         reverse, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x_proj, mask, w_hh, out, n_rows, n_steps,
                                 h_dim, reverse, s);
  return (int)cudaErrorInvalidValue;
}
