// Fused masked LSTM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lstm_fused_kernel` / `_lstm_fused_impl` in
// context_attentive_ir_tpu/ops/pallas/lstm.py (the `lstm_pallas_fused`
// forward).  Per step t and row b:
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
// x + h traffic (0.11 ms at 3.35 TB/s): compute-bound.
//
// Design (first, simple version): the TPU walks (batch_tile, time_chunk) in
// order with h/c in VMEM scratch.  Here one thread block owns kRows = 32 rows
// and runs all T steps itself; blocks run in parallel over row tiles.  The
// block has 2*H threads; thread (rg, j) owns hidden unit j of rows
// rg*16 .. rg*16+15, keeps their h and c in registers (f32) and computes all
// four gates of unit j, so the cell update needs no exchange.  Each step
// stages [x_t | h] for the block's rows in shared memory (f32, k-major so a
// thread reads its 16 rows as four float4 broadcasts) and accumulates the
// gates with f32 FMAs; W_ih and W_hh (768 KB at f32) are streamed from
// global memory and stay resident in the 50 MB L2.  No tensor cores yet, so
// the kernel runs at the CUDA-core FMA rate, far above the bound: the
// sequential T loop and the FMA path are what a later version replaces
// (wgmma on bf16 tiles, W_hh resident in shared memory).
//
// As in the TPU kernel, h is rounded to the input dtype before the
// recurrent product (`hs.astype(whh_ref.dtype)`); everything else is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerThread = 16;
constexpr int kRowGroups = 2;
constexpr int kRows = kRowsPerThread * kRowGroups;  // rows per block
constexpr int kStride = kRows + 4;  // padded shared row, keeps 16-B alignment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <typename T>
__global__ void lstm_fwd_kernel(const T* __restrict__ x,
                                const uint8_t* __restrict__ mask,
                                const T* __restrict__ w_ih,
                                const T* __restrict__ bias,
                                const T* __restrict__ w_hh,
                                T* __restrict__ out, int n_rows, int n_steps,
                                int e, int h_dim, int reverse) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [(e + h_dim)][kStride]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int j = tid % h_dim;
  const int rg = tid / h_dim;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;
  const int g4 = 4 * h_dim;

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

  const float* a_base = xs + rg * kRowsPerThread;

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;

    // stage x_t for the block's rows (zero past the last row)
    for (int idx = tid; idx < kRows * e; idx += nthreads) {
      const int r = idx / e;
      const int k = idx - r * e;
      const int row = row0 + r;
      float v = 0.0f;
      if (row < n_rows) v = to_f32(x[((size_t)row * n_steps + t) * e + k]);
      xs[k * kStride + r] = v;
    }
    // stage h, rounded to the input dtype like the TPU kernel
    float* hs = xs + (size_t)(e + j) * kStride + rg * kRowsPerThread;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; i += 4) {
      reinterpret_cast<float4*>(hs)[i / 4] = make_float4(
          to_f32(from_f32<T>(h[i])), to_f32(from_f32<T>(h[i + 1])),
          to_f32(from_f32<T>(h[i + 2])), to_f32(from_f32<T>(h[i + 3])));
    }
    __syncthreads();

    float acc[4][kRowsPerThread];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[g][i] = bg[g];
    }

    // input projection: x_t @ W_ih
#pragma unroll 2
    for (int k = 0; k < e; ++k) {
      const float4* a4 = reinterpret_cast<const float4*>(a_base + k * kStride);
      float a[kRowsPerThread];
#pragma unroll
      for (int q = 0; q < kRowsPerThread / 4; ++q) {
        const float4 v = a4[q];
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      const T* wr = w_ih + (size_t)k * g4 + j;
      float w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = to_f32(__ldg(wr + g * h_dim));
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[g][i] += a[i] * w[g];
      }
    }
    // recurrence: h @ W_hh
#pragma unroll 2
    for (int k = 0; k < h_dim; ++k) {
      const float4* a4 =
          reinterpret_cast<const float4*>(a_base + (e + k) * kStride);
      float a[kRowsPerThread];
#pragma unroll
      for (int q = 0; q < kRowsPerThread / 4; ++q) {
        const float4 v = a4[q];
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      const T* wr = w_hh + (size_t)k * g4 + j;
      float w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = to_f32(__ldg(wr + g * h_dim));
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[g][i] += a[i] * w[g];
      }
    }

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

template <typename T>
int launch(const void* x, const void* mask, const void* w_ih, const void* b,
           const void* w_hh, void* out, int n_rows, int n_steps, int e,
           int h_dim, int reverse, cudaStream_t stream) {
  const size_t smem = (size_t)(e + h_dim) * kStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {  // e.g. E + H too large for the shared tile
    cudaGetLastError();      // clear it so the next launch reads clean
    return (int)err;
  }
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const dim3 block(kRowGroups * h_dim);
  lstm_fwd_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b),
      static_cast<const T*>(w_hh), static_cast<T*>(out), n_rows, n_steps, e,
      h_dim, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T, E], mask uint8 [B, T], w_ih [E, 4H], b [4H], w_hh [H, 4H],
// out [B, T, H]; all contiguous, one dtype (0 = float32, 1 = bfloat16).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cair_lstm_fwd(const void* x, const void* mask,
                             const void* w_ih, const void* b,
                             const void* w_hh, void* out, int n_rows,
                             int n_steps, int e, int h_dim, int reverse,
                             int dtype, void* stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  if (h_dim <= 0 || kRowGroups * h_dim > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, w_ih, b, w_hh, out, n_rows, n_steps, e,
                         h_dim, reverse, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, w_ih, b, w_hh, out, n_rows,
                                 n_steps, e, h_dim, reverse, s);
  return (int)cudaErrorInvalidValue;
}
