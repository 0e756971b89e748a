// Device helpers shared by the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu).
//
// Thread layout of every row-tile kernel here: a block owns kRows = 32 rows
// and has kRowGroups * H threads; thread (rg, j) owns hidden unit j of rows
// rg*16 .. rg*16+15.  Operands of a product are staged in shared memory
// k-major, one padded row of kStride floats per k, so a thread reads its 16
// rows as four float4 broadcasts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cair_lstm {

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

// v rounded to T and back: the value a product in T would read
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Store the thread's 16 row values into a k-major shared tile at row k.
__device__ __forceinline__ void store_rows(float* tile, int k, int rg,
                                           const float v[kRowsPerThread]) {
  float4* dst =
      reinterpret_cast<float4*>(tile + (size_t)k * kStride + rg * kRowsPerThread);
#pragma unroll
  for (int q = 0; q < kRowsPerThread / 4; ++q)
    dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// acc[g][i] += sum_k tile[k0 + k][row i] * w[k * w_row + g * g_stride] for
// k < k_count: the thread's 16 rows of the staged operand times NG weight
// columns (w points at the thread's first column).  f32 FMAs in k order.
template <int NG, typename T>
__device__ __forceinline__ void dot_rows(float acc[NG][kRowsPerThread],
                                         const float* tile, int k0, int rg,
                                         const T* __restrict__ w, int k_count,
                                         int w_row, int g_stride) {
  const float* a_base = tile + (size_t)k0 * kStride + rg * kRowsPerThread;
#pragma unroll 2
  for (int k = 0; k < k_count; ++k) {
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
    const T* wr = w + (size_t)k * w_row;
    float wv[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) wv[g] = to_f32(__ldg(wr + g * g_stride));
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[g][i] += a[i] * wv[g];
    }
  }
}

// One step's gate pre-activations for the thread's 16 rows and unit j:
// acc[g][i] = bias_g + x_t @ W_ih[:, g*H + j] + h @ W_hh[:, g*H + j], with
// h rounded to T before the recurrent product (as the TPU kernel does).
// Stages [x_t | h] in `tile` ((e + h_dim) rows) and synchronises; the caller
// synchronises again before the tile is overwritten.
template <typename T>
__device__ __forceinline__ void gate_preacts(
    float acc[4][kRowsPerThread], float* tile, const T* __restrict__ x,
    const T* __restrict__ w_ih, const T* __restrict__ w_hh,
    const float bg[4], const float h[kRowsPerThread], int row0, int n_rows,
    int n_steps, int t, int e, int h_dim, int j, int rg) {
  for (int idx = threadIdx.x; idx < kRows * e; idx += blockDim.x) {
    const int r = idx / e;
    const int k = idx - r * e;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < n_rows) v = to_f32(x[((size_t)row * n_steps + t) * e + k]);
    tile[(size_t)k * kStride + r] = v;
  }
  float hr[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) hr[i] = round_to<T>(h[i]);
  store_rows(tile, e + j, rg, hr);
  __syncthreads();

#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[g][i] = bg[g];
  }
  const int g4 = 4 * h_dim;
  dot_rows<4, T>(acc, tile, 0, rg, w_ih + j, e, g4, h_dim);
  dot_rows<4, T>(acc, tile, e, rg, w_hh + j, h_dim, g4, h_dim);
}

}  // namespace cair_lstm
