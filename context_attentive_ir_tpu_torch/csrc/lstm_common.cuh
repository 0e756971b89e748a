// Device helpers shared by the recurrent kernels: the LSTM kernels
// (lstm_fwd.cu, lstm_bwd.cu, lstm_rec.cu) and the GRU pair (gru_fwd.cu,
// gru_bwd.cu).
//
// Two families live here.
//
// - The CUDA-core row-tile layout (the float32 LSTM, kernel 6 and the GRU
//   kernels): a block owns kRows = 32 rows and has kRowGroups * H threads;
//   thread (rg, j) owns hidden unit j of rows rg*16 .. rg*16+15.  Operands
//   of a product are staged in shared memory k-major in f32, one padded row
//   of kStride floats per k, so a thread reads its 16 rows as four float4
//   broadcasts and multiplies with exact f32 FMAs (dot_rows).  Those
//   broadcasts, not FMAs or bytes, bound that layout; the bf16 LSTM kernels
//   left it for tensor-core tiles (lstm_mma.cuh).
// - The bf16 tensor-core primitives (namespace tiles: `cp.async`,
//   `ldmatrix`, `mma.sync.m16n8k16`), used by lstm_mma.cuh and by phase B.
//
// The backward kernels share the weight-gradient reduction (phase B):
// launch_wgrad_partial (tensor-core tiles for bf16, exact f32 FMAs for
// float32) and sum_partials_kernel, in a fixed order with no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Stage [x_t | h] for the block's rows in `tile` ((e + h_dim) k-major rows),
// h rounded to T (the recurrent product reads h in the input dtype, as the
// TPU kernels do), and synchronise.  The caller synchronises again before
// the tile is overwritten.
template <typename T>
__device__ __forceinline__ void stage_x_h(float* tile, const T* __restrict__ x,
                                          const float h[kRowsPerThread],
                                          int row0, int n_rows, int n_steps,
                                          int t, int e, int j, int rg) {
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
}

// One LSTM step's gate pre-activations for the thread's 16 rows and unit j:
// acc[g][i] = bias_g + x_t @ W_ih[:, g*H + j] + h @ W_hh[:, g*H + j].
// Stages [x_t | h] (stage_x_h).
template <typename T>
__device__ __forceinline__ void gate_preacts(
    float acc[4][kRowsPerThread], float* tile, const T* __restrict__ x,
    const T* __restrict__ w_ih, const T* __restrict__ w_hh,
    const float bg[4], const float h[kRowsPerThread], int row0, int n_rows,
    int n_steps, int t, int e, int h_dim, int j, int rg) {
  stage_x_h<T>(tile, x, h, row0, n_rows, n_steps, t, e, j, rg);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[g][i] = bg[g];
  }
  const int g4 = 4 * h_dim;
  dot_rows<4, T>(acc, tile, 0, rg, w_ih + j, e, g4, h_dim);
  dot_rows<4, T>(acc, tile, e, rg, w_hh + j, h_dim, g4, h_dim);
}


// -- bf16 tensor-core primitives (used by lstm_mma.cuh and by phase B) -------

namespace tiles {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; !valid writes zeros (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tiles


// -- phase B of the backward kernels: dW = A^T G over all (row, step) pairs --
//
// Templates with external linkage in this named namespace, instantiated in
// each backward kernel's file.  (An unnamed namespace here would collide
// with the including file's own in nvcc's generated launch stubs.)

constexpr int kTile = 64;   // output tile (kTile x kTile)
constexpr int kTileK = 32;  // rows per staged slab
constexpr int kMaxSplits = 32;

inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

// The (row, step) pairs split into up to kMaxSplits ranges of a multiple of
// kTileK rows, one per grid z, to fill the card.
struct Splits {
  int splits, rows_per_split;
};

inline Splits make_splits(long long n) {
  long long splits = n / 8192;
  Splits s;
  s.splits = (int)(splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits
                                                          : splits));
  const long long per = (n + s.splits - 1) / s.splits;
  s.rows_per_split = (int)((per + kTileK - 1) / kTileK * kTileK);
  return s;
}

// partial[z][m][out_col0 + c] (rows of out_ld floats) = sum over the rows r
// of split z of a[r][m] * g[r][c]: a [n_rows, a_cols], g read at columns
// c < g_cols of rows g_ld apart; f32 FMAs in row order.  256 threads, a
// kTile x kTile output tile per block, 4 x 4 per thread.
template <typename T>
__global__ void wgrad_partial_kernel(const T* __restrict__ a, int a_cols,
                                     const T* __restrict__ g, int g_cols,
                                     int g_ld, int n_rows, int rows_per_split,
                                     float* __restrict__ partial, int out_ld,
                                     int out_col0) {
  __shared__ __align__(16) float as[kTileK][kTile + 4];
  __shared__ __align__(16) float gs[kTileK][kTile + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
  }
  for (int rb = r_begin; rb < r_end; rb += kTileK) {
    for (int idx = threadIdx.x; idx < kTileK * kTile; idx += blockDim.x) {
      const int kk = idx / kTile;
      const int mm = idx - kk * kTile;
      const int r = rb + kk;
      const bool in = r < r_end;
      as[kk][mm] = (in && m0 + mm < a_cols)
                       ? to_f32(a[(size_t)r * a_cols + m0 + mm])
                       : 0.0f;
      gs[kk][mm] = (in && n0 + mm < g_cols)
                       ? to_f32(g[(size_t)r * g_ld + n0 + mm])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 gv = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += a4[i] * b4[jj];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int nn = n0 + tx * 4 + jj;
      if (m < a_cols && nn < g_cols)
        partial[((size_t)blockIdx.z * a_cols + m) * out_ld + out_col0 + nn] =
            acc[i][jj];
    }
  }
}

// The bf16 form of wgrad_partial_kernel on tensor cores: the same
// partial[z] tile sums as `mma.sync.m16n8k16` (bf16 in, f32 accumulate).
// A 128 x 128 output tile per block of 8 warps (2 x 4 warps of 64 x 32);
// the rows of a split arrive in slabs of kWgK rows of `a` and `g` through a
// kWgStages-deep `cp.async` ring, staged as they lie in memory (k-major), so
// both operands are read through `ldmatrix.trans`.  Rows past the split and
// columns past the matrices are zero-filled.  The instruction order is
// fixed, so a partial is the same bits every run.  Needs 16-byte aligned
// `a` and `g` and a_cols, g_cols, g_ld multiples of 8.
constexpr int kWgTile = 128;
constexpr int kWgK = 32;
constexpr int kWgStages = 4;
constexpr int kWgStride = kWgTile * 2 + 16;  // bytes per staged row
constexpr int kWgSlab = kWgK * kWgStride;
constexpr int kWgSmem = kWgStages * 2 * kWgSlab;

template <typename T>  // T = __nv_bfloat16 (a template for its linkage)
__global__ void __launch_bounds__(256)
wgrad_partial_mma_kernel(const T* __restrict__ a, int a_cols,
                         const T* __restrict__ g, int g_cols,
                         int g_ld, int n_rows, int rows_per_split,
                         float* __restrict__ partial, int out_ld,
                         int out_col0) {
  using namespace tiles;
  extern __shared__ __align__(16) char wg_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * kWgTile;
  const int n0 = blockIdx.y * kWgTile;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  const int n_iter = r_end > r_begin ? (r_end - r_begin + kWgK - 1) / kWgK : 0;

  auto load = [&](int it) {
    char* as = wg_smem + (it % kWgStages) * 2 * kWgSlab;
    char* gs = as + kWgSlab;
    const int rb = r_begin + it * kWgK;
    for (int idx = threadIdx.x; idx < kWgK * (kWgTile / 8); idx += 256) {
      const int r = idx / (kWgTile / 8);
      const int c = idx - r * (kWgTile / 8);
      const int row = rb + r;
      const bool va = row < r_end && m0 + c * 8 < a_cols;
      const bool vg = row < r_end && n0 + c * 8 < g_cols;
      cp_async16(as + r * kWgStride + c * 16,
                 va ? a + (size_t)row * a_cols + m0 + c * 8 : a, va);
      cp_async16(gs + r * kWgStride + c * 16,
                 vg ? g + (size_t)row * g_ld + n0 + c * 8 : g, vg);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  for (int p = 0; p < kWgStages - 1; ++p) {
    if (p < n_iter) load(p);
    cp_async_commit();
  }
  const int a_k = (lane & 7) + (lane >> 4) * 8, a_m = ((lane >> 3) & 1) * 8;
  const int b_k = lane & 15, b_n = (lane >> 4) * 8;
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    if (it + kWgStages - 1 < n_iter) load(it + kWgStages - 1);
    cp_async_commit();
    const char* as = wg_smem + (it % kWgStages) * 2 * kWgSlab;
    const char* gs = as + kWgSlab;
#pragma unroll
    for (int kk = 0; kk < kWgK; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_trans(af[mt], as + (kk + a_k) * kWgStride +
                                  (wm * 64 + mt * 16 + a_m) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(bf[np], gs + (kk + b_k) * kWgStride +
                                  (wn * 32 + np * 16 + b_n) * 2);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[np][0], bf[np][1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[np][2], bf[np][3]);
        }
    }
  }
  const int gq = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + wm * 64 + mt * 16 + gq + (v >> 1) * 8;
        const int nn = n0 + wn * 32 + nt * 8 + 2 * tg + (v & 1);
        if (m < a_cols && nn < g_cols)
          partial[((size_t)blockIdx.z * a_cols + m) * out_ld + out_col0 + nn] =
              acc[mt][nt][v];
      }
}

// One phase-B product: the tensor-core kernel for bf16 operands it can
// take, wgrad_partial_kernel's exact f32 FMAs otherwise (float32 always).
template <typename T>
inline cudaError_t launch_wgrad_partial(const T* a, int a_cols, const T* g,
                                        int g_cols, int g_ld, int n_rows,
                                        Splits sp, float* partial, int out_ld,
                                        int out_col0, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tiles::aligned16(a) && tiles::aligned16(g) && a_cols % 8 == 0 &&
        g_cols % 8 == 0 && g_ld % 8 == 0) {
      cudaError_t err = cudaFuncSetAttribute(
          wgrad_partial_mma_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
      if (err != cudaSuccess) return err;
      wgrad_partial_mma_kernel<T><<<dim3((a_cols + kWgTile - 1) / kWgTile,
                                         (g_cols + kWgTile - 1) / kWgTile,
                                         sp.splits),
                                    256, kWgSmem, stream>>>(
          a, a_cols, g, g_cols, g_ld, n_rows, sp.rows_per_split, partial,
          out_ld, out_col0);
      return cudaGetLastError();
    }
  }
  wgrad_partial_kernel<T><<<dim3((a_cols + kTile - 1) / kTile,
                                 (g_cols + kTile - 1) / kTile, sp.splits),
                            256, 0, stream>>>(a, a_cols, g, g_cols, g_ld,
                                              n_rows, sp.rows_per_split,
                                              partial, out_ld, out_col0);
  return cudaGetLastError();
}

// out[idx] = sum_z partial[z * stride + idx] in z order, cast to T
template <typename T>
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int parts, int stride, int count,
                                    T* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  float s = 0.0f;
  for (int z = 0; z < parts; ++z) s += partial[(size_t)z * stride + idx];
  out[idx] = from_f32<T>(s);
}

}  // namespace cair_lstm
