// Device helpers shared by the recurrent kernels: the LSTM kernels
// (lstm_fwd.cu, lstm_bwd.cu, lstm_rec.cu) and the GRU pair (gru_fwd.cu,
// gru_bwd.cu).
//
// Two families live here.
//
// - The CUDA-core row-tile layout, whose only users are kernel 6's
//   CUDA-core kernel (lstm_rec.cu) and the float32 step route
//   (lstm_step.cu): a block owns kRows = 32 rows and has kRowGroups * H
//   threads (a step-route block kRowGroups * kF32Units); thread (rg, j)
//   owns hidden unit j of rows rg*16 .. rg*16+15.  Operands of a product
//   are staged in shared memory k-major in f32, one padded row of kStride
//   floats per k, so a thread reads its 16 rows as four float4 broadcasts
//   and multiplies with exact f32 FMAs (dot_rows).  Those broadcasts, not
//   FMAs or bytes, bound that layout; every other recurrent kernel left it
//   for tensor-core tiles (lstm_mma.cuh; float32 in split TF32,
//   tf32_mma.cuh).
// - The bf16 tensor-core primitives (namespace tiles: `cp.async`,
//   `ldmatrix`, `mma.sync.m16n8k16`), used by lstm_mma.cuh (the LSTM and
//   GRU forwards, the backwards' phase A) and by phase B.
//
// The backward kernels share the weight-gradient reduction (phase B):
// launch_wgrad_partial (tf32_mma.cuh: tensor-core tiles, bf16 or split
// TF32 for float32) and sum_partials_kernel, in a fixed order with no
// atomics.

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

// A row-tile block has kRowGroups * H threads, and all of them must find
// their registers in the SM's 65,536: the kernels (up to 255 registers a
// thread) are instantiated with __launch_bounds__ of 256, 512 and 1024
// threads (at most 255, 128 and 64 registers a thread; spilling above 256)
// and launched through the smallest that holds the block.  0: no bound
// holds it.
inline int row_tile_bound(int threads) {
  return threads <= 256 ? 256 : threads <= 512 ? 512 : threads <= 1024 ? 1024
                                                                        : 0;
}

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

// The float32 tensor-core kernels (split TF32: the forwards 1, 4, 7, 8 and
// the backwards 5, 9) split H over the same ranks: one block up to
// kF32Rank = 128 units, then clusters of 2, 4 or 8 ranks of at most 128
// units each -- 2 up to 256, 4 up to 512, 8 up to 1,024 (a rank's H / C
// units a multiple of 16: the wrapper pads H to it).  Each kernel picks
// its own rows a rank (lstm_mma.cuh: f32_fwd_groups and
// f32_fwd_smem, pick_config_f32 and cluster_config_f32).  `f32_cluster` in
// ops/kernels/lstm.py states the same rule.  The float32 step route above
// H = 1,024 (lstm_step.cu) stages x_t and h in chunks of kF32Chunk k-rows
// and takes unit tiles of kF32Units.
constexpr int kF32Chunk = 256;
constexpr int kF32Units = 128;  // units of a float32 step-route unit tile
constexpr int kF32MaxRanks = 8;
constexpr int kF32Rank = 128;   // units a float32 rank holds at most

inline int f32_cluster(int h) {
  int c = 1;
  while (c < kF32MaxRanks && h > c * kF32Rank) c *= 2;
  return h <= c * kF32Rank ? c : 0;
}

// Stage x_t[k0 .. k0 + kn - 1] for the block's rows k-major in `xt` and
// synchronise the block.
template <typename T>
__device__ __forceinline__ void stage_x_chunk(float* xt,
                                              const T* __restrict__ x,
                                              int row0, int n_rows,
                                              int n_steps, int t, int e,
                                              int k0, int kn) {
  for (int idx = threadIdx.x; idx < kRows * kn; idx += blockDim.x) {
    const int r = idx / kn;
    const int k = idx - r * kn;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < n_rows) v = to_f32(x[((size_t)row * n_steps + t) * e + k0 + k]);
    xt[(size_t)k * kStride + r] = v;
  }
  __syncthreads();
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

// two transposed 8 x 8 matrices: rows from the addresses of lanes 0 .. 15
// (lanes 16 .. 31 pass addresses that are not read)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// two 8 x 8 matrices: rows from the addresses of lanes 0 .. 15 (lanes
// 16 .. 31 pass addresses that are not read)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// A float4 to or from global memory through an instruction the compiler
// keeps where it stands (it forwards no value from such a store to a later
// load), so the registers of what is stored are free in between.
__device__ __forceinline__ void st_global_f4(float4* p, float4 v) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 ld_global_f4(const float4* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 f4_of(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void f4_to(float (&v)[4], float4 a) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
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
//
// kAM: `a` lies m-major instead, a[m][r] in rows of a_ld elements (then
// n_rows is a multiple of kWgK, one split), staged so and read through a
// plain `ldmatrix`; the output is OutT.  So out = A @ G for a row-major A
// [a_cols, n_rows] (rows a_ld apart) and G [n_rows, g_cols]: a cluster's
// phase C, dx = dgates_c @ W_ih^T (launch_matmul).
constexpr int kWgTile = 128;
constexpr int kWgK = 32;
constexpr int kWgStages = 4;
constexpr int kWgStride = kWgTile * 2 + 16;  // bytes per staged k-major row
constexpr int kWgSlab = kWgK * kWgStride;
constexpr int kWgAmStride = kWgK * 2 + 16;   // bytes per staged m-major row

__host__ __device__ constexpr int wg_a_slab(bool am) {
  return am ? kWgTile * kWgAmStride : kWgSlab;
}
__host__ __device__ constexpr int wg_smem(bool am) {
  return kWgStages * (wg_a_slab(am) + kWgSlab);
}

template <typename T, bool kAM, typename OutT>  // T = __nv_bfloat16
__global__ void __launch_bounds__(256)
wgrad_partial_mma_kernel(const T* __restrict__ a, int a_cols,
                         const T* __restrict__ g, int g_cols,
                         int g_ld, int n_rows, int rows_per_split,
                         OutT* __restrict__ partial, int out_ld,
                         int out_col0, int a_ld) {
  using namespace tiles;
  extern __shared__ __align__(16) char wg_smem_buf[];
  constexpr int kStage = wg_a_slab(kAM) + kWgSlab;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * kWgTile;
  const int n0 = blockIdx.y * kWgTile;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  const int n_iter = r_end > r_begin ? (r_end - r_begin + kWgK - 1) / kWgK : 0;

  auto load = [&](int it) {
    char* as = wg_smem_buf + (it % kWgStages) * kStage;
    char* gs = as + wg_a_slab(kAM);
    const int rb = r_begin + it * kWgK;
    for (int idx = threadIdx.x; idx < kWgK * (kWgTile / 8); idx += 256) {
      const int r = idx / (kWgTile / 8);
      const int c = idx - r * (kWgTile / 8);
      const int row = rb + r;
      if constexpr (kAM) {
        // the same count of 16-byte pieces: row m = idx / 4, piece idx % 4
        const int m = idx / (kWgK / 8), p = idx - m * (kWgK / 8);
        const bool va = m0 + m < a_cols;
        cp_async16(as + m * kWgAmStride + p * 16,
                   va ? a + (size_t)(m0 + m) * a_ld + rb + p * 8 : a, va);
      } else {
        const bool va = row < r_end && m0 + c * 8 < a_cols;
        cp_async16(as + r * kWgStride + c * 16,
                   va ? a + (size_t)row * a_cols + m0 + c * 8 : a, va);
      }
      const bool vg = row < r_end && n0 + c * 8 < g_cols;
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
    const char* as = wg_smem_buf + (it % kWgStages) * kStage;
    const char* gs = as + wg_a_slab(kAM);
#pragma unroll
    for (int kk = 0; kk < kWgK; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if constexpr (kAM)
          ldsm_x4(af[mt], as + (wm * 64 + mt * 16 + (lane & 15)) * kWgAmStride +
                              (kk + (lane >> 4) * 8) * 2);
        else
          ldsm_x4_trans(af[mt], as + (kk + a_k) * kWgStride +
                                    (wm * 64 + mt * 16 + a_m) * 2);
      }
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
              from_f32<OutT>(acc[mt][nt][v]);
      }
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

// Phase C of a cluster's backward (lstm_bwd.cu, gru_bwd.cu) in bf16: dx
// = dgates_c @ W_ih^T, out [n_rows, n_cols] = a [n_rows, k_dim] (rows lda
// elements apart: the GRU's first three of four gradient slots) @ b
// [k_dim, n_cols], all row-major, on tensor cores
// (wgrad_partial_mma_kernel with `a` m-major: k_dim a multiple of kWgK,
// n_cols and lda of 8, 16-byte aligned operands).  float32's is
// launch_matmul_tf32 (tf32_mma.cuh).
inline cudaError_t launch_matmul(const __nv_bfloat16* a, int lda,
                                 const __nv_bfloat16* b, int n_rows,
                                 int n_cols, int k_dim, __nv_bfloat16* out,
                                 cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (k_dim % kWgK != 0 || n_cols % 8 != 0 || lda % 8 != 0 ||
      !tiles::aligned16(a) || !tiles::aligned16(b))
    return cudaErrorInvalidValue;
  auto* kernel = wgrad_partial_mma_kernel<T, true, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem(true));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_rows + kWgTile - 1) / kWgTile,
                (n_cols + kWgTile - 1) / kWgTile, 1),
           256, wg_smem(true), stream>>>(a, n_rows, b, n_cols, n_cols,
                                         k_dim, k_dim, out, n_cols, 0, lda);
  return cudaGetLastError();
}

}  // namespace cair_lstm
