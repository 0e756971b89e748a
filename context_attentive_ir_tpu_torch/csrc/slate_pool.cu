// Fused query-aware attention pool for Hopper (sm_90a): for every row r,
//   h_t    = tanh(states[r, t] @ W_p + b_p)
//   s_t    = h_t . query[r]
//   pooled = sum_t masked_softmax(s)_t * states[r, t]
// streaming the tokens once, with an online softmax whose running max m,
// sum s and weighted sum acc are float32: masked tokens score -1e30 and
// weigh 0, pooled = acc / max(s, 1e-13), so a fully masked row pools to
// exactly 0.  The output has the states' dtype.
//
// Replaces the TPU kernel `_pool_kernel` / `_pool_fused_impl` in
// context_attentive_ir_tpu/ops/pallas/slate.py (CARS's query-aware doc
// pooling, `use_pallas_slate`).
//
// What bounds it on the H100: at the CARS slate (R = B*S*N = 16,000 rows,
// T = 30, H = 256, bf16) one call is 2*R*T*H^2 = 6.3e10 flops (0.064 ms at
// the 989 TFLOP/s bf16 tensor-core peak) against 262 MB of states, queries
// and output (0.078 ms at 3.35 TB/s): memory-bound; the projection is the
// only work the TPU version already kept out of device memory.
//
// Design (first, simple version): a block of 8 warps owns 64 rows (32 when
// H > 256: 8 or 4 rows per warp) and walks the T tokens.  Per token it
// stages the rows' states in shared memory as f32 (row-major), then each
// warp computes its rows' projection with CUDA-core FMAs, each lane owning
// H/32 contiguous output columns: acc[row][col] = sum_k xs[row][k] *
// W_p[k][col], W_p read from shared memory (bf16 at H <= 256: 128 KB) or
// from L2 (f32, or H > 256).  The epilogue stays in registers: tanh, the
// dot with the query (a warp sum), the online-softmax update and the
// running weighted sum of the staged states.  The [R, T, H] projection never
// reaches device memory.  The product runs on CUDA cores, so the kernel
// runs far above its bound; tensor cores (mma / wgmma on the staged token
// tile) are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskedScore = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void unpack(const uint2& u, float* out,
                                       const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
}
__device__ __forceinline__ void unpack(const uint2& u, float* out,
                                       const __nv_bfloat16*) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// n consecutive elements at p (8-byte aligned, n * sizeof(T) a multiple of
// 8) as floats, in 8-byte loads; kGlobal reads through the read-only cache
template <typename T, int N, bool kGlobal>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  constexpr int kPer = 8 / sizeof(T);
  static_assert(N % kPer == 0, "row length must fill 8-byte loads");
  const uint2* p2 = reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < N / kPer; ++i) {
    uint2 u;
    if constexpr (kGlobal) {
      u = __ldg(p2 + i);
    } else {
      u = p2[i];
    }
    unpack(u, out + i * kPer, p);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int kCols, int kRowsPerWarp, bool kWShared>
__global__ void __launch_bounds__(kWarps * 32)
slate_pool_kernel(const T* __restrict__ states, const bool* __restrict__ mask,
                  const T* __restrict__ query, const T* __restrict__ w_p,
                  const T* __restrict__ b_p, T* __restrict__ out, int n_rows,
                  int t_len) {
  constexpr int H = 32 * kCols;
  constexpr int kRowBlock = kWarps * kRowsPerWarp;
  constexpr int kPer16 = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);             // [kRowBlock][H]
  T* ws = reinterpret_cast<T*>(xs + kRowBlock * H);        // [H][H]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int col0 = lane * kCols;

  if constexpr (kWShared) {
    const uint4* src = reinterpret_cast<const uint4*>(w_p);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    for (int i = tid; i < H * H / kPer16; i += blockDim.x) dst[i] = __ldg(src + i);
  }
  const T* w = kWShared ? ws : w_p;

  float bias[kCols];
  load_row<T, kCols, true>(b_p + col0, bias);
  float pooled[kRowsPerWarp][kCols], m_run[kRowsPerWarp], s_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kMaskedScore;
    s_run[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) pooled[r][c] = 0.0f;
  }
  const float* a_base = xs + warp * kRowsPerWarp * H;

  for (int t = 0; t < t_len; ++t) {
    __syncthreads();  // the previous token's readers of xs are done
    for (int i = tid; i < kRowBlock * H / kPer16; i += blockDim.x) {
      const int r = i / (H / kPer16);
      const int k = (i - r * (H / kPer16)) * kPer16;
      const int row = row0 + r;
      float v[kPer16];
      if (row < n_rows) {
        load_row<T, kPer16, true>(states + ((size_t)row * t_len + t) * H + k,
                                  v);
      } else {
#pragma unroll
        for (int j = 0; j < kPer16; ++j) v[j] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(xs + r * H + k);
#pragma unroll
      for (int j = 0; j < kPer16 / 4; ++j)
        dst[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                             v[4 * j + 3]);
    }
    __syncthreads();

    float acc[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      float wv[kCols];
      load_row<T, kCols, !kWShared>(w + (size_t)k * H + col0, wv);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float a = a_base[r * H + k];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(a, wv[c], acc[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + warp * kRowsPerWarp + r;
      float part = 0.0f;
      if (row < n_rows) {
        float q[kCols];
        load_row<T, kCols, true>(query + (size_t)row * H + col0, q);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          part += tanhf(acc[r][c] + bias[c]) * q[c];
      }
      const float score = warp_sum(part);
      const bool valid = row < n_rows && mask[(size_t)row * t_len + t];
      const float sc = valid ? score : kMaskedScore;
      const float m_new = fmaxf(m_run[r], sc);
      const float alpha = expf(m_run[r] - m_new);
      const float p = valid ? expf(sc - m_new) : 0.0f;
      s_run[r] = s_run[r] * alpha + p;
      const float* x_r = a_base + r * H + col0;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        pooled[r][c] = pooled[r][c] * alpha + p * x_r[c];
      m_run[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    const float den = fmaxf(s_run[r], 1e-13f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(out + (size_t)row * H + col0 + c, pooled[r][c] / den);
  }
}

template <typename T, int kCols, int kRowsPerWarp, bool kWShared>
int launch(const void* states, const void* mask, const void* query,
           const void* w_p, const void* b_p, void* out, int n_rows,
           int t_len, cudaStream_t stream) {
  constexpr int H = 32 * kCols;
  constexpr int kRowBlock = kWarps * kRowsPerWarp;
  const size_t smem = (size_t)kRowBlock * H * sizeof(float) +
                      (kWShared ? (size_t)H * H * sizeof(T) : 0);
  auto kernel = slate_pool_kernel<T, kCols, kRowsPerWarp, kWShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it so the next launch reads clean
    return (int)err;
  }
  kernel<<<(n_rows + kRowBlock - 1) / kRowBlock, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(states), static_cast<const bool*>(mask),
      static_cast<const T*>(query), static_cast<const T*>(w_p),
      static_cast<const T*>(b_p), static_cast<T*>(out), n_rows, t_len);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_h(const void* states, const void* mask, const void* query,
             const void* w_p, const void* b_p, void* out, int n_rows,
             int t_len, int h, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;  // W_p in shared memory at H <= 256
  switch (h) {
    case 128:
      return launch<T, 4, 8, kBf16>(states, mask, query, w_p, b_p, out,
                                    n_rows, t_len, stream);
    case 256:
      return launch<T, 8, 8, kBf16>(states, mask, query, w_p, b_p, out,
                                    n_rows, t_len, stream);
    case 384:
      return launch<T, 12, 4, false>(states, mask, query, w_p, b_p, out,
                                     n_rows, t_len, stream);
    case 512:
      return launch<T, 16, 4, false>(states, mask, query, w_p, b_p, out,
                                     n_rows, t_len, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// states [R, T, H], mask bool [R, T], query [R, H], w_p [H, H], b_p [H]
// (contiguous, one dtype: 0 = float32, 1 = bfloat16; states, query and w_p
// 16-byte aligned) -> out [R, H] in that dtype.  H must be 128, 256, 384 or
// 512.  Returns the cudaError_t (0 = ok).
extern "C" int cair_slate_pool(const void* states, const void* mask,
                               const void* query, const void* w_p,
                               const void* b_p, void* out, int n_rows,
                               int t_len, int h, int dtype, void* stream) {
  if (n_rows == 0) return 0;
  if (t_len < 0) return (int)cudaErrorInvalidValue;
  const void* vectors[] = {states, query, w_p};
  for (const void* p : vectors)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(b_p) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_h<float>(states, mask, query, w_p, b_p, out, n_rows, t_len,
                           h, s);
  if (dtype == 1)
    return launch_h<__nv_bfloat16>(states, mask, query, w_p, b_p, out, n_rows,
                                   t_len, h, s);
  return (int)cudaErrorInvalidValue;
}
