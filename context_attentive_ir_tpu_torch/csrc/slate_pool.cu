// Fused query-aware attention pool for Hopper (sm_90a): kernel 10.  For
// every row r (a candidate document),
//   h_t    = tanh(states[r, t] @ W_p + b_p)
//   s_t    = h_t . query[r]
//   pooled = sum_t masked_softmax(s)_t * states[r, t]
// with the softmax's max, sum and weighted sum in float32: masked tokens
// score -1e30 and weigh 0, pooled = acc / max(s, 1e-13), so a fully masked
// row pools to exactly 0.  The output has the states' dtype.
//
// Replaces the TPU kernel `_pool_kernel` / `_pool_fused_impl` in
// context_attentive_ir_tpu/ops/pallas/slate.py (CARS's query-aware doc
// pooling, `use_pallas_slate`).
//
// What bounds it on the H100: at the CARS slate (R = B*S*N = 16,000 rows,
// T = 30, H = 256, bf16) one call is 2*R*T*H^2 = 6.3e10 flops (0.064 ms at
// the 989 TFLOP/s bf16 tensor-core peak) against 262 MB of states, queries
// and output (0.078 ms at 3.35 TB/s): memory-bound, if the projection runs
// on tensor cores (on CUDA cores alone its flops need >= 0.94 ms); the
// [R, T, H] projection never reaches device memory.
//
// Design, bfloat16 at H = 128 and 256 with 1 <= T <= 64
// (slate_pool_tc_kernel): the projection is the GEMM [R*T, H] @ [H, H]
// (states is contiguous).  A persistent grid of one block of 8 warps per
// SM stages W_p once in shared memory (bf16, rows padded by 16 bytes for
// `ldmatrix`; 132 KB at H = 256) and walks tiles of whole documents: 64
// token rows, each document's T padded to a multiple of 16 (2 documents at
// T = 30, 4 at T <= 16, 1 at T > 32).  A tile's token rows and queries
// arrive by `cp.async.bulk` (one copy per token row, so the staged rows
// keep their padding; the padding rows stay zero) into one of two buffers,
// completing on that buffer's mbarrier, while the block works on the
// other: the states stay bf16, never widened.  Per tile: warp w computes
// the [64 x H/8] block of columns w*H/8.. of states_tile @ W_p as
// `mma.sync.m16n8k16` tiles (bf16 in, f32 accumulate; the `ldmatrix`
// fragments of the next k-step load under this one's `mma`), adds b_p,
// takes tanh and the dot with its document's query in the accumulator
// epilogue;
// quad shuffles and one shared exchange across the 8 warps give each row's
// score; one warp per document then takes the masked softmax over its T
// scores at once, and the pooled sum_t p_t x_t / max(s, 1e-13) is read off
// the staged tile in f32.  The TPU kernel (and slate_pool_kernel below)
// take the softmax online, token by token with a running rescale; taken
// per document at once it differs from theirs only in rounding.  No
// atomics: the same bits every run, whatever the grid.
// What holds it now: one block of 8 warps an SM runs a tile's phases in
// turn -- the product (its shared-memory fragment traffic), the exact
// tanhf of every projected element, three barriers and a softmax on one
// warp per document -- so the copies hide, but the phases do not overlap
// each other (PERF.md).
//
// The first version (slate_pool_kernel) stays for float32 (its bits
// unchanged), for H = 384 .. 1024 (whose bf16 W_p, 288 KB and up, does not
// fit a block's shared memory) and for T outside 1..64 (a document beyond
// one tile): a block of 8 warps owns 64 rows (32 at H = 384 / 512, 16 at
// 640 / 768, 8 at 896 / 1024: 8, 4, 2 or 1 rows per warp) and walks the T
// tokens.  Per token it stages the rows' states
// in shared memory as f32 (row-major), then each warp computes its rows'
// projection with CUDA-core FMAs, each lane owning H/32 contiguous output
// columns, W_p read from shared memory (bf16 at H <= 256) or from L2 (f32,
// or H > 256), with an online softmax over the tokens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lstm_mma.cuh"

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
    // wider pools (CARS's doc pool is 2 * nhid wide): fewer rows a warp, so
    // a thread's accumulators and pooled sums (2 * kCols * kRowsPerWarp
    // floats) stay inside the 255 registers of the 256-thread block
    case 640:
      return launch<T, 20, 2, false>(states, mask, query, w_p, b_p, out,
                                     n_rows, t_len, stream);
    case 768:
      return launch<T, 24, 2, false>(states, mask, query, w_p, b_p, out,
                                     n_rows, t_len, stream);
    case 896:
      return launch<T, 28, 1, false>(states, mask, query, w_p, b_p, out,
                                     n_rows, t_len, stream);
    case 1024:
      return launch<T, 32, 1, false>(states, mask, query, w_p, b_p, out,
                                     n_rows, t_len, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// -- the bf16 tensor-core kernel -------------------------------------------

constexpr int kTileRows = 64;                 // token rows of a tile
constexpr int kMaxDocs = kTileRows / 16;      // documents of a tile (T <= 16)

__host__ __device__ constexpr int tc_row_bytes(int h) { return 2 * h + 16; }

// Dynamic shared memory of slate_pool_tc_kernel at width h: the two
// buffers' mbarriers (64 bytes), W_p and two token buffers of padded rows,
// two buffers' queries, the score exchange (8 warps x 64 rows, f32), the
// softmax weights (64 f32) and denominators (4 f32).  `pool_smem_bytes` in
// ops/kernels/slate.py states the same sum.
inline size_t tc_smem(int h) {
  return 64 + (size_t)h * tc_row_bytes(h) +
         2 * (size_t)kTileRows * tc_row_bytes(h) + 2 * (size_t)kMaxDocs * h * 2 +
         (size_t)kWarps * kTileRows * 4 + kTileRows * 4 + kMaxDocs * 4;
}

// order this thread's generic-proxy accesses of shared memory before the
// bulk copies (async proxy) that follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32, 1)
slate_pool_tc_kernel(const __nv_bfloat16* __restrict__ states,
                     const bool* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ query,
                     const __nv_bfloat16* __restrict__ w_p,
                     const __nv_bfloat16* __restrict__ b_p,
                     __nv_bfloat16* __restrict__ out, int n_rows, int t_len,
                     int t_pad, int docs, int n_tiles) {
  // the tiles' primitives (lstm_mma.cuh); kWarps and kFull are this file's
  using cair_lstm::tiles::bf16;
  using cair_lstm::tiles::bf162;
  using cair_lstm::tiles::bulk_copy;
  using cair_lstm::tiles::ldsm_x4;
  using cair_lstm::tiles::ldsm_x4_trans;
  using cair_lstm::tiles::mbar_expect_tx;
  using cair_lstm::tiles::mbar_init;
  using cair_lstm::tiles::mbar_wait;
  using cair_lstm::tiles::mma_bf16;
  constexpr int RB = tc_row_bytes(H);
  constexpr int NT = H / 64;  // n8 tiles of a warp's H / 8 columns
  extern __shared__ __align__(16) char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  char* w_s = smem + 64;
  char* buf0 = w_s + H * RB;  // buffer b at buf0 + b * kTileRows * RB
  bf16* q_s = reinterpret_cast<bf16*>(buf0 + 2 * kTileRows * RB);
  float* sc_part = reinterpret_cast<float*>(q_s + 2 * kMaxDocs * H);
  float* p_s = sc_part + kWarps * kTileRows;
  float* den_s = p_s + kTileRows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int col0 = warp * (H / 8);
  const int n_mt = docs * t_pad / 16;  // m16 tiles a tile fills
  const int mt_per_doc = t_pad / 16;

  // W_p into its padded rows; both buffers zeroed, so the rows T..Tp-1 of
  // every document stay 0 (the copies never write them)
  for (int i = tid; i < H * (H / 8); i += blockDim.x) {
    const int r = i / (H / 8), c = i - r * (H / 8);
    *reinterpret_cast<uint4*>(w_s + r * RB + c * 16) =
        __ldg(reinterpret_cast<const uint4*>(w_p) + i);
  }
  for (int i = tid; i < 2 * kTileRows * RB / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(buf0)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  float bias[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = col0 + nt * 8 + 2 * tg;
    bias[nt][0] = __bfloat162float(b_p[col]);
    bias[nt][1] = __bfloat162float(b_p[col + 1]);
  }

  // tile `tile` into buffer b (warp 0): one bulk copy per token row, one
  // for the documents' queries, all completing on the buffer's mbarrier
  auto issue = [&](int tile, int b) {
    const int doc0 = tile * docs;
    const int nd = min(docs, n_rows - doc0);
    if (lane == 0)
      mbar_expect_tx(&bar[b], (uint32_t)nd * (t_len + 1) * H * 2);
    __syncwarp();
    fence_proxy_async();
    char* dst = buf0 + b * kTileRows * RB;
    for (int i = lane; i < nd * t_len; i += 32) {
      const int d = i / t_len, t = i - d * t_len;
      bulk_copy(dst + (d * t_pad + t) * RB,
                states + ((size_t)(doc0 + d) * t_len + t) * H, H * 2, &bar[b]);
    }
    if (lane == 0)
      bulk_copy(q_s + b * kMaxDocs * H, query + (size_t)doc0 * H, nd * H * 2,
                &bar[b]);
  };

  if (warp == 0 && (int)blockIdx.x < n_tiles) issue(blockIdx.x, 0);
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int b = i & 1;
    // the other buffer was last read in the previous tile, which every
    // warp has finished (the barrier that ends it)
    if (warp == 0 && tile + (int)gridDim.x < n_tiles)
      issue(tile + gridDim.x, b ^ 1);
    mbar_wait(&bar[b], (uint32_t)(i >> 1) & 1u);
    const char* x_s = buf0 + b * kTileRows * RB;
    const bf16* q_t = q_s + b * kMaxDocs * H;
    const int doc0 = tile * docs;
    const int nd = min(docs, n_rows - doc0);

    // states_tile @ W_p, the warp's columns col0 .. col0 + H/8 - 1
    float acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.0f;
    // fragments of k-step ki + 1 load while step ki's `mma` run
    uint32_t a[2][4][4], w[2][NT / 2][4];  // w: n-tiles 2np, 2np + 1
    const char* a_src = x_s + (lane & 15) * RB + (lane >> 4) * 16;
    const char* w_src = w_s + (lane & 15) * RB + (col0 + (lane >> 4) * 8) * 2;
    auto fragments = [&](int kk, uint32_t(&af)[4][4],
                         uint32_t(&wf)[NT / 2][4]) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        if (mt < n_mt) ldsm_x4(af[mt], a_src + mt * 16 * RB + kk * 2);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4_trans(wf[np], w_src + kk * RB + np * 32);
    };
    fragments(0, a[0], w[0]);
#pragma unroll
    for (int ki = 0; ki < H / 16; ++ki) {
      const int cur = ki & 1;
      if (ki + 1 < H / 16) fragments((ki + 1) * 16, a[cur ^ 1], w[cur ^ 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (mt < n_mt) {
            mma_bf16(acc[mt][2 * np], a[cur][mt], w[cur][np][0],
                     w[cur][np][1]);
            mma_bf16(acc[mt][2 * np + 1], a[cur][mt], w[cur][np][2],
                     w[cur][np][3]);
          }
    }

    // epilogue: tanh(. + b_p) . query, summed over the warp's columns
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      if (mt < n_mt) {
        const bf16* q_d = q_t + (mt / mt_per_doc) * H;
        float part[2] = {0.0f, 0.0f};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = col0 + nt * 8 + 2 * tg;
          const float2 qv =
              __bfloat1622float2(*reinterpret_cast<const bf162*>(q_d + col));
#pragma unroll
          for (int half = 0; half < 2; ++half)
            part[half] += tanhf(acc[mt][nt][half * 2] + bias[nt][0]) * qv.x +
                          tanhf(acc[mt][nt][half * 2 + 1] + bias[nt][1]) * qv.y;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = part[half];
          v += __shfl_xor_sync(kFull, v, 1);
          v += __shfl_xor_sync(kFull, v, 2);
          if (tg == 0) sc_part[warp * kTileRows + mt * 16 + g + half * 8] = v;
        }
      }
    __syncthreads();

    // masked softmax of each document's T scores (warp d: document d)
    if (warp < nd) {
      const bool* m_row = mask + (size_t)(doc0 + warp) * t_len;
      float sc[2], p[2];
      bool valid[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = lane + 32 * j;
        valid[j] = t < t_len && m_row[t];
        float s = 0.0f;
        if (valid[j]) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            s += sc_part[w * kTileRows + warp * t_pad + t];
        }
        sc[j] = valid[j] ? s : kMaskedScore;
      }
      float m = fmaxf(sc[0], sc[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j] = valid[j] ? expf(sc[j] - m) : 0.0f;
        const int t = lane + 32 * j;
        if (t < t_pad) p_s[warp * t_pad + t] = p[j];
      }
      const float den = warp_sum(p[0] + p[1]);
      if (lane == 0) den_s[warp] = den;
    }
    __syncthreads();

    // pooled = sum_t p_t x_t / max(s, 1e-13), a column pair a thread
    for (int idx = tid; idx < nd * (H / 2); idx += blockDim.x) {
      const int d = idx / (H / 2), col = (idx - d * (H / 2)) * 2;
      const char* x_d = x_s + d * t_pad * RB + col * 2;
      const float* p_d = p_s + d * t_pad;
      float ax = 0.0f, ay = 0.0f;
      for (int t = 0; t < t_len; ++t) {
        const float pt = p_d[t];
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const bf162*>(x_d + t * RB));
        ax = fmaf(pt, xv.x, ax);
        ay = fmaf(pt, xv.y, ay);
      }
      const float den = fmaxf(den_s[d], 1e-13f);
      *reinterpret_cast<bf162*>(out + (size_t)(doc0 + d) * H + col) =
          __floats2bfloat162_rn(ax / den, ay / den);
    }
    __syncthreads();  // the buffer, the scores and the weights are free
  }
}

template <int H>
int launch_tc(const void* states, const void* mask, const void* query,
              const void* w_p, const void* b_p, void* out, int n_rows,
              int t_len, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int t_pad = (t_len + 15) / 16 * 16;
  const int docs = kTileRows / t_pad;
  const int n_tiles = (n_rows + docs - 1) / docs;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = tc_smem(H);
  err = cudaFuncSetAttribute(slate_pool_tc_kernel<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  slate_pool_tc_kernel<H><<<n_tiles < sms ? n_tiles : sms, kWarps * 32, smem,
                            stream>>>(
      static_cast<const bf16*>(states), static_cast<const bool*>(mask),
      static_cast<const bf16*>(query), static_cast<const bf16*>(w_p),
      static_cast<const bf16*>(b_p), static_cast<bf16*>(out), n_rows, t_len,
      t_pad, docs, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// states [R, T, H], mask bool [R, T], query [R, H], w_p [H, H], b_p [H]
// (contiguous, one dtype: 0 = float32, 1 = bfloat16; states, query and w_p
// 16-byte aligned) -> out [R, H] in that dtype.  H must be a multiple of
// 128 from 128 to 1024 (`pool_supported` in ops/kernels/slate.py states the
// same set).  bfloat16 at H = 128 or 256 with 1 <= T <= 64 runs
// slate_pool_tc_kernel, everything else slate_pool_kernel.  Returns the
// cudaError_t (0 = ok).
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // bf16 on tensor cores where W_p and a tile of whole documents fit
  if (t_len >= 1 && t_len <= kTileRows) {
    if (h == 128)
      return launch_tc<128>(states, mask, query, w_p, b_p, out, n_rows, t_len,
                            s);
    if (h == 256)
      return launch_tc<256>(states, mask, query, w_p, b_p, out, n_rows, t_len,
                            s);
  }
  return launch_h<__nv_bfloat16>(states, mask, query, w_p, b_p, out, n_rows,
                                 t_len, h, s);
}
