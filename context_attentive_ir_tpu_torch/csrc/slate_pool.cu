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
//
// The wide route (above H = 1,024 -- CARS's doc pool at --nhid 576 and up
// -- in both dtypes; at any width when asked, for timing) does not carry
// that design on: it reads all of W_p from L2 for every token, 32.2 ms at
// H = 1,024 against the plain version's 0.436 (R = 1,280, T = 30, bf16).
// It is two launches in a fixed order.  The score kernel
// (slate_score_kernel) runs the projection as the GEMM [R*T, H] @ [H, H]
// in tiles of 128 tokens x 128 columns, so a tile reads its k-slabs of W_p
// once for 128 tokens: bf16 on `mma.sync.m16n8k16` tiles (bf16 in, f32
// accumulate), both operands' k-slabs of 32 streamed through a three-slab
// `cp.async` ring; float32 on exact f32 FMAs, 8 x 8 outputs a thread, the
// slabs staged k-major.  Its epilogue reduces tanh(acc + b_p) * query[doc]
// over the tile's 128 columns into one partial score per token and column
// tile, [H / 128, R*T] f32 in the caller's workspace.  The pool kernel
// (slate_wide_pool_kernel, a block a document) adds a token's column
// tiles' partials in tile order, takes the masked softmax over the
// document's T scores at once (masked tokens score -1e30 and weigh 0; a
// fully masked row pools to exactly 0) and sums p_t x_t in f32 over the
// tokens in order.  No atomics: the same bits every run.  Bound at the
// CARS slate at --nhid 1152 ([16000, 30, 2304], bf16): 2*R*T*H^2 = 5.1e12
// flops, 5.15 ms at 989 TFLOP/s, by operations.

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

// -- the wide route: score tiles, then a pool a document ---------------------

constexpr int kMaxCudaCore = 1024;  // the widest CUDA-core instantiation
constexpr int kScoreRows = 128;     // tokens of a score tile
constexpr int kScoreCols = 128;     // W_p columns of a score tile
constexpr int kScoreK = 32;         // k-rows of a slab
constexpr int kScoreStages = 3;     // slabs in the bf16 ring
// bytes per staged row of the bf16 ring: a token row's kScoreK values, a
// slab row's kScoreCols, each padded by 16 bytes for `ldmatrix`
constexpr int kScoreARow = kScoreK * 2 + 16;
constexpr int kScoreBRow = kScoreCols * 2 + 16;
constexpr int kScoreStage = kScoreRows * kScoreARow + kScoreK * kScoreBRow;
// floats per staged k-row of the float32 kernel
constexpr int kScoreF32Row = kScoreRows + 4;

// Dynamic shared memory of slate_score_kernel: bf16 the ring, then the
// column halves' score exchange (2 x kScoreRows f32); float32 the two
// k-major slabs.
inline size_t score_smem(int dtype) {
  return dtype == 1 ? (size_t)kScoreStages * kScoreStage + 2 * kScoreRows * 4
                    : (size_t)2 * kScoreK * kScoreF32Row * 4;
}

// partial[blockIdx.y][tok] = sum over the tile's 128 columns c of
// tanh((states @ W_p)[tok, c] + b_p[c]) * query[tok / T, c], for the tile's
// 128 tokens (blockIdx.x); rows past n_tok read zeros and write nothing.
// bf16: warp w owns tokens (w % 4) * 32 .. + 31 and columns (w / 4) * 64 ..
// + 63 of the tile (2 x 8 `mma` tiles), fragments by `ldmatrix` from the
// ring's slabs.  float32: thread (ty, tx) owns tokens ty * 8 .. + 7 and
// columns tx * 8 .. + 7, exact f32 FMAs in k order.  A token's columns are
// summed in column order within a thread, by quad (bf16) or half-warp
// (float32) shuffles across threads, then the bf16 column halves in order.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
slate_score_kernel(const T* __restrict__ states, const T* __restrict__ query,
                   const T* __restrict__ w_p, const T* __restrict__ b_p,
                   float* __restrict__ partial, int n_tok, int t_len, int h) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tok0 = blockIdx.x * kScoreRows;
  const int c0 = blockIdx.y * kScoreCols;
  const int n_k = h / kScoreK;
  if constexpr (kBf16) {
    using cair_lstm::tiles::cp_async16;
    using cair_lstm::tiles::cp_async_commit;
    using cair_lstm::tiles::cp_async_wait;
    using cair_lstm::tiles::bf162;
    using cair_lstm::tiles::ldsm_x4;
    using cair_lstm::tiles::ldsm_x4_trans;
    using cair_lstm::tiles::mma_bf16;
    const int g = lane >> 2, tg = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    float* sc_ex = reinterpret_cast<float*>(smem + kScoreStages * kScoreStage);
    // slab kt of both operands into stage s: 512 16-byte pieces each
    auto load = [&](int kt, int st) {
      char* a_s = smem + st * kScoreStage;
      char* b_s = a_s + kScoreRows * kScoreARow;
      const int k0 = kt * kScoreK;
      for (int i = tid; i < kScoreRows * (kScoreK / 8); i += kWarps * 32) {
        const int r = i / (kScoreK / 8), c = i - r * (kScoreK / 8);
        const bool valid = tok0 + r < n_tok;
        cp_async16(a_s + r * kScoreARow + c * 16,
                   valid ? states + (size_t)(tok0 + r) * h + k0 + c * 8
                         : states,
                   valid);
      }
      for (int i = tid; i < kScoreK * (kScoreCols / 8); i += kWarps * 32) {
        const int r = i / (kScoreCols / 8), c = i - r * (kScoreCols / 8);
        cp_async16(b_s + r * kScoreBRow + c * 16,
                   w_p + (size_t)(k0 + r) * h + c0 + c * 8, true);
      }
    };
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.0f;
#pragma unroll
    for (int st = 0; st < kScoreStages - 1; ++st) {
      if (st < n_k) load(st, st);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<kScoreStages - 2>();
      __syncthreads();  // slab kt landed; every warp is done with kt - 1's
      if (kt + kScoreStages - 1 < n_k)
        load(kt + kScoreStages - 1, (kt + kScoreStages - 1) % kScoreStages);
      cp_async_commit();
      const char* a_s = smem + (kt % kScoreStages) * kScoreStage;
      const char* b_s = a_s + kScoreRows * kScoreARow;
      const char* a_src = a_s + (wm * 32 + (lane & 15)) * kScoreARow +
                          (lane >> 4) * 16;
      const char* b_src =
          b_s + (lane & 15) * kScoreBRow + (wn * 64 + (lane >> 4) * 8) * 2;
#pragma unroll
      for (int kk = 0; kk < kScoreK; kk += 16) {
        uint32_t a[2][4], b[4][4];  // b[np]: n-tiles 2np, 2np + 1
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(a[mt], a_src + mt * 16 * kScoreARow + kk * 2);
#pragma unroll
        for (int np = 0; np < 4; ++np)
          ldsm_x4_trans(b[np], b_src + kk * kScoreBRow + np * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
          }
      }
    }
    // epilogue: tanh(. + b_p) . query over the warp's 64 columns
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mt * 16 + g + half * 8;
        float v = 0.0f;
        if (tok0 + r < n_tok) {
          const T* q_d = query + (size_t)((tok0 + r) / t_len) * h;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = c0 + wn * 64 + nt * 8 + 2 * tg;
            const float2 qv =
                __bfloat1622float2(*reinterpret_cast<const bf162*>(q_d + col));
            const float2 bv =
                __bfloat1622float2(*reinterpret_cast<const bf162*>(b_p + col));
            v += tanhf(acc[mt][nt][half * 2] + bv.x) * qv.x +
                 tanhf(acc[mt][nt][half * 2 + 1] + bv.y) * qv.y;
          }
        }
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        if (tg == 0) sc_ex[wn * kScoreRows + r] = v;
      }
    // the two column halves added in order, one partial a token
    __syncthreads();
    if (tid < kScoreRows && tok0 + tid < n_tok)
      partial[(size_t)blockIdx.y * n_tok + tok0 + tid] =
          sc_ex[tid] + sc_ex[kScoreRows + tid];
  } else {
    float* a_s = reinterpret_cast<float*>(smem);     // [kScoreK][kScoreF32Row]
    float* b_s = a_s + kScoreK * kScoreF32Row;       // the same
    const int tx = tid & 15, ty = tid >> 4;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int kt = 0; kt < n_k; ++kt) {
      const int k0 = kt * kScoreK;
      __syncthreads();  // every thread is done with the slabs before
      for (int i = tid; i < kScoreRows * (kScoreK / 4); i += kWarps * 32) {
        const int r = i / (kScoreK / 4), c = (i - r * (kScoreK / 4)) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (tok0 + r < n_tok)
          v = __ldg(reinterpret_cast<const float4*>(
              states + (size_t)(tok0 + r) * h + k0 + c));
        a_s[(c + 0) * kScoreF32Row + r] = v.x;
        a_s[(c + 1) * kScoreF32Row + r] = v.y;
        a_s[(c + 2) * kScoreF32Row + r] = v.z;
        a_s[(c + 3) * kScoreF32Row + r] = v.w;
      }
      for (int i = tid; i < kScoreK * (kScoreCols / 4); i += kWarps * 32) {
        const int r = i / (kScoreCols / 4), c = (i - r * (kScoreCols / 4)) * 4;
        *reinterpret_cast<float4*>(b_s + r * kScoreF32Row + c) =
            __ldg(reinterpret_cast<const float4*>(
                w_p + (size_t)(k0 + r) * h + c0 + c));
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kScoreK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            a_s + k * kScoreF32Row + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(
            a_s + k * kScoreF32Row + ty * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(
            b_s + k * kScoreF32Row + tx * 8);
        const float4 b1 = *reinterpret_cast<const float4*>(
            b_s + k * kScoreF32Row + tx * 8 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      float v = 0.0f;
      if (tok0 + r < n_tok) {
        const T* q_d = query + (size_t)((tok0 + r) / t_len) * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + tx * 8 + j;
          v += tanhf(acc[i][j] + __ldg(b_p + col)) * __ldg(q_d + col);
        }
      }
      // the half-warp's 16 column groups, by a fixed shuffle tree
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
      if (tx == 0 && tok0 + r < n_tok)
        partial[(size_t)blockIdx.y * n_tok + tok0 + r] = v;
    }
  }
}

// a block-wide reduction in a fixed order (kWarps warps): max or sum
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Document blockIdx.x of the wide route: s_t = the column tiles' partials
// of token t added in tile order, the masked softmax over the T scores
// (p_t written over partial[0]'s entry, which only this block reads), and
// pooled = sum_t p_t x_t / max(sum_t p_t, 1e-13) in f32, a column pair a
// thread, tokens in order.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
slate_wide_pool_kernel(const T* __restrict__ states,
                       const bool* __restrict__ mask, float* partial,
                       int n_tiles, T* __restrict__ out, int n_rows,
                       int t_len, int h) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x;
  const size_t n_tok = (size_t)n_rows * t_len;
  float* p_row = partial + (size_t)row * t_len;
  const bool* m_row = mask + (size_t)row * t_len;
  float m_loc = kMaskedScore;
  for (int t = threadIdx.x; t < t_len; t += blockDim.x) {
    float s = p_row[t];
    for (int q = 1; q < n_tiles; ++q) s += p_row[q * n_tok + t];
    const float sc = m_row[t] ? s : kMaskedScore;
    p_row[t] = sc;
    m_loc = fmaxf(m_loc, sc);
  }
  const float m = block_reduce<true>(m_loc, red);
  float s_loc = 0.0f;
  for (int t = threadIdx.x; t < t_len; t += blockDim.x) {
    const float p = m_row[t] ? expf(p_row[t] - m) : 0.0f;
    p_row[t] = p;
    s_loc += p;
  }
  const float den = fmaxf(block_reduce<false>(s_loc, red), 1e-13f);
  // block_reduce's barriers order the p_t writes before these reads
  for (int c = threadIdx.x * 2; c < h; c += blockDim.x * 2) {
    const T* x = states + (size_t)row * t_len * h + c;
    float ax = 0.0f, ay = 0.0f;
    for (int t = 0; t < t_len; ++t) {
      const float pt = p_row[t];
      float xv[2];
      if constexpr (sizeof(T) == 2) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)t * h));
        xv[0] = v.x;
        xv[1] = v.y;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(x + (size_t)t * h);
        xv[0] = v.x;
        xv[1] = v.y;
      }
      ax = fmaf(pt, xv[0], ax);
      ay = fmaf(pt, xv[1], ay);
    }
    store(out + (size_t)row * h + c, ax / den);
    store(out + (size_t)row * h + c + 1, ay / den);
  }
}

// Whether cair_slate_pool takes the wide route: above the CUDA-core
// instantiations, or when asked (`wide`, for timing it beside them).
inline bool wide_route(int h, int wide) { return wide || h > kMaxCudaCore; }

inline size_t wide_workspace(int n_rows, int t_len, int h) {
  return (size_t)(h / kScoreCols) * n_rows * t_len * sizeof(float);
}

template <typename T>
int launch_wide(const void* states, const void* mask, const void* query,
                const void* w_p, const void* b_p, void* out, void* workspace,
                int n_rows, int t_len, int h, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(workspace) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n_tok = (long long)n_rows * t_len;
  const int dtype = sizeof(T) == 2 ? 1 : 0;
  float* partial = static_cast<float*>(workspace);
  if (n_tok > 0) {
    auto* kernel = slate_score_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)score_smem(dtype));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    kernel<<<dim3((unsigned)((n_tok + kScoreRows - 1) / kScoreRows),
                  h / kScoreCols),
             kWarps * 32, score_smem(dtype), stream>>>(
        static_cast<const T*>(states), static_cast<const T*>(query),
        static_cast<const T*>(w_p), static_cast<const T*>(b_p), partial,
        (int)n_tok, t_len, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  slate_wide_pool_kernel<T><<<n_rows, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(states), static_cast<const bool*>(mask), partial,
      h / kScoreCols, static_cast<T*>(out), n_rows, t_len, h);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of workspace cair_slate_pool needs (the wide route's partial
// scores, [H / 128, R*T] f32; 0 on the other routes and at H = 0), or -1
// for a width it refuses.
extern "C" long long cair_slate_pool_workspace(int n_rows, int t_len, int h,
                                               int wide) {
  if (n_rows < 0 || t_len < 0 || h < 0 || h % 128 != 0) return -1;
  return h > 0 && wide_route(h, wide)
             ? (long long)wide_workspace(n_rows, t_len, h)
             : 0;
}

// states [R, T, H], mask bool [R, T], query [R, H], w_p [H, H], b_p [H]
// (contiguous, one dtype: 0 = float32, 1 = bfloat16; states, query and w_p
// 16-byte aligned) -> out [R, H] in that dtype.  H must be a multiple of
// 128 (`pool_supported` in ops/kernels/slate.py states the same set; H = 0
// writes nothing).  Up
// to H = 1,024: bfloat16 at H = 128 or 256 with 1 <= T <= 64 runs
// slate_pool_tc_kernel, everything else slate_pool_kernel; above it (or at
// any H with `wide` set) the wide route, slate_score_kernel then
// slate_wide_pool_kernel, its partial scores in `workspace`
// (cair_slate_pool_workspace bytes, 16-byte aligned; unread elsewhere).
// Returns the cudaError_t (0 = ok).
extern "C" int cair_slate_pool(const void* states, const void* mask,
                               const void* query, const void* w_p,
                               const void* b_p, void* out, void* workspace,
                               int n_rows, int t_len, int h, int dtype,
                               int wide, void* stream) {
  if (n_rows == 0 || h == 0) return 0;
  if (t_len < 0) return (int)cudaErrorInvalidValue;
  const void* vectors[] = {states, query, w_p};
  for (const void* p : vectors)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(b_p) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (h >= 128 && h % 128 == 0 && wide_route(h, wide))
    return dtype == 1
               ? launch_wide<__nv_bfloat16>(states, mask, query, w_p, b_p,
                                            out, workspace, n_rows, t_len, h,
                                            s)
               : launch_wide<float>(states, mask, query, w_p, b_p, out,
                                    workspace, n_rows, t_len, h, s);
  if (dtype == 0)
    return launch_h<float>(states, mask, query, w_p, b_p, out, n_rows, t_len,
                           h, s);
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
