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
// What bounds it on the H100: the projection is the GEMM [R*T, H] @ [H, H]
// (states is contiguous), 2*R*T*H^2 flops, against the states, queries
// and output read or written once.  At the CARS slate (R = B*S*N = 16,000
// rows, T = 30, H = 256) that is 6.3e10 flops against 262 MB in bf16
// (0.064 ms at the 989 TFLOP/s bf16 peak, 0.078 ms of bytes: memory-bound)
// and 525 MB in float32 (0.384 ms at split TF32's 165 TFLOP/s, 0.157 ms of
// bytes: operations); from H = 384 on, operations in both dtypes.  The
// [R, T, H] projection never reaches device memory.
//
// Every route runs the projection on tensor cores and takes each
// document's masked softmax over its T scores at once (the TPU kernel's
// online softmax differs from it only in rounding); no atomics, so the
// same bits every run, whatever the grid.  cair_slate_route says which
// route a shape takes (`pool_route` in ops/kernels/slate.py is the same
// rule):
//
// The resident kernel (slate_pool_tc_kernel), bfloat16 at H = 128 and 256
// with 1 <= T <= 64: a persistent grid of one block of 8 warps per SM
// stages W_p once in shared memory (bf16, rows padded by 16 bytes for
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
// epilogue; quad shuffles and one shared exchange across the 8 warps give
// each row's score; one warp per document then takes the masked softmax
// over its T scores, and the pooled sum_t p_t x_t / max(s, 1e-13) is read
// off the staged tile in f32.  What holds it: one block of 8 warps an SM
// runs a tile's phases in turn -- the product, the exact tanhf of every
// projected element, three barriers and a softmax on one warp per
// document -- so the copies hide, but the phases do not overlap.
//
// The wide route, every other shape: float32 at every width, bfloat16
// from H = 384 (whose W_p, 288 KB and up, does not fit a block's shared
// memory) and at 128 / 256 where a document does not fit a tile (T = 0,
// T > 64), and any shape when asked (`wide`, for timing).  It is two
// launches in a fixed order.  The score kernel
// (slate_score_kernel) runs the projection in tiles of 128 tokens x 128
// columns, so a tile reads its k-slabs of W_p once for 128 tokens, both
// operands' k-slabs of 32 streamed through a three-slab `cp.async` ring:
// bf16 on `mma.sync.m16n8k16` tiles (bf16 in, f32 accumulate), float32 on
// the same tiles in split TF32 (a fresh accumulator a slab).  Its epilogue
// reduces tanh(acc + b_p) * query[doc] over the tile's 128 columns into one
// partial score per token and column tile, [H / 128, R*T] f32 in the
// caller's workspace.  The pool kernel (slate_wide_pool_kernel, a block a
// document) adds a token's column tiles' partials in tile order, takes the
// masked softmax over the document's T scores at once and sums p_t x_t in
// f32 over the tokens in order.  Bound at the CARS slate at --nhid 1152
// ([16000, 30, 2304], bf16): 2*R*T*H^2 = 5.1e12 flops, 5.15 ms at 989
// TFLOP/s, by operations.

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// -- the resident kernel: bf16 W_p in shared memory ------------------------

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

// The resident kernel's walk of whole-document tiles.  doc_tile:
// documents doc0 .. doc0 + nd - 1 into a tile buffer `dst` (token rows rb
// bytes apart, document d's rows from d * t_pad) and their queries into
// `q_dst`, one bulk copy per token row and one for the queries, all
// completing on `bar` (one warp, lane 0 arming it).
template <typename T>
__device__ __forceinline__ void doc_tile(char* dst, T* q_dst,
                                         const T* states, const T* query,
                                         int doc0, int nd, int t_len,
                                         int t_pad, int h, int rb,
                                         uint64_t* bar, int lane) {
  constexpr int E = (int)sizeof(T);
  if (lane == 0)
    cair_lstm::tiles::mbar_expect_tx(bar, (uint32_t)nd * (t_len + 1) * h * E);
  __syncwarp();
  fence_proxy_async();
  for (int i = lane; i < nd * t_len; i += 32) {
    const int d = i / t_len, t = i - d * t_len;
    cair_lstm::tiles::bulk_copy(dst + (d * t_pad + t) * rb,
                                states + ((size_t)(doc0 + d) * t_len + t) * h,
                                h * E, bar);
  }
  if (lane == 0)
    cair_lstm::tiles::bulk_copy(q_dst, query + (size_t)doc0 * h, nd * h * E,
                                bar);
}

// The masked softmax of one document's T <= 64 scores on one warp
// (score(t) read only for valid tokens): masked tokens score -1e30 and
// weigh 0; the weights of tokens 0 .. t_pad - 1 to p_d, their sum to *den.
template <typename Score>
__device__ __forceinline__ void doc_softmax(const bool* m_row, int t_len,
                                            int t_pad, int lane, float* p_d,
                                            float* den, Score score) {
  float sc[2], p[2];
  bool valid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = lane + 32 * j;
    valid[j] = t < t_len && m_row[t];
    sc[j] = valid[j] ? score(t) : kMaskedScore;
  }
  float m = fmaxf(sc[0], sc[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    p[j] = valid[j] ? expf(sc[j] - m) : 0.0f;
    const int t = lane + 32 * j;
    if (t < t_pad) p_d[t] = p[j];
  }
  const float s = warp_sum(p[0] + p[1]);
  if (lane == 0) *den = s;
}

// pooled = sum_t p_t x_t / max(s, 1e-13) of the tile's nd documents, in
// f32 off the staged rows, a column pair a thread (n_threads of them)
template <typename T>
__device__ __forceinline__ void doc_pool(const char* x_s, int rb,
                                         const float* p_s,
                                         const float* den_s, int nd,
                                         int t_len, int t_pad, int h, T* out,
                                         int tid, int n_threads) {
  using cair_lstm::Elt;
  for (int idx = tid; idx < nd * (h / 2); idx += n_threads) {
    const int d = idx / (h / 2), col = (idx - d * (h / 2)) * 2;
    const char* x_d = x_s + (size_t)d * t_pad * rb + col * (int)sizeof(T);
    const float* p_d = p_s + d * t_pad;
    float ax = 0.0f, ay = 0.0f;
    for (int t = 0; t < t_len; ++t) {
      const float pt = p_d[t];
      const float2 xv = Elt<T>::load2(x_d + (size_t)t * rb);
      ax = fmaf(pt, xv.x, ax);
      ay = fmaf(pt, xv.y, ay);
    }
    const float den = fmaxf(den_s[d], 1e-13f);
    Elt<T>::store2(out + (size_t)d * h + col, ax / den, ay / den);
  }
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
  using cair_lstm::tiles::ldsm_x4;
  using cair_lstm::tiles::ldsm_x4_trans;
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
    doc_tile(buf0 + b * kTileRows * RB, q_s + b * kMaxDocs * H, states, query,
             doc0, min(docs, n_rows - doc0), t_len, t_pad, H, RB, &bar[b],
             lane);
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

    // masked softmax of each document's T scores (warp d: document d), a
    // token's score the 8 warps' partials in order
    if (warp < nd)
      doc_softmax(mask + (size_t)(doc0 + warp) * t_len, t_len, t_pad, lane,
                  p_s + warp * t_pad, &den_s[warp], [&](int t) {
                    float s = 0.0f;
#pragma unroll
                    for (int w = 0; w < kWarps; ++w)
                      s += sc_part[w * kTileRows + warp * t_pad + t];
                    return s;
                  });
    __syncthreads();
    doc_pool(x_s, RB, p_s, den_s, nd, t_len, t_pad, H, out + (size_t)doc0 * H,
             tid, blockDim.x);
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

constexpr int kScoreRows = 128;     // tokens of a score tile
constexpr int kScoreCols = 128;     // W_p columns of a score tile
constexpr int kScoreK = 32;         // k-rows of a slab
constexpr int kScoreStages = 3;     // slabs in the ring
// bytes per staged row of the bf16 ring: a token row's kScoreK values, a
// slab row's kScoreCols, each padded by 16 bytes for `ldmatrix`
constexpr int kScoreARow = kScoreK * 2 + 16;
constexpr int kScoreBRow = kScoreCols * 2 + 16;
constexpr int kScoreStage = kScoreRows * kScoreARow + kScoreK * kScoreBRow;
// the float32 ring: token rows of kScoreK floats padded by 16 bytes
// (`ldmatrix`), k-major slab rows of 136 floats (8 words modulo 32: a
// warp's scalar B loads hit 32 banks)
constexpr int kScoreF32ARow = kScoreK * 4 + 16;
constexpr int kScoreF32BRow = kScoreCols * 4 + 32;
constexpr int kScoreF32Stage =
    kScoreRows * kScoreF32ARow + kScoreK * kScoreF32BRow;

// Dynamic shared memory of slate_score_kernel: the ring, then the column
// halves' score exchange (2 x kScoreRows f32).
inline size_t score_smem(int dtype) {
  return (size_t)kScoreStages * (dtype == 1 ? kScoreStage : kScoreF32Stage) +
         2 * kScoreRows * 4;
}

// partial[blockIdx.y][tok] = sum over the tile's 128 columns c of
// tanh((states @ W_p)[tok, c] + b_p[c]) * query[tok / T, c], for the tile's
// 128 tokens (blockIdx.x); rows past n_tok read zeros and write nothing.
// Warp w owns tokens (w % 4) * 32 .. + 31 and columns (w / 4) * 64 .. + 63
// of the tile (2 x 8 `mma` tiles), fragments from the ring's slabs: bf16
// by `ldmatrix` (A) and `ldmatrix.trans` (B) into `mma.sync.m16n8k16`;
// float32 in split TF32, A by `ldmatrix` of f32 rows, B by two scalar
// loads a lane, each slab's products in a fresh accumulator added to the
// tile's in f32.  A token's columns are summed in column order within a
// thread, by quad shuffles across threads, then the column halves in
// order.
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
    namespace t32 = cair_lstm::tf32;
    using cair_lstm::tiles::cp_async16;
    using cair_lstm::tiles::cp_async_commit;
    using cair_lstm::tiles::cp_async_wait;
    using cair_lstm::tiles::ldsm_x4;
    const int g = lane >> 2, tg = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    float* sc_ex =
        reinterpret_cast<float*>(smem + kScoreStages * kScoreF32Stage);
    // slab kt of both operands into stage s: 1,024 16-byte pieces each
    auto load = [&](int kt, int st) {
      char* a_s = smem + st * kScoreF32Stage;
      char* b_s = a_s + kScoreRows * kScoreF32ARow;
      const int k0 = kt * kScoreK;
      for (int i = tid; i < kScoreRows * (kScoreK / 4); i += kWarps * 32) {
        const int r = i / (kScoreK / 4), c = i - r * (kScoreK / 4);
        const bool valid = tok0 + r < n_tok;
        cp_async16(a_s + r * kScoreF32ARow + c * 16,
                   valid ? states + (size_t)(tok0 + r) * h + k0 + c * 4
                         : states,
                   valid);
      }
      for (int i = tid; i < kScoreK * (kScoreCols / 4); i += kWarps * 32) {
        const int r = i / (kScoreCols / 4), c = i - r * (kScoreCols / 4);
        cp_async16(b_s + r * kScoreF32BRow + c * 16,
                   w_p + (size_t)(k0 + r) * h + c0 + c * 4, true);
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
      const char* a_s = smem + (kt % kScoreStages) * kScoreF32Stage;
      const char* b_s = a_s + kScoreRows * kScoreF32ARow;
      // A: rows from lanes 0-15, k + 4 from lanes 16-31; B: k rows tg (b0)
      // and tg + 4 (b1), column g of each n-tile
      const char* a_base =
          a_s + (wm * 32 + (lane & 15)) * kScoreF32ARow + (lane >> 4) * 16;
      const char* b_base = b_s + tg * kScoreF32BRow + (wn * 64 + g) * 4;
      float part[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) part[mt][nt][v] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kScoreK; kk += 8) {
        t32::AFrag a[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t raw[4];
          ldsm_x4(raw, a_base + mt * 16 * kScoreF32ARow + kk * 4);
          t32::split_a(a[mt], raw);
        }
        const float* b_lo =
            reinterpret_cast<const float*>(b_base + kk * kScoreF32BRow);
        const float* b_hi =
            reinterpret_cast<const float*>(b_base + (kk + 4) * kScoreF32BRow);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const t32::BFrag b = t32::split_b(b_lo[nt * 8], b_hi[nt * 8]);
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              t32::mma_term(part[mt][nt], a[mt], b, term);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nt][v] += part[mt][nt][v];
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
            const float2 qv = *reinterpret_cast<const float2*>(q_d + col);
            const float2 bv = *reinterpret_cast<const float2*>(b_p + col);
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
    if (partial == nullptr) return (int)cudaErrorInvalidValue;
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

// -- the route rule -----------------------------------------------------------

enum Route { kRefused = -1, kResident = 0, kWide = 1 };

// The route of a pool of width h over documents of t_len tokens in dtype
// (0 = float32, 1 = bfloat16): the resident kernel for bf16 at H = 128 /
// 256 with 1 <= T <= 64 and `wide` unset; the wide route for every other
// shape.  Refused: H not a positive multiple of 128, T < 0, another dtype.
inline int route_of(int t_len, int h, int dtype, int wide) {
  if (t_len < 0 || h <= 0 || h % 128 != 0 || (dtype != 0 && dtype != 1))
    return kRefused;
  return !wide && dtype == 1 && (h == 128 || h == 256) && t_len >= 1 &&
                 t_len <= kTileRows
             ? kResident
             : kWide;
}

}  // namespace

// The route cair_slate_pool takes for this shape: 0 the resident kernel, 1
// the wide route; -1 for a shape it refuses.
extern "C" int cair_slate_route(int n_rows, int t_len, int h, int dtype,
                                int wide) {
  return n_rows < 0 ? kRefused : route_of(t_len, h, dtype, wide);
}

// Bytes of workspace cair_slate_pool needs (the wide route's partial
// scores, [H / 128, R*T] f32; 0 on the other routes and at H = 0), or -1
// for a shape it refuses.
extern "C" long long cair_slate_pool_workspace(int n_rows, int t_len, int h,
                                               int dtype, int wide) {
  if (n_rows < 0 || t_len < 0 || (dtype != 0 && dtype != 1)) return -1;
  if (h == 0) return 0;
  const int route = route_of(t_len, h, dtype, wide);
  if (route == kRefused) return -1;
  return route == kWide ? (long long)wide_workspace(n_rows, t_len, h) : 0;
}

// states [R, T, H], mask bool [R, T], query [R, H], w_p [H, H], b_p [H]
// (contiguous, one dtype: 0 = float32, 1 = bfloat16; states, query and w_p
// 16-byte aligned) -> out [R, H] in that dtype.  H must be a multiple of
// 128 (`pool_supported` in ops/kernels/slate.py states the same set; H = 0
// writes nothing).  The route is cair_slate_route's: slate_pool_tc_kernel,
// or slate_score_kernel then slate_wide_pool_kernel with their partial
// scores in `workspace`
// (cair_slate_pool_workspace bytes, 16-byte aligned; unread elsewhere).
// Returns the cudaError_t (0 = ok).
extern "C" int cair_slate_pool(const void* states, const void* mask,
                               const void* query, const void* w_p,
                               const void* b_p, void* out, void* workspace,
                               int n_rows, int t_len, int h, int dtype,
                               int wide, void* stream) {
  if (n_rows == 0 || h == 0) return 0;
  const int route = route_of(t_len, h, dtype, wide);
  if (n_rows < 0 || route == kRefused) return (int)cudaErrorInvalidValue;
  const void* vectors[] = {states, query, w_p};
  for (const void* p : vectors)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(b_p) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (route) {
    case kResident:
      return h == 128 ? launch_tc<128>(states, mask, query, w_p, b_p, out,
                                       n_rows, t_len, s)
                      : launch_tc<256>(states, mask, query, w_p, b_p, out,
                                       n_rows, t_len, s);
    default:
      return dtype == 1
                 ? launch_wide<bf16>(states, mask, query, w_p, b_p, out,
                                     workspace, n_rows, t_len, h, s)
                 : launch_wide<float>(states, mask, query, w_p, b_p, out,
                                      workspace, n_rows, t_len, h, s);
  }
}
