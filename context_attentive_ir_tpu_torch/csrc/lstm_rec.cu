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
// 989 TFLOP/s bf16 tensor-core peak): bound by bytes, through T steps that
// depend on each other.
//
// Design, bfloat16 at H = 128 (lstm_rec_mma_kernel, on lstm_mma.cuh's
// tiles): a block of 16 warps owns 64 rows for all T steps, as two row
// groups of 8 warps and 32 rows; warp w of a group takes unit groups 2w and
// 2w + 1 (8 units each) of its group's rows, all four gates of them.  W_hh,
// staged by the wrapper as one padded [H, 4H + 8] matrix, is copied into
// shared memory once a block by one bulk copy (`cp.async.bulk` on an
// mbarrier) and stays there: no step copies a weight.  Per step a group's
// x_proj rows -- each one contiguous kilobyte in device memory, one bulk
// copy a row on the group's mbarrier, issued by four lanes of each of its
// warps -- initialise the accumulators (the role of kernel 1's bias),
// `slab_gates` adds bf16(h) @ W_hh as `mma.sync.m16n8k16` tiles from the
// staged h tile and the resident W_hh (one "slab" of H k-rows), and the cell
// update runs on the thread's own (row, unit) cells: c stays in registers
// and only bf16(h) goes back to the h tile.  The x_proj tile is
// single-buffered: a group issues its next step's rows as soon as all its
// warps have read the current ones (the step's first group barrier), so
// they land under the product and the cell update.  Two barriers a step,
// each a group's own (`bar.sync` 1 + group): that one, which also orders
// the last step's h-tile writes before this product, and one before the h
// tile is overwritten.  The groups drift apart, so one group's product,
// copies and barrier waits run under the other's cell update: the exact
// expf / tanhf of 8,192 cells a block-step, which is where the kernel's
// time goes (it runs above its byte bound).
// Rows past B are zero-filled once and never copied (a group's mbarrier
// expects the bytes of its own rows only; a tail block's empty group
// returns).  250 blocks of 64 rows at the doc-encoder shape, one block an
// SM: two waves on 132 SMs.  H is a compile-time constant, so the product's
// loops and the tiles' addresses unroll.
//
// Shared memory (kRecSmem, `rec_smem_bytes` in ops/kernels/lstm.py): 64
// bytes of mbarriers + W_hh H * (8H + 16) + the x_proj tile 64 * (8H + 16)
// + the h tile 64 * (2H + 16) = 64 + 133,120 + 66,560 + 17,408 = 217,152 of
// the 232,448 a block may use.  No wider H fits: W_hh alone is 528,384
// bytes at H = 256.
//
// float32, and bf16 at H = 256 .. 512 (lstm_rec_kernel): kernel 1's first
// CUDA-core layout without the x staging.  A block owns kRows = 32 rows;
// thread (rg, j) owns hidden unit j of rows rg*16 .. rg*16+15 with h and c
// in registers, its accumulators start from its own x_proj values and add
// h @ W_hh with exact f32 FMAs, W_hh read through L2; launched under the
// smallest launch bound that holds its 2H threads (row_tile_bound).
//
// As in the TPU kernel, h is rounded to W_hh's dtype before the product
// (`h.astype(whh_ref.dtype)`); gates and state are f32, the nonlinearities
// the exact expf / tanhf.
//
// This launcher holds H up to 512 (kMaxRec: 2H <= 1,024 threads a block).
// Above it, in both dtypes, kernel 6 takes the step route (`lstm_route` in
// lstm_mma.cuh; cair_lstm_step with rec = 1 in lstm_step.cu): kernel 1's
// step kernel with E = 0, its accumulators started from x_proj, a launch a
// time step, any multiple of 128 the JAX kernel takes.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"

namespace {

using namespace cair_lstm;

template <typename T, int kBound>
__global__ void __launch_bounds__(kBound)
lstm_rec_kernel(const T* __restrict__ x_proj, const uint8_t* __restrict__ mask,
                const T* __restrict__ w_hh, T* __restrict__ out, int n_rows,
                int n_steps, int h_dim, int reverse) {
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

// The tensor-core route's geometry: H = 128, 64 rows and 16 warps a block,
// in two row groups of 8 warps that run the steps on barriers of their own.
constexpr int kRecHidden = 128;
constexpr int kRecRows = 64;
constexpr int kRecWarps = 16;
constexpr int kRecGroups = 2;
constexpr int kRecThreads = 32 * kRecWarps;
// Dynamic shared memory (see the header note; `rec_smem_bytes` in
// ops/kernels/lstm.py states the same sum): mbarriers, W_hh, the x_proj
// tile (both rows of 8H + 16 bytes), the h tile (rows of 2H + 16).
constexpr size_t kRecSmem =
    tiles::kRingHeader + (size_t)(kRecHidden + kRecRows) * (8 * kRecHidden + 16) +
    (size_t)kRecRows * (2 * kRecHidden + 16);
static_assert(kRecSmem <= tiles::kSmemLimit, "the tiles fit a block");

// Row group grp's barrier: named barrier 1 + grp over the group's threads
// (barrier 0 is the block's __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1),
               "r"(kRecThreads / kRecGroups)
               : "memory");
}

// The bf16 tensor-core kernel (see the header note).  Shared memory:
// mbarriers (W_hh, then one x tile barrier a group) | W_hh | x_proj tile |
// h tile; a group uses its own rows of the two tiles.
__global__ void __launch_bounds__(kRecThreads, 1)
lstm_rec_mma_kernel(const __nv_bfloat16* __restrict__ x_proj,
                    const uint8_t* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ w_staged,
                    __nv_bfloat16* __restrict__ out, int n_rows, int n_steps,
                    int reverse) {
  using namespace tiles;
  constexpr int H = kRecHidden;
  constexpr int GW = kRecWarps / kRecGroups;  // warps of a group: 8
  constexpr int GM = kRecRows / kRecGroups;   // rows of a group: 32
  constexpr int G = H / (8 * GW);             // unit groups of a warp: 2
  constexpr int MT = GM / 16;                 // 16-row tiles of a warp: 2
  constexpr int kLanes = GM / GW;             // rows each warp copies
  constexpr uint32_t kRowBytes = 8 * H;     // one row's x_proj at one step
  extern __shared__ __align__(16) char smem[];
  const int ws = w_stride(H, kLstmGates);   // W_hh and x tile rows
  const int hs = h_stride(H);
  uint64_t* w_bar = reinterpret_cast<uint64_t*>(smem);
  char* w_s = smem + kRingHeader;
  char* x_tile = w_s + H * ws;
  char* h_tile = x_tile + kRecRows * ws;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int grp = warp / GW, gw = warp % GW;
  const int ug0 = gw * G;
  uint64_t* x_bar = w_bar + 1 + grp;
  char* gx = x_tile + grp * GM * ws;        // the group's rows
  char* gh = h_tile + grp * GM * hs;
  const int row0 = blockIdx.x * kRecRows + grp * GM;
  const int valid = min(GM, n_rows - row0);  // the group's rows in range
  const int block_valid = min(kRecRows, n_rows - (int)blockIdx.x * kRecRows);

  if (threadIdx.x == 0) {
    mbar_init(w_bar, 1);
    for (int q = 0; q < kRecGroups; ++q) mbar_init(w_bar + 1 + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kRecRows * hs / 16; i += kRecThreads)
    reinterpret_cast<uint4*>(h_tile)[i] = make_uint4(0, 0, 0, 0);
  // the tail block's rows past n_rows: zero, and never copied into
  for (int i = threadIdx.x; i < (kRecRows - block_valid) * ws / 16;
       i += kRecThreads)
    reinterpret_cast<uint4*>(x_tile + block_valid * ws)[i] =
        make_uint4(0, 0, 0, 0);
  __syncthreads();  // the barriers are initialised

  // the group's leader announces the bytes of a step's rows before any of
  // its warps copies them; warp gw copies rows gw + GW * lane, lane <
  // kLanes, one bulk copy a row
  const bool leader = gw == 0 && lane == 0;
  auto copy_rows = [&](int t) {
    const int r = gw + GW * lane;
    if (lane < kLanes && r < valid)
      bulk_copy(gx + r * ws,
                x_proj + ((size_t)(row0 + r) * n_steps + t) * 4 * H,
                kRowBytes, x_bar);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(w_bar, H * ws);
    bulk_copy(w_s, w_staged, H * ws, w_bar);
  }
  if (valid <= 0) return;  // a tail block's empty group
  if (leader) mbar_expect_tx(x_bar, valid * kRowBytes);
  group_sync(grp);
  copy_rows(reverse ? n_steps - 1 : 0);

  float c[MT][G][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[mt][gi][i] = 0.0f;
  mbar_wait(w_bar, 0);

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    // bit mt*2 + half: the step is unmasked for row mt*16 + g + half*8
    unsigned live = 0, mb = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mt * 16 + g + half * 8;
        if (row < n_rows) {
          live |= 1u << (mt * 2 + half);
          if (mask[(size_t)row * n_steps + t] != 0) mb |= 1u << (mt * 2 + half);
        }
      }

    // the accumulators start from the x_proj tile: slot q of a thread's
    // fragment at (row, unit) is gate q of that cell
    float acc[MT][G][4][4];
    mbar_wait(x_bar, (uint32_t)s & 1u);
    if (leader && s + 1 < n_steps) mbar_expect_tx(x_bar, valid * kRowBytes);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int unit = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(
                gx + (mt * 16 + g + half * 8) * ws + (q * H + unit) * 2));
            acc[mt][gi][q][half * 2] = v.x;
            acc[mt][gi][q][half * 2 + 1] = v.y;
          }
      }
    // every warp of the group has read its x tile rows (and the last
    // step's h-tile writes are visible): the next step's rows may land
    group_sync(grp);
    if (s + 1 < n_steps) copy_rows(reverse ? t - 1 : t + 1);

    slab_gates<kLstmGates, G, MT, true>(acc, gh, hs, 0, w_s, ws, H, H, ug0,
                                        lane);
    group_sync(grp);  // the group has read its h tile rows

    // cell update (kernel 1's); masked steps carry the state and write zeros
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int unit = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const bool m = mb >> (mt * 2 + half) & 1u;
          float hn[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = half * 2 + u;
            const float ig = sigmoid_f32(acc[mt][gi][0][i]);
            const float fg = sigmoid_f32(acc[mt][gi][1][i]);
            const float gg = tanhf(acc[mt][gi][2][i]);
            const float og = sigmoid_f32(acc[mt][gi][3][i]);
            const float c_new = fg * c[mt][gi][i] + ig * gg;
            const float h_new = og * tanhf(c_new);
            if (m) c[mt][gi][i] = c_new;
            hn[u] = m ? h_new : 0.0f;
          }
          const bf162 v = __floats2bfloat162_rn(hn[0], hn[1]);
          const int r = mt * 16 + g + half * 8;
          if (m) *reinterpret_cast<bf162*>(gh + r * hs + unit * 2) = v;
          if (live >> (mt * 2 + half) & 1u)
            *reinterpret_cast<bf162*>(
                out + ((size_t)(row0 + r) * n_steps + t) * H + unit) = v;
        }
      }
    // the next step's first group_sync orders these h-tile writes
  }
}

int launch_mma(const void* x_proj, const void* mask, const void* w_staged,
               void* out, int n_rows, int n_steps, int reverse,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_rec_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kRecSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it so the next launch reads clean
    return (int)err;
  }
  lstm_rec_mma_kernel<<<(n_rows + kRecRows - 1) / kRecRows, kRecThreads, kRecSmem,
         stream>>>(static_cast<const __nv_bfloat16*>(x_proj),
                   static_cast<const uint8_t*>(mask),
                   static_cast<const __nv_bfloat16*>(w_staged),
                   static_cast<__nv_bfloat16*>(out), n_rows, n_steps,
                   reverse);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x_proj, const void* mask, const void* w_hh, void* out,
           int n_rows, int n_steps, int h_dim, int reverse,
           cudaStream_t stream) {
  const size_t smem = (size_t)h_dim * kStride * sizeof(float);
  const int bound = row_tile_bound(kRowGroups * h_dim);
  if (bound == 0) return (int)cudaErrorInvalidValue;  // 2H above 1024
  auto* kernel = bound == 256   ? lstm_rec_kernel<T, 256>
                 : bound == 512 ? lstm_rec_kernel<T, 512>
                                : lstm_rec_kernel<T, 1024>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it so the next launch reads clean
    return (int)err;
  }
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const dim3 block(kRowGroups * h_dim);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x_proj), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_hh), static_cast<T*>(out), n_rows, n_steps,
      h_dim, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 6.  x_proj [B, T, 4H], mask uint8 [B, T], out [B, T, H]; all
// contiguous, one dtype (0 = float32, 1 = bfloat16).  The route: bfloat16 at
// H = 128 runs the tensor-core kernel, and then `w_hh` points at the staged
// W_hh [H, 4H + 8] (8 zero columns a row) and x_proj, w_hh and out are
// 16-byte aligned; everything else up to H = 512 runs the CUDA-core kernel
// on w_hh [H, 4H] (2H <= 1024 threads); above it the launch is refused
// (the step route: cair_lstm_step).  `rec_tensor_cores` in ops/kernels/lstm.py
// states the same rule.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int cair_lstm_rec(const void* x_proj, const void* mask,
                             const void* w_hh, void* out, int n_rows,
                             int n_steps, int h_dim, int reverse, int dtype,
                             void* stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  if (h_dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && h_dim == kRecHidden) {
    using cair_lstm::tiles::aligned16;
    if (!aligned16(x_proj) || !aligned16(w_hh) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    return launch_mma(x_proj, mask, w_hh, out, n_rows, n_steps, reverse, s);
  }
  if (dtype == 0)
    return launch<float>(x_proj, mask, w_hh, out, n_rows, n_steps, h_dim,
                         reverse, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x_proj, mask, w_hh, out, n_rows, n_steps,
                                 h_dim, reverse, s);
  return (int)cudaErrorInvalidValue;
}
