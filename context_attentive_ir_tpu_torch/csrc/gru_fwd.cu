// Fused masked GRU forward for Hopper (sm_90a): kernel 7 and, with
// chunk-boundary residuals, kernel 8.
//
// Kernel 7 replaces the TPU kernel `_gru_fused_kernel` / `_gru_fused_impl`
// in context_attentive_ir_tpu/ops/pallas/gru.py (the `gru_pallas_fused`
// forward).  Kernel 8 replaces `_gru_fused_res_kernel` /
// `_gru_fused_res_impl` (the training forward of the same custom_vjp): the
// same computation plus the carried h at every time-chunk boundary, which
// the chunked-remat backward (gru_bwd.cu) restarts from.  Per step t and
// row b, torch gate order r, z, n:
//
//   xp = x[b, t] @ W_ih + b_ih;  hp = h @ W_hh + b_hh          (both f32)
//   r = sigmoid(xp_r + hp_r);  z = sigmoid(xp_z + hp_z)
//   n = tanh(xp_n + r * hp_n);  h' = (1 - z) * n + z * h
//   masked steps carry h; out[b, t] = h * mask[b, t]
//
// The input projection is computed inside the kernel, so the [B, T, 3H] gate
// tensor never reaches device memory: traffic is one read of x and one write
// of h, as on the TPU.
//
// What bounds it on the H100: at the serving doc-encoder shape
// [16000, 30, 256] -> 128 one direction is 2*B*T*(E+H)*3H = 1.42e11 flops
// (0.143 ms at the 989 TFLOP/s bf16 tensor-core peak) against 0.37 GB of
// x + h traffic (0.11 ms at 3.35 TB/s): bound by operations, which only the
// tensor cores deliver, through T steps that depend on each other.  Kernel
// 8's boundaries add n_chunks * B * H f32 (41 MB at TC = 6, 0.01 ms).
//
// Design, bfloat16 (the type every full-width path runs): lstm_mma.cuh's
// tiles with three gate blocks, as kernel 1 (lstm_fwd.cu) runs them with
// four.  A block of 8 warps owns M = 64 rows (32 or 16 for H above 128 or
// 256) for all T steps; per step [x_t | h] @ [W_ih; W_hh] is
// `mma.sync.m16n8k16` tiles (bf16 in, f32 accumulate), both operands read
// by `ldmatrix` from shared memory: h staged in bf16, the weights --
// staged by the wrapper as one padded [E + H, 3H + 8] matrix -- streamed
// from L2 through the three-slab ring of `cp.async.bulk` copies, and x_t's
// columns streamed beside each x slab (`cp.async`), so every E fits.  The n gate needs
// x_t @ W_in and h @ W_hn apart (r multiplies only the second), so a
// thread keeps four f32 slots per (row, unit): r and z take every slab, the
// n tile of an x slab goes into xn and that of an h slab into hn -- no
// zero blocks, no extra `mma` or streamed bytes.  The slots start from the
// biases as the TPU kernel adds them: r and z from b_ih + b_hh, xn from
// b_ih_n, hn from b_hh_n.  The cell update is register-local with the exact
// expf / tanhf; h is carried in f32 registers (z * h reads it, as on the
// TPU) and only its bf16 rounding goes back to the staged tile for the next
// step's product.  Kernel 8 writes hb[c] (h before time chunk c in
// processing order, zeros for the first chunk processed) straight from
// those registers; its output is kernel 7's bits.  E and H are multiples of
// 32 here: the wrapper zero-pads other sizes.
//
// float32 keeps exact f32 FMAs (no TF32): one block per 32 rows with 2*H
// threads, thread (rg, j) owning unit j of 16 rows, [x_t | h] staged in f32
// and the weights read through L2.  It serves the small f32 checks against
// the CPU, not the full-width paths.
//
// As in the TPU kernel, h is rounded to the input dtype before the
// recurrent product (`hs.astype(whh_ref.dtype)`); everything else is f32.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"

namespace {

using namespace cair_lstm;

// One GRU step's projections for the thread's 16 rows and unit j:
// ax[g][i] = b_ih[g*H + j] + x_t @ W_ih[:, g*H + j] and ah[g][i] = b_hh[g*H +
// j] + h @ W_hh[:, g*H + j], g = r, z, n.  Stages [x_t | h] (stage_x_h);
// the caller synchronises before the tile is overwritten.
template <typename T>
__device__ __forceinline__ void gru_preacts(
    float ax[3][kRowsPerThread], float ah[3][kRowsPerThread], float* tile,
    const T* __restrict__ x, const T* __restrict__ w_ih,
    const T* __restrict__ w_hh, const float bx[3], const float bh[3],
    const float h[kRowsPerThread], int row0, int n_rows, int n_steps, int t,
    int e, int h_dim, int j, int rg) {
  stage_x_h<T>(tile, x, h, row0, n_rows, n_steps, t, e, j, rg);
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      ax[g][i] = bx[g];
      ah[g][i] = bh[g];
    }
  }
  const int g3 = 3 * h_dim;
  dot_rows<3, T>(ax, tile, 0, rg, w_ih + j, e, g3, h_dim);
  dot_rows<3, T>(ah, tile, e, rg, w_hh + j, h_dim, g3, h_dim);
}

// kRes: also store h before each time chunk into hb [n_chunks, B, H].
// Chunk c holds time steps c*tc .. min((c+1)*tc, T) - 1.  kBound: the
// launch bound (row_tile_bound).
template <typename T, bool kRes, int kBound>
__global__ void __launch_bounds__(kBound)
gru_fwd_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
               const T* __restrict__ w_ih, const T* __restrict__ b_ih,
               const T* __restrict__ w_hh, const T* __restrict__ b_hh,
               T* __restrict__ out, float* __restrict__ hb, int n_rows,
               int n_steps, int e, int h_dim, int reverse, int tc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [(e + h_dim)][kStride]

  const int j = threadIdx.x % h_dim;
  const int rg = threadIdx.x / h_dim;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;

  float h[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) h[i] = 0.0f;
  float bx[3], bh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bx[g] = to_f32(b_ih[g * h_dim + j]);
    bh[g] = to_f32(b_hh[g * h_dim + j]);
  }

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    if (kRes) {
      // first step of a chunk in processing order: record the carried h
      const bool first = reverse ? (t == n_steps - 1 || (t + 1) % tc == 0)
                                 : (t % tc == 0);
      if (first) {
        const size_t base = (size_t)(t / tc) * n_rows;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = my_row0 + i;
          if (row < n_rows) hb[(base + row) * h_dim + j] = h[i];
        }
      }
    }

    float ax[3][kRowsPerThread], ah[3][kRowsPerThread];
    gru_preacts<T>(ax, ah, xs, x, w_ih, w_hh, bx, bh, h, row0, n_rows,
                   n_steps, t, e, h_dim, j, rg);

    // cell update; masked steps carry the state and write zeros
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      if (row < n_rows) {
        const size_t pos = (size_t)row * n_steps + t;
        const float r = sigmoid_f32(ax[0][i] + ah[0][i]);
        const float z = sigmoid_f32(ax[1][i] + ah[1][i]);
        const float n = tanhf(ax[2][i] + r * ah[2][i]);
        const float h_new = (1.0f - z) * n + z * h[i];
        const bool m = mask[pos] != 0;
        if (m) h[i] = h_new;
        out[pos * h_dim + j] = from_f32<T>(m ? h[i] : 0.0f);
      }
    }
    __syncthreads();  // the next step overwrites the staged tile
  }
}

// The bf16 tensor-core kernel (see the header note and lstm_mma.cuh).
// Shared memory: weight ring (mbarriers, slabs, x slots) | h tile |
// bias slots r, z, xn, hn (f32).
template <int G, int MT, bool kRes>
__global__ void __launch_bounds__(tiles::kThreads, 1)
gru_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ w_staged,
                   const __nv_bfloat16* __restrict__ b_ih,
                   const __nv_bfloat16* __restrict__ b_hh,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ hb,
                   int n_rows, int n_steps, int e, int h_dim, int reverse,
                   int tc, int ks) {
  using namespace tiles;
  extern __shared__ __align__(16) char smem[];
  constexpr int M = 16 * MT;
  const int hs = h_stride(h_dim);
  const int row0 = blockIdx.x * M;
  WeightRing ring;
  ring.init(smem, w_staged, x, e, h_dim, h_dim, kGruGates, ks, n_steps, row0,
            M, n_rows, n_steps);
  char* h_tile = ring.end();
  float* bias_s = reinterpret_cast<float*>(h_tile + M * hs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;

  for (int i = threadIdx.x; i < M * hs / 16; i += kThreads)
    reinterpret_cast<uint4*>(h_tile)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < h_dim; i += kThreads) {
#pragma unroll
    for (int q = 0; q < 2; ++q)  // r, z: both biases
      bias_s[q * h_dim + i] = __bfloat162float(b_ih[q * h_dim + i]) +
                              __bfloat162float(b_hh[q * h_dim + i]);
    bias_s[2 * h_dim + i] = __bfloat162float(b_ih[2 * h_dim + i]);  // xn
    bias_s[3 * h_dim + i] = __bfloat162float(b_hh[2 * h_dim + i]);  // hn
  }

  float h[MT][G][4];  // the carried state, f32
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) h[mt][gi][i] = 0.0f;

  ring.prologue(reverse ? n_steps - 1 : 0);
  __syncthreads();  // bias_s and the zeroed h tile

  int n = 0;
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
    if constexpr (kRes) {
      // first step of a chunk in processing order: record the carried h
      const bool first = reverse ? (t == n_steps - 1 || (t + 1) % tc == 0)
                                 : (t % tc == 0);
      if (first) {
        const size_t base = (size_t)(t / tc) * n_rows;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int unit = (ug0 + gi) * 8 + 2 * tg;
              if (unit < h_dim && (live >> (mt * 2 + half) & 1u)) {
                const int row = row0 + mt * 16 + g + half * 8;
                *reinterpret_cast<float2*>(hb + (base + row) * h_dim + unit) =
                    make_float2(h[mt][gi][half * 2], h[mt][gi][half * 2 + 1]);
              }
            }
      }
    }

    float acc[MT][G][4][4];  // slots r, z, xn, hn
    const int t_next = s + 1 < n_steps ? (reverse ? t - 1 : t + 1) : -1;
    step_gates<kGruGates, G, MT>(acc, ring, n, t, t_next, h_tile, bias_s,
                                 h_dim, ug0, lane, NoHook(), NoHook());
    __syncthreads();  // every warp has read the h tile of this step

    // cell update; masked steps carry the state and write zeros
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int unit = (ug0 + gi) * 8 + 2 * tg;
        if (unit < h_dim) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const bool m = mb >> (mt * 2 + half) & 1u;
            float hn[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = half * 2 + u;
              const float rg = sigmoid_f32(acc[mt][gi][0][i]);
              const float zg = sigmoid_f32(acc[mt][gi][1][i]);
              const float ng =
                  tanhf(acc[mt][gi][2][i] + rg * acc[mt][gi][3][i]);
              const float h_new = (1.0f - zg) * ng + zg * h[mt][gi][i];
              if (m) h[mt][gi][i] = h_new;
              hn[u] = m ? h_new : 0.0f;
            }
            const bf162 v = __floats2bfloat162_rn(hn[0], hn[1]);
            const int r = mt * 16 + g + half * 8;
            if (m) *reinterpret_cast<bf162*>(h_tile + r * hs + unit * 2) = v;
            if (live >> (mt * 2 + half) & 1u)
              *reinterpret_cast<bf162*>(
                  out + ((size_t)(row0 + r) * n_steps + t) * h_dim + unit) = v;
          }
        }
      }
    // the next step's first slab hand-over orders these h-tile writes
  }
}

template <int G, int MT, bool kRes>
int launch_mma(const void* x, const void* mask, const void* w_staged,
               const void* b_ih, const void* b_hh, void* out, void* hb,
               int n_rows, int n_steps, int e, int h_dim, int reverse, int tc,
               cudaStream_t stream) {
  using namespace tiles;
  using bf16 = __nv_bfloat16;
  int ks = 0;
  const size_t smem =
      mma_smem(h_dim, h_dim, kGruGates, 16 * MT, false, 1, &ks);
  if (smem == 0) return (int)cudaErrorInvalidValue;  // H too large
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_mma_kernel<G, MT, kRes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const int m_rows = 16 * MT;
  gru_fwd_mma_kernel<G, MT, kRes>
      <<<(n_rows + m_rows - 1) / m_rows, kThreads, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const uint8_t*>(mask),
          static_cast<const bf16*>(w_staged), static_cast<const bf16*>(b_ih),
          static_cast<const bf16*>(b_hh), static_cast<bf16*>(out),
          static_cast<float*>(hb), n_rows, n_steps, e, h_dim, reverse, tc,
          ks);
  return (int)cudaGetLastError();
}

// bf16: E and H multiples of 32, H <= 512, 16-byte aligned pointers, the
// weights staged (the wrapper pads, aligns and stages); refused otherwise.
template <bool kRes>
int dispatch_mma(const void* x, const void* mask, const void* w_staged,
                 const void* b_ih, const void* b_hh, void* out, void* hb,
                 int n_rows, int n_steps, int e, int h_dim, int reverse,
                 int tc, cudaStream_t s) {
  using namespace tiles;
  if (e <= 0 || e % kAlign != 0 || h_dim % kAlign != 0 ||
      h_dim > kMaxHidden || !aligned16(x) || !aligned16(w_staged) ||
      !aligned16(out) || (kRes && !aligned16(hb)))
    return (int)cudaErrorInvalidValue;
  const Config cfg = pick_config(h_dim);
#define CAIR_GRU_CASE(G_, MT_)                                              \
  if (cfg.g == G_)                                                          \
    return launch_mma<G_, MT_, kRes>(x, mask, w_staged, b_ih, b_hh, out, hb, \
                                     n_rows, n_steps, e, h_dim, reverse, tc, \
                                     s);
  CAIR_GRU_CASE(1, 4)
  CAIR_GRU_CASE(2, 4)
  CAIR_GRU_CASE(4, 2)
  CAIR_GRU_CASE(8, 1)
#undef CAIR_GRU_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kRes>
int launch(const void* x, const void* mask, const void* w_ih,
           const void* b_ih, const void* w_hh, const void* b_hh, void* out,
           void* hb, int n_rows, int n_steps, int e, int h_dim, int reverse,
           int tc, cudaStream_t stream) {
  const size_t smem = (size_t)(e + h_dim) * kStride * sizeof(float);
  const int bound = row_tile_bound(kRowGroups * h_dim);
  if (bound == 0) return (int)cudaErrorInvalidValue;
  auto* kernel = bound == 256   ? gru_fwd_kernel<T, kRes, 256>
                 : bound == 512 ? gru_fwd_kernel<T, kRes, 512>
                                : gru_fwd_kernel<T, kRes, 1024>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {  // e.g. E + H too large for the shared tile
    cudaGetLastError();      // clear it so the next launch reads clean
    return (int)err;
  }
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const dim3 block(kRowGroups * h_dim);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b_ih),
      static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
      static_cast<T*>(out), static_cast<float*>(hb), n_rows, n_steps, e,
      h_dim, reverse, tc);
  return (int)cudaGetLastError();
}

template <bool kRes>
int dispatch(const void* x, const void* mask, const void* w_ih,
             const void* b_ih, const void* w_hh, const void* b_hh, void* out,
             void* hb, int n_rows, int n_steps, int e, int h_dim, int reverse,
             int tc, int dtype, void* stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  if (h_dim <= 0 || e <= 0 || tc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)  // a block has 2H threads (at most 1024)
    return launch<float, kRes>(x, mask, w_ih, b_ih, w_hh, b_hh, out, hb,
                               n_rows, n_steps, e, h_dim, reverse, tc, s);
  if (dtype == 1)
    return dispatch_mma<kRes>(x, mask, w_ih, b_ih, b_hh, out, hb, n_rows,
                              n_steps, e, h_dim, reverse, tc, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 7.  x [B, T, E], mask uint8 [B, T], w_ih [E, 3H], b_ih [3H],
// w_hh [H, 3H], b_hh [3H], out [B, T, H]; all contiguous, one dtype
// (0 = float32, 1 = bfloat16).  bfloat16: `w_ih` points at the staged
// weights [E + H, 3H + 8] (W_ih over W_hh, 8 zero columns a row) and `w_hh`
// is not read.  Returns the cudaError_t of the launch (0 on success).
extern "C" int cair_gru_fwd(const void* x, const void* mask,
                            const void* w_ih, const void* b_ih,
                            const void* w_hh, const void* b_hh, void* out,
                            int n_rows, int n_steps, int e, int h_dim,
                            int reverse, int dtype, void* stream) {
  return dispatch<false>(x, mask, w_ih, b_ih, w_hh, b_hh, out, nullptr,
                         n_rows, n_steps, e, h_dim, reverse, n_steps, dtype,
                         stream);
}

// Kernel 8: kernel 7 plus hb float32 [ceil(T / tc), B, H], the carried h
// before each time chunk of tc steps in processing order.
extern "C" int cair_gru_fwd_res(const void* x, const void* mask,
                                const void* w_ih, const void* b_ih,
                                const void* w_hh, const void* b_hh,
                                void* out, void* hb, int n_rows, int n_steps,
                                int e, int h_dim, int reverse, int tc,
                                int dtype, void* stream) {
  return dispatch<true>(x, mask, w_ih, b_ih, w_hh, b_hh, out, hb, n_rows,
                        n_steps, e, h_dim, reverse, tc, dtype, stream);
}
