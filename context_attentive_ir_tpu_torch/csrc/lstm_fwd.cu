// Fused masked LSTM forward for Hopper (sm_90a): kernel 1 and, with
// chunk-boundary residuals, kernel 4.
//
// Kernel 1 replaces the TPU kernel `_lstm_fused_kernel` / `_lstm_fused_impl`
// in context_attentive_ir_tpu/ops/pallas/lstm.py (the `lstm_pallas_fused`
// forward).  Kernel 4 replaces `_lstm_fused_res_kernel` /
// `_lstm_fused_res_impl` (the training forward of the same custom_vjp): the
// same computation plus the carried (h, c) at every time-chunk boundary,
// which the chunked-remat backward (lstm_bwd.cu) restarts from.  Per step t
// and row b:
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
// x + h traffic (0.11 ms at 3.35 TB/s): bound by operations, which only the
// tensor cores deliver, through T steps that depend on each other.
//
// Design, bfloat16 (the type every full-width path runs): lstm_mma.cuh's
// tiles.  A block of 8 warps owns M = 64 rows (32 or 16 for H above 128 or
// 256) for all T steps; per step the gate pre-activations
// [M x 4H] = [x_t | h] @ [W_ih; W_hh] are `mma.sync.m16n8k16` tiles (bf16
// in, f32 accumulate) with both operands read by `ldmatrix` from shared
// memory: [x_t | h] staged in bf16 (x double-buffered by `cp.async`, one
// step ahead), the weights -- staged by the wrapper as one padded matrix --
// streamed from L2 through a three-slab ring, one bulk copy
// (`cp.async.bulk` on an mbarrier) a slab, that runs on across steps.  Each
// warp takes all rows of its hidden units and all four gates of them, so a
// thread's accumulators hold the
// four gates of its (row, unit) cells: the cell update is register-local,
// c (and for kernel 4 the f32 h) never leave registers, and only the
// bf16-rounded h goes back to the staged tile.  Kernel 4 writes hb / cb
// (the state before time chunk j in processing order, zeros for the first
// chunk processed) straight from those registers.  E and H are multiples of
// 32 here: the wrapper zero-pads other sizes.
//
// float32 keeps exact f32 FMAs (no TF32): one block per 32 rows with 2*H
// threads, thread (rg, j) owning unit j of 16 rows, [x_t | h] staged in f32
// and the weights read through L2 (lstm_common.cuh's gate_preacts).  It
// serves the small f32 checks against the CPU, not the full-width paths.
//
// As in the TPU kernel, h is rounded to the input dtype before the
// recurrent product (`hs.astype(whh_ref.dtype)`); everything else is f32.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"

namespace {

using namespace cair_lstm;

// kRes: also store the chunk-boundary state into hb / cb [n_chunks, B, H].
// Chunk c holds time steps c*tc .. min((c+1)*tc, T) - 1.
template <typename T, bool kRes>
__global__ void lstm_fwd_kernel(const T* __restrict__ x,
                                const uint8_t* __restrict__ mask,
                                const T* __restrict__ w_ih,
                                const T* __restrict__ bias,
                                const T* __restrict__ w_hh,
                                T* __restrict__ out, float* __restrict__ hb,
                                float* __restrict__ cb, int n_rows,
                                int n_steps, int e, int h_dim, int reverse,
                                int tc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [(e + h_dim)][kStride]

  const int j = threadIdx.x % h_dim;
  const int rg = threadIdx.x / h_dim;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;

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

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    if (kRes) {
      // first step of a chunk in processing order: record the carried state
      const bool first = reverse ? (t == n_steps - 1 || (t + 1) % tc == 0)
                                 : (t % tc == 0);
      if (first) {
        const size_t base = (size_t)(t / tc) * n_rows;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = my_row0 + i;
          if (row < n_rows) {
            hb[(base + row) * h_dim + j] = h[i];
            cb[(base + row) * h_dim + j] = c[i];
          }
        }
      }
    }

    float acc[4][kRowsPerThread];
    gate_preacts<T>(acc, xs, x, w_ih, w_hh, bg, h, row0, n_rows, n_steps, t,
                    e, h_dim, j, rg);

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

// The bf16 tensor-core kernel (see the header note and lstm_mma.cuh).
// Shared memory: weight ring (mbarriers, slabs) | x tile, twice | h tile |
// bias (f32).
template <int G, int MT, bool kRes>
__global__ void __launch_bounds__(tiles::kThreads, 1)
lstm_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ w_staged,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ hb,
                    float* __restrict__ cb, int n_rows, int n_steps, int e,
                    int h_dim, int reverse, int tc, int ks) {
  using namespace tiles;
  extern __shared__ __align__(16) char smem[];
  constexpr int M = 16 * MT;
  const int xs = x_stride(e), hs = h_stride(h_dim);
  WeightRing ring;
  ring.init(smem, w_staged, e, h_dim, ks, n_steps);
  char* xbuf[2];
  xbuf[0] = ring.base + kStages * ring.slab_bytes;
  xbuf[1] = xbuf[0] + M * xs;
  char* h_tile = xbuf[1] + M * xs;
  float* bias_s = reinterpret_cast<float*>(h_tile + M * hs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;
  const int row0 = blockIdx.x * M;

  for (int i = threadIdx.x; i < M * hs / 16; i += kThreads)
    reinterpret_cast<uint4*>(h_tile)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < 4 * h_dim; i += kThreads)
    bias_s[i] = __bfloat162float(bias[i]);

  float c[MT][G][4];
  // the f32 h: only kernel 4's boundaries need it
  float h[kRes ? MT : 1][kRes ? G : 1][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[mt][gi][i] = 0.0f;
        if constexpr (kRes) h[mt][gi][i] = 0.0f;
      }

  // the first x tile rides in the ring's first commit group
  load_x_tile(xbuf[0], x, row0, M, n_rows, n_steps,
              reverse ? n_steps - 1 : 0, e);
  ring.prologue();
  __syncthreads();  // bias_s and the zeroed h tile

  long long n = 0;
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
      // first step of a chunk in processing order: record the carried state
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
                const size_t at = (base + row) * h_dim + unit;
                *reinterpret_cast<float2*>(hb + at) = make_float2(
                    h[mt][gi][half * 2], h[mt][gi][half * 2 + 1]);
                *reinterpret_cast<float2*>(cb + at) = make_float2(
                    c[mt][gi][half * 2], c[mt][gi][half * 2 + 1]);
              }
            }
      }
    }

    float acc[MT][G][4][4];
    step_gates<G, MT>(acc, ring, n, xbuf[s & 1], h_tile, bias_s, ug0, lane,
                      [&]() {
                        if (s + 1 < n_steps)
                          load_x_tile(xbuf[(s + 1) & 1], x, row0, M, n_rows,
                                      n_steps, reverse ? t - 1 : t + 1, e);
                      });
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
              const float ig = sigmoid_f32(acc[mt][gi][0][i]);
              const float fg = sigmoid_f32(acc[mt][gi][1][i]);
              const float gg = tanhf(acc[mt][gi][2][i]);
              const float og = sigmoid_f32(acc[mt][gi][3][i]);
              const float c_new = fg * c[mt][gi][i] + ig * gg;
              const float h_new = og * tanhf(c_new);
              if (m) {
                c[mt][gi][i] = c_new;
                if constexpr (kRes) h[mt][gi][i] = h_new;
              }
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
int launch_mma(const void* x, const void* mask, const void* w_ih,
               const void* b, void* out, void* hb, void* cb, int n_rows,
               int n_steps, int e, int h_dim, int reverse, int tc,
               cudaStream_t stream) {
  using namespace tiles;
  int ks = 0;
  const size_t smem = mma_smem(e, h_dim, 16 * MT, false, &ks);
  if (smem == 0) return (int)cudaErrorInvalidValue;  // E + H too large
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_mma_kernel<G, MT, kRes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const int m_rows = 16 * MT;
  lstm_fwd_mma_kernel<G, MT, kRes>
      <<<(n_rows + m_rows - 1) / m_rows, kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const uint8_t*>(mask),
          static_cast<const __nv_bfloat16*>(w_ih),
          static_cast<const __nv_bfloat16*>(b),
          static_cast<__nv_bfloat16*>(out), static_cast<float*>(hb),
          static_cast<float*>(cb), n_rows, n_steps, e, h_dim, reverse, tc,
          ks);
  return (int)cudaGetLastError();
}

// bf16: E and H multiples of 32, H <= 512, 16-byte aligned pointers, the
// weights staged (the wrapper pads, aligns and stages); refused otherwise.
template <bool kRes>
int dispatch_mma(const void* x, const void* mask, const void* w_ih,
                 const void* b, void* out, void* hb, void* cb, int n_rows,
                 int n_steps, int e, int h_dim, int reverse, int tc,
                 cudaStream_t s) {
  using namespace tiles;
  if (e <= 0 || e % kAlign != 0 || h_dim % kAlign != 0 ||
      h_dim > kMaxHidden || !aligned16(x) || !aligned16(w_ih) ||
      !aligned16(out) || (kRes && !aligned16(hb)) ||
      (kRes && !aligned16(cb)))
    return (int)cudaErrorInvalidValue;
  const Config cfg = pick_config(h_dim);
#define CAIR_FWD_CASE(G_, MT_)                                               \
  if (cfg.g == G_)                                                           \
    return launch_mma<G_, MT_, kRes>(x, mask, w_ih, b, out, hb, cb, n_rows,  \
                                     n_steps, e, h_dim, reverse, tc, s);
  CAIR_FWD_CASE(1, 4)
  CAIR_FWD_CASE(2, 4)
  CAIR_FWD_CASE(4, 2)
  CAIR_FWD_CASE(8, 1)
#undef CAIR_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kRes>
int launch(const void* x, const void* mask, const void* w_ih, const void* b,
           const void* w_hh, void* out, void* hb, void* cb, int n_rows,
           int n_steps, int e, int h_dim, int reverse, int tc,
           cudaStream_t stream) {
  const size_t smem = (size_t)(e + h_dim) * kStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T, kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {  // e.g. E + H too large for the shared tile
    cudaGetLastError();      // clear it so the next launch reads clean
    return (int)err;
  }
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const dim3 block(kRowGroups * h_dim);
  lstm_fwd_kernel<T, kRes><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b),
      static_cast<const T*>(w_hh), static_cast<T*>(out),
      static_cast<float*>(hb), static_cast<float*>(cb), n_rows, n_steps, e,
      h_dim, reverse, tc);
  return (int)cudaGetLastError();
}

template <bool kRes>
int dispatch(const void* x, const void* mask, const void* w_ih, const void* b,
             const void* w_hh, void* out, void* hb, void* cb, int n_rows,
             int n_steps, int e, int h_dim, int reverse, int tc, int dtype,
             void* stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  if (h_dim <= 0 || tc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    // a block has 2H threads (at most 1024)
    if (kRowGroups * h_dim > 1024) return (int)cudaErrorInvalidValue;
    return launch<float, kRes>(x, mask, w_ih, b, w_hh, out, hb, cb, n_rows,
                               n_steps, e, h_dim, reverse, tc, s);
  }
  if (dtype == 1)
    return dispatch_mma<kRes>(x, mask, w_ih, b, out, hb, cb, n_rows, n_steps,
                              e, h_dim, reverse, tc, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 1.  x [B, T, E], mask uint8 [B, T], w_ih [E, 4H], b [4H],
// w_hh [H, 4H], out [B, T, H]; all contiguous, one dtype (0 = float32,
// 1 = bfloat16).  bfloat16: `w_ih` points at the staged weights
// [E + H, 4H + 8] (W_ih over W_hh, 8 zero columns a row) and `w_hh` is not
// read.  Returns the cudaError_t of the launch (0 on success).
extern "C" int cair_lstm_fwd(const void* x, const void* mask,
                             const void* w_ih, const void* b,
                             const void* w_hh, void* out, int n_rows,
                             int n_steps, int e, int h_dim, int reverse,
                             int dtype, void* stream) {
  return dispatch<false>(x, mask, w_ih, b, w_hh, out, nullptr, nullptr,
                         n_rows, n_steps, e, h_dim, reverse, n_steps, dtype,
                         stream);
}

// Kernel 4: kernel 1 plus hb, cb float32 [ceil(T / tc), B, H], the carried
// (h, c) before each time chunk of tc steps in processing order.
extern "C" int cair_lstm_fwd_res(const void* x, const void* mask,
                                 const void* w_ih, const void* b,
                                 const void* w_hh, void* out, void* hb,
                                 void* cb, int n_rows, int n_steps, int e,
                                 int h_dim, int reverse, int tc, int dtype,
                                 void* stream) {
  return dispatch<true>(x, mask, w_ih, b, w_hh, out, hb, cb, n_rows, n_steps,
                        e, h_dim, reverse, tc, dtype, stream);
}
