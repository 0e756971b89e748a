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
// columns streamed beside each x slab (`cp.async`), so every E fits.  The n
// gate needs x_t @ W_in and h @ W_hn apart (r multiplies only the second),
// so a thread keeps four f32 slots per (row, unit): r and z take every
// slab, the n tile of an x slab goes into xn and that of an h slab into hn
// -- no zero blocks, no extra `mma` or streamed bytes.  The slots start
// from the biases as the TPU kernel adds them: r and z from b_ih + b_hh, xn
// from b_ih_n, hn from b_hh_n.  The cell update is register-local with the
// exact expf / tanhf; h is carried in f32 registers (z * h reads it, as on
// the TPU) and only its bf16 rounding goes back to the staged tile for the
// next step's product.  Kernel 8 writes hb[c] (h before time chunk c in
// processing order, zeros for the first chunk processed) straight from
// those registers; its output is kernel 7's bits.  Above H = 448
// (kGruMaxSingle, where kernel 9's single-block tiles stop fitting) the
// gate columns split over a cluster of 2 or 4 blocks of 16 rows
// (gru_cluster, lstm_mma.cuh): rank r computes the r, z and n columns of its
// H / C units from its own staged weight slice [E + H, 3H/C + 8] and
// writes their new h into every rank's next h tile through distributed
// shared memory, as kernel 1's clusters do.  E and H are multiples of 32
// here (64 in a cluster of 4): the wrapper zero-pads other sizes.
//
// float32 keeps exact f32 FMAs (no TF32): one block per 32 rows with 2*H
// threads, thread (rg, j) owning unit j of 16 rows, h staged in f32 k-major
// and x_t staged kF32Chunk k-rows at a time (any E), the weights read
// through L2.  Above H = 256 (f32_cluster) the units split over a cluster
// of up to 8 blocks of at most 256 threads: each holds the whole h, and a
// block writes its units' new h into every rank's tile.  Each (row, unit)'s
// FMAs run in the same k order either way.
//
// Above H = 1,024, in both dtypes, kernels 7 and 8 take the step route
// (gru_route in lstm_mma.cuh; lstm_step.cu with three gate blocks,
// entered through cair_gru_step): blocks of a row tile and a unit tile of
// 256 (bf16, H zero-padded to a multiple of it) or 128 (float32) units, h
// through device memory and a launch a time step, so no shared memory
// grows with H.
//
// As in the TPU kernel, h is rounded to the input dtype before the
// recurrent product (`hs.astype(whh_ref.dtype)`); everything else is f32.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"

namespace {

using namespace cair_lstm;

// kRes: also store h before each time chunk into hb [n_chunks, B, H].
// Chunk c holds time steps c*tc .. min((c+1)*tc, T) - 1.  kBound: the
// launch bound (row_tile_bound).  A block has 2 * hc threads and owns units
// rank*hc .. rank*hc + hc - 1 of a cluster of ceil(H / hc) blocks (kCl;
// else hc = H: one block).  Shared memory: h of all H units [H][kStride] |
// the x chunk [min(E, kF32Chunk)][kStride].
template <typename T, bool kRes, int kBound, bool kCl>
__global__ void __launch_bounds__(kBound)
gru_fwd_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
               const T* __restrict__ w_ih, const T* __restrict__ b_ih,
               const T* __restrict__ w_hh, const T* __restrict__ b_hh,
               T* __restrict__ out, float* __restrict__ hb, int n_rows,
               int n_steps, int e, int h_dim, int reverse, int tc, int hc) {
  extern __shared__ float4 smem4[];
  float* ht = reinterpret_cast<float*>(smem4);
  float* xt = ht + (size_t)h_dim * kStride;

  const int n_ranks = kCl ? (int)tiles::cluster_size() : 1;
  const int rank = kCl ? (int)tiles::cluster_rank() : 0;
  const int j = threadIdx.x % hc;
  const int rg = threadIdx.x / hc;
  const int unit = rank * hc + j;
  const bool active = !kCl || unit < h_dim;
  const int row0 = (blockIdx.x / n_ranks) * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;

  float h[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) h[i] = 0.0f;
  float bx[3], bh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bx[g] = active ? to_f32(b_ih[g * h_dim + unit]) : 0.0f;
    bh[g] = active ? to_f32(b_hh[g * h_dim + unit]) : 0.0f;
  }
  for (int i = threadIdx.x; i < h_dim * kStride; i += blockDim.x) ht[i] = 0.0f;
  f32_sync(kCl);

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    if (kRes && active) {
      // first step of a chunk in processing order: record the carried h
      const bool first = reverse ? (t == n_steps - 1 || (t + 1) % tc == 0)
                                 : (t % tc == 0);
      if (first) {
        const size_t base = (size_t)(t / tc) * n_rows;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = my_row0 + i;
          if (row < n_rows) hb[(base + row) * h_dim + unit] = h[i];
        }
      }
    }

    float ax[3][kRowsPerThread], ah[3][kRowsPerThread];
    gru_preacts<T>(ax, ah, xt, ht, x, w_ih, w_hh, bx, bh, row0, n_rows,
                   n_steps, t, e, h_dim, unit, rg, active);
    f32_sync(kCl);  // every block of the cluster is done reading its h tile

    // cell update; masked steps carry the state and write zeros
    float hr[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      if (active && row < n_rows) {
        const size_t pos = (size_t)row * n_steps + t;
        const float r = sigmoid_f32(ax[0][i] + ah[0][i]);
        const float z = sigmoid_f32(ax[1][i] + ah[1][i]);
        const float n = tanhf(ax[2][i] + r * ah[2][i]);
        const float h_new = (1.0f - z) * n + z * h[i];
        const bool m = mask[pos] != 0;
        if (m) h[i] = h_new;
        out[pos * h_dim + unit] = from_f32<T>(m ? h[i] : 0.0f);
      }
      hr[i] = round_to<T>(h[i]);
    }
    if (active) store_rows_all(ht, unit, rg, hr, kCl ? n_ranks : 0);
    // the h tiles are whole: a cluster's barrier; in a single block the next
    // step's x staging ends in a __syncthreads before h is read
    if constexpr (kCl) tiles::cluster_sync();
  }
}

// The bf16 tensor-core kernel (see the header note and lstm_mma.cuh).
// Shared memory: weight ring (mbarriers, slabs, x slots) | h tile (two in a
// cluster, kCl) | bias slots r, z, xn, hn of the block's units (f32).
template <int G, int MT, bool kRes, bool kCl>
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
  const int n_ranks = kCl ? (int)cluster_size() : 1;
  const int rank = kCl ? (int)cluster_rank() : 0;
  const int hc = h_dim / n_ranks, u_off = rank * hc;
  const int hs = h_stride(h_dim);
  const int row0 = (blockIdx.x / n_ranks) * M;
  WeightRing ring;
  ring.init(smem,
            w_staged + (size_t)rank * (e + h_dim) *
                           (w_stride(hc, kGruGates) / 2),
            x, e, h_dim, hc, kGruGates, ks, n_steps, row0, M, n_rows,
            n_steps);
  char* h_buf[2];
  h_buf[0] = ring.end();
  h_buf[1] = h_buf[0] + (kCl ? M * hs : 0);
  float* bias_s = reinterpret_cast<float*>(h_buf[1] + M * hs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;

  for (int i = threadIdx.x; i < (kCl ? 2 : 1) * M * hs / 16; i += kThreads)
    reinterpret_cast<uint4*>(h_buf[0])[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < hc; i += kThreads) {
    const int u = u_off + i;
#pragma unroll
    for (int q = 0; q < 2; ++q)  // r, z: both biases
      bias_s[q * hc + i] = __bfloat162float(b_ih[q * h_dim + u]) +
                           __bfloat162float(b_hh[q * h_dim + u]);
    bias_s[2 * hc + i] = __bfloat162float(b_ih[2 * h_dim + u]);  // xn
    bias_s[3 * hc + i] = __bfloat162float(b_hh[2 * h_dim + u]);  // hn
  }

  float h[MT][G][4];  // the carried state, f32
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) h[mt][gi][i] = 0.0f;

  ring.prologue(reverse ? n_steps - 1 : 0);
  __syncthreads();  // bias_s and the zeroed h tiles
  if constexpr (kCl) cluster_sync();  // every rank's tiles are zeroed

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
              if (unit < hc && (live >> (mt * 2 + half) & 1u)) {
                const int row = row0 + mt * 16 + g + half * 8;
                *reinterpret_cast<float2*>(hb + (base + row) * h_dim + u_off +
                                           unit) =
                    make_float2(h[mt][gi][half * 2], h[mt][gi][half * 2 + 1]);
              }
            }
      }
    }

    const int t_next = s + 1 < n_steps ? (reverse ? t - 1 : t + 1) : -1;
    const char* h_cur = h_buf[kCl ? (s & 1) : 0];
    float acc[MT][G][4][4];  // slots r, z, xn, hn
    step_gates<kGruGates, G, MT>(acc, ring, n, t, t_next, h_cur, bias_s, hc,
                                 ug0, lane, NoHook(), [&]() {
                                   // the other ranks' h of this step
                                   if (kCl && s > 0) cluster_wait();
                                 });
    // a single block rewrites its h tile in place: every warp must have
    // read it; a cluster writes the other tile
    if constexpr (!kCl) __syncthreads();
    const bool send = kCl && s + 1 < n_steps;
    uint32_t dst[4] = {0, 0, 0, 0};  // the next h tile in each rank
    if (send)
      for (int q = 0; q < n_ranks; ++q)
        dst[q] = map_rank(h_buf[(s + 1) & 1], q);

    // cell update; masked steps carry the state and write zeros
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int unit = (ug0 + gi) * 8 + 2 * tg;
        if (unit < hc) {
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
            const int col = u_off + unit;
            if constexpr (kCl) {
              if (send) {
                // the carried h where the step is masked
                const bf162 keep =
                    m ? v
                      : *reinterpret_cast<const bf162*>(h_cur + r * hs +
                                                        col * 2);
                const uint32_t bits = *reinterpret_cast<const uint32_t*>(&keep);
                for (int q = 0; q < n_ranks; ++q)
                  st_cluster_b32(dst[q] + r * hs + col * 2, bits);
              }
            } else if (m) {
              *reinterpret_cast<bf162*>(h_buf[0] + r * hs + col * 2) = v;
            }
            if (live >> (mt * 2 + half) & 1u)
              *reinterpret_cast<bf162*>(
                  out + ((size_t)(row0 + r) * n_steps + t) * h_dim + col) = v;
          }
        }
      }
    // a single block: the next step's first slab hand-over orders these
    // h-tile writes; a cluster: its barrier
    if (send) cluster_arrive();
  }
}

template <int G, int MT, bool kRes, bool kCl>
int launch_mma(const void* x, const void* mask, const void* w_staged,
               const void* b_ih, const void* b_hh, void* out, void* hb,
               int n_rows, int n_steps, int e, int h_dim, int reverse, int tc,
               int c, cudaStream_t stream) {
  using namespace tiles;
  using bf16 = __nv_bfloat16;
  int ks = 0;
  const int m_rows = 16 * MT;
  const size_t smem =
      mma_smem(h_dim, h_dim / c, kGruGates, m_rows, false, c, &ks);
  if (smem == 0) return (int)cudaErrorInvalidValue;  // H too large
  return (int)launch_blocks(
      gru_fwd_mma_kernel<G, MT, kRes, kCl>, (n_rows + m_rows - 1) / m_rows,
      c, kThreads, smem, stream, static_cast<const bf16*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(w_staged),
      static_cast<const bf16*>(b_ih), static_cast<const bf16*>(b_hh),
      static_cast<bf16*>(out), static_cast<float*>(hb), n_rows, n_steps, e,
      h_dim, reverse, tc, ks);
}

// bf16: E and H multiples of 32 (gru_tiles_ok: H <= kMaxClustered, a
// multiple of 64 in a cluster of 4), 16-byte aligned pointers, the weights
// staged (the wrapper pads, aligns and stages: one matrix a rank of the
// cluster); refused otherwise.
template <bool kRes>
int dispatch_mma(const void* x, const void* mask, const void* w_staged,
                 const void* b_ih, const void* b_hh, void* out, void* hb,
                 int n_rows, int n_steps, int e, int h_dim, int reverse,
                 int tc, cudaStream_t s) {
  using namespace tiles;
  if (!gru_tiles_ok(e, h_dim) || !aligned16(x) || !aligned16(w_staged) ||
      !aligned16(out) || (kRes && !aligned16(hb)))
    return (int)cudaErrorInvalidValue;
  const int c = gru_cluster(h_dim);
  if (c > 1)
    return launch_mma<kClusterConfig.g, kClusterConfig.mt, kRes, true>(
        x, mask, w_staged, b_ih, b_hh, out, hb, n_rows, n_steps, e, h_dim,
        reverse, tc, c, s);
  const Config cfg = pick_config(h_dim);
#define CAIR_GRU_CASE(G_, MT_)                                               \
  if (cfg.g == G_)                                                           \
    return launch_mma<G_, MT_, kRes, false>(x, mask, w_staged, b_ih, b_hh,   \
                                            out, hb, n_rows, n_steps, e,     \
                                            h_dim, reverse, tc, 1, s);
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
  const int c = f32_cluster(h_dim, false), hc = f32_units(h_dim, false);
  if (c == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)h_dim + f32_chunk_rows(e)) * kStride * sizeof(float);
  // a rank of a cluster has at most 2 * kF32Units = 256 threads, one block
  // at most 2 * kF32FwdSingle = 512
  const int bound = row_tile_bound(kRowGroups * hc);
  if (bound == 0 || bound > 512 || (c > 1 && bound > 256))
    return (int)cudaErrorInvalidValue;
  auto* kernel = c > 1           ? gru_fwd_kernel<T, kRes, 256, true>
                 : bound == 256 ? gru_fwd_kernel<T, kRes, 256, false>
                                : gru_fwd_kernel<T, kRes, 512, false>;
  return (int)launch_blocks(
      kernel, (n_rows + kRows - 1) / kRows, c, kRowGroups * hc, smem, stream,
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b_ih),
      static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
      static_cast<T*>(out), static_cast<float*>(hb), n_rows, n_steps, e,
      h_dim, reverse, tc, hc);
}

template <bool kRes>
int dispatch(const void* x, const void* mask, const void* w_ih,
             const void* b_ih, const void* w_hh, const void* b_hh, void* out,
             void* hb, int n_rows, int n_steps, int e, int h_dim, int reverse,
             int tc, int dtype, void* stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  if (h_dim <= 0 || e <= 0 || tc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)  // float32: H <= 1024 (f32_cluster)
    return launch<float, kRes>(x, mask, w_ih, b_ih, w_hh, b_hh, out, hb,
                               n_rows, n_steps, e, h_dim, reverse, tc, s);
  if (dtype == 1)
    return dispatch_mma<kRes>(x, mask, w_ih, b_ih, b_hh, out, hb, n_rows,
                              n_steps, e, h_dim, reverse, tc, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The route rule of lstm_mma.cuh (`gru_route`): 0 one block, 1 a cluster,
// 2 the step route (cair_gru_step; cair_gru_bwd's phase A on
// lstm_step.cu), for hidden size h_dim in dtype (0 = float32, 1 =
// bfloat16) of kernels 7 and 8 (backward 0) or 9 (1).
extern "C" int cair_gru_route(int h_dim, int dtype, int backward) {
  return cair_lstm::tiles::gru_route(h_dim, dtype == 1, backward != 0);
}

// Kernel 7.  x [B, T, E], mask uint8 [B, T], w_ih [E, 3H], b_ih [3H],
// w_hh [H, 3H], b_hh [3H], out [B, T, H]; all contiguous, one dtype
// (0 = float32, 1 = bfloat16).  bfloat16: `w_ih` points at the staged
// weights [E + H, 3H + 8] (W_ih over W_hh, 8 zero columns a row) -- above
// H = 448 C = gru_cluster(H) such matrices [E + H, 3H/C + 8], rank r's
// holding the r, z, n columns of units r*H/C .. (r+1)*H/C - 1 -- and `w_hh`
// is not read.  Above H = 1,024 (the step route) it refuses: cair_gru_step
// runs kernels 7 and 8 there.  Returns the cudaError_t of the launch (0 on
// success).
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
