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
// float32 (the configuration's default dtype) runs the same kernel,
// gru_fwd_mma_kernel<float>, on split-TF32 tiles (tf32_mma.cuh), as the
// LSTM's kernel 1 does (lstm_fwd.cu): the four slots' products are
// `mma.sync.m16n8k8` TF32 tiles on operands split where their fragments
// are loaded (hi = tf32(v), lo = v - hi; lo*hi, hi*lo, hi*hi in a fixed
// order), the step kernel 9 recomputes.  The weights, x_t's columns and h
// are staged f32, so the h tile holds the carried h exactly: z * h and
// kernel 8's hb read it there, and no h stays in registers.  The cell
// update keeps exact expf / tanhf in f32.  What bounds it: at the doc
// encoder's shape -> 128, 1.42e11 flops at split TF32's 165 TFLOP/s, 0.86
// ms, bound by operations; as H grows, the weight slabs' stream from L2
// (15.7 MB a step at H = 1,024, 16,000 / M times).  What the design does:
// kernel 1's rows and ranks -- one block up to H = 128, then
// f32_cluster's ranks of at most 128 units; 64 rows where the h tile fits,
// else 32, and fewer (to 16) where the row blocks would leave SMs idle --
// and its h tiles (f32_fwd_smem: two in turn, or one rewritten after a
// second cluster barrier a step where that deepens the slabs or two do
// not fit).
// E and H are multiples of 32 here, H of 16 C on a cluster of C.
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

// The tensor-core kernel in both dtypes (see the header note and
// lstm_mma.cuh).  Shared memory: weight ring (mbarriers, slabs, x slots) |
// h tile (two in a cluster, kCl, unless kOne) | bias slots r, z, xn, hn of
// the block's units (f32).  kOne: a float32 cluster whose ranks keep one h
// tile, rewritten between two cluster barriers a step.
template <typename T, int G, int MT, bool kRes, bool kCl, bool kOne>
__global__ void __launch_bounds__(tiles::kThreads, 1)
gru_fwd_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                   const T* __restrict__ w_staged, const T* __restrict__ b_ih,
                   const T* __restrict__ b_hh, T* __restrict__ out,
                   float* __restrict__ hb, int n_rows, int n_steps, int e,
                   int h_dim, int reverse, int tc, int ks) {
  using namespace tiles;
  using E = Elt<T>;
  constexpr int kE = (int)sizeof(T);  // bytes an element
  constexpr bool kF32 = kE == 4;
  // ranks a cluster may have: bf16 gru_cluster, float32 f32_cluster
  constexpr int kMaxC = kF32 ? kF32MaxRanks : 4;
  constexpr bool kTwo = kCl && !kOne;  // two h tiles in turn
  // the carried f32 h in registers: bf16's staged h is rounded, float32's
  // tile holds it exactly
  constexpr bool kRegH = !kF32;
  extern __shared__ __align__(16) char smem[];
  constexpr int M = 16 * MT;
  const int n_ranks = kCl ? (int)cluster_size() : 1;
  const int rank = kCl ? (int)cluster_rank() : 0;
  const int hc = h_dim / n_ranks, u_off = rank * hc;
  const int hs = h_stride(h_dim, kE);
  const int row0 = (blockIdx.x / n_ranks) * M;
  WeightRingT<T> ring;
  ring.init(smem,
            w_staged + (size_t)rank * (e + h_dim) *
                           (w_stride(hc, kGruGates, kE) / kE),
            x, e, h_dim, hc, kGruGates, ks, n_steps, row0, M, n_rows,
            n_steps);
  char* h_buf[2];
  h_buf[0] = ring.end();
  h_buf[1] = h_buf[0] + (kTwo ? M * hs : 0);
  float* bias_s = reinterpret_cast<float*>(h_buf[1] + M * hs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;

  for (int i = threadIdx.x; i < (kTwo ? 2 : 1) * M * hs / 16; i += kThreads)
    reinterpret_cast<uint4*>(h_buf[0])[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < hc; i += kThreads) {
    const int u = u_off + i;
#pragma unroll
    for (int q = 0; q < 2; ++q)  // r, z: both biases
      bias_s[q * hc + i] = to_f32(b_ih[q * h_dim + u]) +
                           to_f32(b_hh[q * h_dim + u]);
    bias_s[2 * hc + i] = to_f32(b_ih[2 * h_dim + u]);  // xn
    bias_s[3 * hc + i] = to_f32(b_hh[2 * h_dim + u]);  // hn
  }

  float h[kRegH ? MT : 1][kRegH ? G : 1][4];
#pragma unroll
  for (int mt = 0; mt < (kRegH ? MT : 1); ++mt)
#pragma unroll
    for (int gi = 0; gi < (kRegH ? G : 1); ++gi)
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
    const char* h_cur = h_buf[kTwo ? (s & 1) : 0];
    // the carried h of the thread's cell pair (row r, unit pair at unit)
    auto h_of = [&](int mt, int gi, int half, int r, int unit) {
      if constexpr (kRegH)
        return make_float2(h[mt][gi][half * 2],
                           h[mt][gi][half * 2 + 1]);
      else
        return E::load2(h_cur + r * hs + (u_off + unit) * kE);
    };
    // kernel 8: the first step of a chunk in processing order records the
    // carried h (the h tile is whole once the step's first h slab is
    // handed over, a cluster's wait included)
    const bool first =
        kRes && (reverse ? (t == n_steps - 1 || (t + 1) % tc == 0)
                         : (t % tc == 0));
    auto boundary = [&]() {
      const size_t base = (size_t)(t / tc) * n_rows;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int unit = (ug0 + gi) * 8 + 2 * tg;
            if (unit < hc && (live >> (mt * 2 + half) & 1u)) {
              const int r = mt * 16 + g + half * 8;
              *reinterpret_cast<float2*>(
                  hb + (base + row0 + r) * h_dim + u_off + unit) =
                  h_of(mt, gi, half, r, unit);
            }
          }
    };

    const int t_next = s + 1 < n_steps ? (reverse ? t - 1 : t + 1) : -1;
    float acc[MT][G][4][4];  // slots r, z, xn, hn
    step_gates<kGruGates, G, MT>(acc, ring, n, t, t_next, h_cur, bias_s, hc,
                                 ug0, lane, NoHook(), [&]() {
                                   // the other ranks' h of this step
                                   if (kCl && s > 0) cluster_wait();
                                   if (first) boundary();
                                 });
    const bool send = kCl && s + 1 < n_steps;
    // h is rewritten in place in a single block or a one-tile cluster:
    // every warp (every rank) must have read it; two tiles: the other one
    if constexpr (!kCl)
      __syncthreads();
    else if (kOne && send)
      cluster_sync();
    uint32_t dst[kMaxC] = {};  // the next h tile in each rank
    if (send)
      for (int q = 0; q < n_ranks; ++q)
        dst[q] = map_rank(h_buf[kTwo ? (s + 1) & 1 : 0], q);

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
            const int r = mt * 16 + g + half * 8;
            float2 hp = make_float2(0.0f, 0.0f);  // float32's carried h
            if constexpr (!kRegH) hp = h_of(mt, gi, half, r, unit);
            float hn[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = half * 2 + u;
              const float rg = sigmoid_f32(acc[mt][gi][0][i]);
              const float zg = sigmoid_f32(acc[mt][gi][1][i]);
              const float ng =
                  tanhf(acc[mt][gi][2][i] + rg * acc[mt][gi][3][i]);
              float h_new;
              if constexpr (kRegH) {
                h_new = (1.0f - zg) * ng + zg * h[mt][gi][i];
                if (m) h[mt][gi][i] = h_new;
              } else {
                // the contraction kernel 9's recompute compiles to, so it
                // reproduces these bits (chip_smoke's f32 phase)
                h_new =
                    __fmaf_rn(1.0f - zg, ng, __fmul_rn(zg, u ? hp.y : hp.x));
              }
              hn[u] = m ? h_new : 0.0f;
            }
            const int at = r * hs + (u_off + unit) * kE;
            if constexpr (kTwo) {
              // every rank's next tile: h_new, or the carried h
              if (send)
                for (int q = 0; q < n_ranks; ++q)
                  E::send2(dst[q] + at, m, hn[0], hn[1], h_cur + at);
            } else if (m) {
              if constexpr (kCl) {
                if (send)
                  for (int q = 0; q < n_ranks; ++q)
                    E::send2(dst[q] + at, true, hn[0], hn[1], nullptr);
              } else {
                E::store2(h_buf[0] + at, hn[0], hn[1]);
              }
            }
            if (live >> (mt * 2 + half) & 1u)
              E::store2(out + ((size_t)(row0 + r) * n_steps + t) * h_dim +
                            u_off + unit,
                        hn[0], hn[1]);
          }
        }
      }
    // a single block: the next step's first slab hand-over orders these
    // h-tile writes; a cluster: its barrier
    if (send) cluster_arrive();
  }
}

template <typename T, int G, int MT, bool kRes, bool kCl, bool kOne>
int launch_mma(const void* x, const void* mask, const void* w_staged,
               const void* b_ih, const void* b_hh, void* out, void* hb,
               int n_rows, int n_steps, int e, int h_dim, int reverse, int tc,
               int c, int ks, size_t smem, cudaStream_t stream) {
  const int m_rows = 16 * MT;
  return (int)launch_blocks(
      gru_fwd_mma_kernel<T, G, MT, kRes, kCl, kOne>,
      (n_rows + m_rows - 1) / m_rows, c, tiles::kThreads, smem, stream,
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_staged), static_cast<const T*>(b_ih),
      static_cast<const T*>(b_hh), static_cast<T*>(out),
      static_cast<float*>(hb), n_rows, n_steps, e, h_dim, reverse, tc, ks);
}

// launch_mma in float32 at mt 16-row tiles (4, 2 or 1) a block
template <bool kRes, int G, bool kCl, bool kOne, typename... Args>
int launch_rows(int mt, Args... args) {
  if (mt == 4) return launch_mma<float, G, 4, kRes, kCl, kOne>(args...);
  if (mt == 2) return launch_mma<float, G, 2, kRes, kCl, kOne>(args...);
  return launch_mma<float, G, 1, kRes, kCl, kOne>(args...);
}

// the float32 layout of f32_fwd_smem: a rank of a cluster (`cl`) with 2
// unit groups a warp and one h tile (`one`) or two, or one block with
// `groups` unit groups a warp
template <bool kRes, typename... Args>
int launch_f32(int mt, int groups, bool cl, bool one, Args... args) {
  if (cl)
    return one ? launch_rows<kRes, 2, true, true>(mt, args...)
               : launch_rows<kRes, 2, true, false>(mt, args...);
  return groups == 1 ? launch_rows<kRes, 1, false, false>(mt, args...)
                     : launch_rows<kRes, 2, false, false>(mt, args...);
}

// E and H multiples of 32 (bf16 gru_tiles_ok: H <= kMaxClustered, a
// multiple of 64 in a cluster of 4; float32 H of 16 C in a cluster of C),
// 16-byte aligned pointers, the weights staged (the wrapper pads, aligns
// and stages: one matrix a rank of the cluster); refused otherwise.  bf16:
// gru_cluster's blocks, pick_config's rows, 16 a rank; float32:
// f32_cluster's, f32_fwd_groups' unit groups, f32_fwd_smem's
// rows and h tiles.
template <bool kRes>
int dispatch(const void* x, const void* mask, const void* w_staged,
             const void* b_ih, const void* b_hh, void* out, void* hb,
             int n_rows, int n_steps, int e, int h_dim, int reverse, int tc,
             int dtype, void* stream) {
  using namespace tiles;
  if (n_rows == 0 || n_steps == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  const int c = bf16 ? gru_cluster(h_dim) : f32_cluster(h_dim);
  const bool shape = bf16 ? gru_tiles_ok(e, h_dim)
                          : e > 0 && e % kAlign == 0 && h_dim > 0 &&
                                h_dim % kAlign == 0 && c > 0 &&
                                h_dim % (16 * c) == 0;
  if (tc <= 0 || !shape || !aligned16(x) || !aligned16(w_staged) ||
      !aligned16(out) || (kRes && !aligned16(hb)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int ks = 0, n_tiles = 1;
  if (!bf16) {
    int m_rows = 0;
    const size_t smem =
        f32_fwd_smem(h_dim, kGruGates, n_rows, &m_rows, &ks, &n_tiles);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    return launch_f32<kRes>(m_rows / 16, f32_fwd_groups(h_dim), c > 1,
                            n_tiles == 1, x, mask, w_staged, b_ih, b_hh,
                            out, hb, n_rows, n_steps, e, h_dim, reverse, tc,
                            c, ks, smem, s);
  }
  using bf16_t = __nv_bfloat16;
  const Config cfg = c > 1 ? kClusterConfig : pick_config(h_dim);
  const size_t smem =
      mma_smem(h_dim, h_dim / c, kGruGates, 16 * cfg.mt, false, c, &ks);
  if (smem == 0) return (int)cudaErrorInvalidValue;  // H too large
#define CAIR_GRU_CASE(G_, MT_, CL_)                                          \
  if (cfg.g == G_)                                                           \
    return launch_mma<bf16_t, G_, MT_, kRes, CL_, false>(                    \
        x, mask, w_staged, b_ih, b_hh, out, hb, n_rows, n_steps, e, h_dim,   \
        reverse, tc, c, ks, smem, s);
  if (c > 1) {
    CAIR_GRU_CASE(kClusterConfig.g, kClusterConfig.mt, true)
  }
  CAIR_GRU_CASE(1, 4, false)
  CAIR_GRU_CASE(2, 4, false)
  CAIR_GRU_CASE(4, 2, false)
  CAIR_GRU_CASE(8, 1, false)
#undef CAIR_GRU_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The route rule of lstm_mma.cuh (`gru_route`): 0 one block, 1 a cluster,
// 2 the step route (cair_gru_step; cair_gru_bwd's phase A on
// lstm_step.cu), for hidden size h_dim in dtype (0 = float32, 1 =
// bfloat16) of kernels 7, 8 and 9 alike.
extern "C" int cair_gru_route(int h_dim, int dtype) {
  return cair_lstm::tiles::gru_route(h_dim, dtype == 1);
}

// Kernel 7.  x [B, T, E], mask uint8 [B, T], b_ih [3H], b_hh [3H], out
// [B, T, H]; all contiguous, one dtype (0 = float32, 1 = bfloat16).
// `w_staged` is [W_ih; W_hh] staged (W_ih [E, 3H] over W_hh [H, 3H], 8
// zero columns a row): one matrix [E + H, 3H + 8] in one block, or C
// matrices [E + H, 3H/C + 8] on a cluster of C (bf16 C = gru_cluster(H)
// above H = 448, float32 C = f32_cluster(H) above 128), rank r's holding
// the r, z, n columns of units r*H/C .. (r+1)*H/C - 1.  Above H = 1,024
// (the step route) it refuses: cair_gru_step runs kernels 7 and 8 there.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cair_gru_fwd(const void* x, const void* mask,
                            const void* w_staged, const void* b_ih,
                            const void* b_hh, void* out, int n_rows,
                            int n_steps, int e, int h_dim, int reverse,
                            int dtype, void* stream) {
  return dispatch<false>(x, mask, w_staged, b_ih, b_hh, out, nullptr, n_rows,
                         n_steps, e, h_dim, reverse, n_steps, dtype, stream);
}

// Kernel 8: kernel 7 plus hb float32 [ceil(T / tc), B, H], the carried h
// before each time chunk of tc steps in processing order.
extern "C" int cair_gru_fwd_res(const void* x, const void* mask,
                                const void* w_staged, const void* b_ih,
                                const void* b_hh, void* out, void* hb,
                                int n_rows, int n_steps, int e, int h_dim,
                                int reverse, int tc, int dtype,
                                void* stream) {
  return dispatch<true>(x, mask, w_staged, b_ih, b_hh, out, hb, n_rows,
                        n_steps, e, h_dim, reverse, tc, dtype, stream);
}
