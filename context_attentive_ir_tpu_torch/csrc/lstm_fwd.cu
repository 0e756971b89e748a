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
// memory: h staged in bf16, the weights -- staged by the wrapper as one
// padded matrix -- streamed from L2 through a three-slab ring, one bulk
// copy (`cp.async.bulk` on an mbarrier) a slab, that runs on across steps,
// and x_t's columns streamed beside each x slab (`cp.async`), so no tile
// grows with E.  Each warp takes all rows of its hidden units and all four
// gates of them, so a thread's accumulators hold the four gates of its
// (row, unit) cells: the cell update is register-local, c (and for kernel 4
// the f32 h) never leave registers, and only the bf16-rounded h goes back
// to the staged tile.  Kernel 4 writes hb / cb (the state before time chunk
// j in processing order, zeros for the first chunk processed) straight from
// those registers.  Above H = 384 (kMaxSingle) the gate columns split over
// a cluster of 2 or 4 blocks of 16 rows (lstm_mma.cuh): each rank computes
// its H / C units from its own weight slice and writes their new h into
// every rank's next h tile through distributed shared memory.  E and H are
// multiples of 32 here: the wrapper zero-pads other sizes.
//
// float32 (the configuration's default dtype) runs the same kernel,
// lstm_fwd_mma_kernel<float>, on split-TF32 tiles (tf32_mma.cuh):
// [x_t | h] @ [W_ih; W_hh] is `mma.sync.m16n8k8` TF32 tiles on operands
// split where their fragments are loaded, hi = tf32(v) and lo = v - hi,
// three products a tile (lo*hi, hi*lo, hi*hi; about 21 of float32's 24
// bits) in a fixed order, the same step as kernel 5's recompute.  The
// weights are staged f32 (one matrix a rank), x_t's columns and h too, so
// the h tile holds the carried h exactly and kernel 4 writes hb from it
// (no f32 h stays in registers); c stays in registers, and the cell update
// keeps exact expf / tanhf in f32.  What bounds it: at the doc encoder's
// shape -> 128, 1.9e11 flops at split TF32's 165 TFLOP/s, 1.16 ms, bound
// by operations; as H grows, the weight slabs' stream from L2 too, since
// every row block re-reads its rank's slice of [W_ih; W_hh] each step (at
// H = 1,024 the whole 21 MB a step, 16,000 / M times).  What the design
// does about it: more rows a block than kernel 5's phase A holds (no
// gradient tile shares the shared memory) -- one block up to H = 128, then
// kernel 5's clusters of 2, 4 or 8 ranks of at most 128 units
// (f32_cluster), 64 rows a block or rank where its h tile fits (to H =
// 640) and 32 beyond -- so each slab feeds more rows, and fewer rows (to
// 16) where the row blocks would leave SMs idle (the recommenders'
// source, the query encoder); a rank keeps two h tiles, read and written
// in turn, unless one tile lets its slabs be deeper or two do not fit (H =
// 1,024: 32 rows of 4,112 bytes), and then one, which the ranks rewrite
// after a second cluster barrier a step
// (f32_fwd_smem).  E and H are multiples of 32 here, H of 16 C on a
// cluster of C (the wrapper pads).
//
// These launchers hold H up to 1,024 (kMaxClustered) in both dtypes; above
// it kernels 1 and 4 take the step route (`lstm_route` in lstm_mma.cuh;
// cair_lstm_step in lstm_step.cu: the cluster's ranks made independent
// blocks, h through device memory, a launch a time step), whose state needs
// a workspace these launchers do not take.
//
// As in the TPU kernel, h is rounded to the input dtype before the
// recurrent product (`hs.astype(whh_ref.dtype)`); everything else is f32.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"

namespace {

using namespace cair_lstm;

// The tensor-core kernel in both dtypes (see the header note and
// lstm_mma.cuh).  Shared memory: weight ring (mbarriers, slabs, x slots) |
// h tile (two in a cluster, kCl, unless kOne) | bias of the block's units
// (f32).  kOne: a float32 cluster whose ranks keep one h tile, rewritten
// between two cluster barriers a step.
template <typename T, int G, int MT, bool kRes, bool kCl, bool kOne>
__global__ void __launch_bounds__(tiles::kThreads, 1)
lstm_fwd_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                    const T* __restrict__ w_staged, const T* __restrict__ bias,
                    T* __restrict__ out, float* __restrict__ hb,
                    float* __restrict__ cb, int n_rows, int n_steps, int e,
                    int h_dim, int reverse, int tc, int ks) {
  using namespace tiles;
  using E = Elt<T>;
  constexpr int kE = (int)sizeof(T);  // bytes an element
  constexpr bool kF32 = kE == 4;
  // ranks a cluster may have: bf16 lstm_cluster, float32 f32_cluster
  constexpr int kMaxC = kF32 ? kF32MaxRanks : 4;
  constexpr bool kTwo = kCl && !kOne;  // two h tiles in turn
  // kernel 4's f32 h in registers: bf16's staged h is rounded, float32's
  // tile holds it exactly
  constexpr bool kRegH = kRes && !kF32;
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
                           (w_stride(hc, kLstmGates, kE) / kE),
            x, e, h_dim, hc, kLstmGates, ks, n_steps, row0, M, n_rows,
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
  for (int i = threadIdx.x; i < 4 * hc; i += kThreads)
    bias_s[i] = to_f32(bias[(i / hc) * h_dim + u_off + i % hc]);

  float c[MT][G][4];
  float h[kRegH ? MT : 1][kRegH ? G : 1][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[mt][gi][i] = 0.0f;
        if constexpr (kRegH) h[mt][gi][i] = 0.0f;
      }

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
    // kernel 4: the first step of a chunk in processing order records the
    // carried state (the h tile is whole once the step's first h slab is
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
              const size_t at = (base + row0 + r) * h_dim + u_off + unit;
              float2 hv;
              if constexpr (kRegH)
                hv = make_float2(h[mt][gi][half * 2],
                                 h[mt][gi][half * 2 + 1]);
              else
                hv = E::load2(h_cur + r * hs + (u_off + unit) * kE);
              *reinterpret_cast<float2*>(hb + at) = hv;
              *reinterpret_cast<float2*>(cb + at) = make_float2(
                  c[mt][gi][half * 2], c[mt][gi][half * 2 + 1]);
            }
          }
    };

    const int t_next = s + 1 < n_steps ? (reverse ? t - 1 : t + 1) : -1;
    float acc[MT][G][4][4];
    step_gates<kLstmGates, G, MT>(acc, ring, n, t, t_next, h_cur, bias_s, hc,
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
                if constexpr (kRegH) h[mt][gi][i] = h_new;
              }
              hn[u] = m ? h_new : 0.0f;
            }
            const int r = mt * 16 + g + half * 8;
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
int launch_mma(const void* x, const void* mask, const void* w_ih,
               const void* b, void* out, void* hb, void* cb, int n_rows,
               int n_steps, int e, int h_dim, int reverse, int tc, int c,
               int ks, size_t smem, cudaStream_t stream) {
  const int m_rows = 16 * MT;
  return (int)launch_blocks(
      lstm_fwd_mma_kernel<T, G, MT, kRes, kCl, kOne>,
      (n_rows + m_rows - 1) / m_rows, c, tiles::kThreads, smem, stream,
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w_ih), static_cast<const T*>(b),
      static_cast<T*>(out), static_cast<float*>(hb), static_cast<float*>(cb),
      n_rows, n_steps, e, h_dim, reverse, tc, ks);
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

// E and H multiples of 32 (float32: H of 16 C in a cluster of C), H <=
// kMaxClustered, 16-byte aligned pointers, the weights staged (the wrapper
// pads, aligns and stages: one matrix a rank of the cluster); refused
// otherwise.  bf16: lstm_cluster's blocks, pick_config's rows, 16 a rank;
// float32: f32_cluster's, f32_fwd_groups' unit groups, f32_fwd_smem's
// rows and h tiles.
template <bool kRes>
int dispatch(const void* x, const void* mask, const void* w_ih, const void* b,
             void* out, void* hb, void* cb, int n_rows, int n_steps, int e,
             int h_dim, int reverse, int tc, int dtype, void* stream) {
  using namespace tiles;
  if (n_rows == 0 || n_steps == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  const int c = bf16 ? lstm_cluster(h_dim) : f32_cluster(h_dim);
  if (tc <= 0 || e <= 0 || e % kAlign != 0 || h_dim <= 0 ||
      h_dim % kAlign != 0 || c == 0 || (!bf16 && h_dim % (16 * c) != 0) ||
      !aligned16(x) || !aligned16(w_ih) || !aligned16(out) ||
      (kRes && !aligned16(hb)) || (kRes && !aligned16(cb)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int ks = 0, n_tiles = 1;
  if (!bf16) {
    int m_rows = 0;
    const size_t smem =
        f32_fwd_smem(h_dim, kLstmGates, n_rows, &m_rows, &ks, &n_tiles);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    return launch_f32<kRes>(m_rows / 16, f32_fwd_groups(h_dim), c > 1,
                            n_tiles == 1, x, mask, w_ih, b, out, hb, cb,
                            n_rows, n_steps, e, h_dim, reverse, tc, c, ks,
                            smem, s);
  }
  using bf16_t = __nv_bfloat16;
  const Config cfg = c > 1 ? kClusterConfig : pick_config(h_dim);
  const size_t smem =
      mma_smem(h_dim, h_dim / c, kLstmGates, 16 * cfg.mt, false, c, &ks);
  if (smem == 0) return (int)cudaErrorInvalidValue;
#define CAIR_FWD_CASE(G_, MT_, CL_)                                          \
  if (cfg.g == G_)                                                           \
    return launch_mma<bf16_t, G_, MT_, kRes, CL_, false>(                    \
        x, mask, w_ih, b, out, hb, cb, n_rows, n_steps, e, h_dim, reverse,   \
        tc, c, ks, smem, s);
  if (c > 1) {
    CAIR_FWD_CASE(kClusterConfig.g, kClusterConfig.mt, true)
  }
  CAIR_FWD_CASE(1, 4, false)
  CAIR_FWD_CASE(2, 4, false)
  CAIR_FWD_CASE(4, 2, false)
  CAIR_FWD_CASE(8, 1, false)
#undef CAIR_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The float32 forwards' layout at padded hidden size h_dim with `gates`
// gate blocks (4: kernels 1, 4; 3: kernels 7, 8) for n_rows rows: the
// dynamic shared memory of a block or rank (0: refused), its rows, slab
// depth and h tiles (f32_fwd_smem, lstm_mma.cuh), as cair_lstm_fwd and
// cair_gru_fwd launch them.
extern "C" long long cair_f32_fwd_layout(int h_dim, int gates, int n_rows,
                                         int* rows, int* ks, int* tiles) {
  *rows = *ks = *tiles = 0;
  if (h_dim <= 0 || h_dim % tiles::kAlign != 0 || n_rows <= 0 ||
      (gates != tiles::kLstmGates && gates != tiles::kGruGates))
    return 0;
  const int c = f32_cluster(h_dim);
  if (c == 0 || h_dim % (16 * c) != 0) return 0;
  return (long long)tiles::f32_fwd_smem(h_dim, gates, n_rows, rows, ks,
                                        tiles);
}

// Kernel 1.  x [B, T, E], mask uint8 [B, T], b [4H], out [B, T, H]; all
// contiguous, one dtype (0 = float32, 1 = bfloat16); H up to 1,024 (above
// it: cair_lstm_step).  `w_staged` is [W_ih; W_hh] staged (W_ih [E, 4H]
// over W_hh [H, 4H], 8 zero columns a row): one matrix [E + H, 4H + 8] in
// one block, or C matrices [E + H, 4H/C + 8] on a cluster of C (bf16 C =
// lstm_cluster(H) above H = 384, float32 C = f32_cluster(H) above 128),
// rank r's holding the gate columns of units r*H/C .. (r+1)*H/C - 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cair_lstm_fwd(const void* x, const void* mask,
                             const void* w_staged, const void* b, void* out,
                             int n_rows, int n_steps, int e, int h_dim,
                             int reverse, int dtype, void* stream) {
  return dispatch<false>(x, mask, w_staged, b, out, nullptr, nullptr, n_rows,
                         n_steps, e, h_dim, reverse, n_steps, dtype, stream);
}

// Kernel 4: kernel 1 plus hb, cb float32 [ceil(T / tc), B, H], the carried
// (h, c) before each time chunk of tc steps in processing order.
extern "C" int cair_lstm_fwd_res(const void* x, const void* mask,
                                 const void* w_staged, const void* b,
                                 void* out, void* hb, void* cb, int n_rows,
                                 int n_steps, int e, int h_dim, int reverse,
                                 int tc, int dtype, void* stream) {
  return dispatch<true>(x, mask, w_staged, b, out, hb, cb, n_rows, n_steps,
                        e, h_dim, reverse, tc, dtype, stream);
}
