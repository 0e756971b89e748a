// The step route of the recurrent kernels for Hopper (sm_90a): the LSTM's
// kernels 1, 4 and 5 above H = 1,024 and kernel 6 above H = 512, and the
// GRU's kernels 7, 8 and 9 above H = 1,024, in both dtypes.
//
// These are the TPU kernels of lstm_fwd.cu, lstm_bwd.cu, lstm_rec.cu,
// gru_fwd.cu and gru_bwd.cu (`_lstm_fused_kernel`,
// `_lstm_fused_res_kernel`, `_lstm_fused_bwd_kernel` and `_lstm_kernel` in
// context_attentive_ir_tpu/ops/pallas/lstm.py; `_gru_fused_kernel`,
// `_gru_fused_res_kernel` and `_gru_fused_bwd_kernel` in
// context_attentive_ir_tpu/ops/pallas/gru.py) at the hidden sizes the JAX
// kernels take (any H for the fused LSTM kernels, any multiple of 128 for
// `_lstm_kernel` and the GRU's) and the cluster layout cannot hold: a rank
// of a cluster stages all H units of h beside its weight ring, so its
// shared memory grows with H and no cluster holds H = 3,072.
//
// What bounds it on the H100: at the doc encoder's [16000, 30, 256] ->
// 2,048 in bf16 kernel 1 does 2*B*T*(E+H)*4H = 1.81e13 flops (18.3 ms at
// 989 TFLOP/s), kernel 7 three quarters of that, kernels 5 and 9 three
// times their forwards; at the recommenders' source [64, 150, 256] ->
// 4,096 the 142.6 MB of staged LSTM weights, which no cache holds, are read
// every step (6.4 ms at 3.35 TB/s).
//
// Design: the cluster algorithm with its ranks made independent, for NG
// gate blocks (the LSTM's four, the GRU's three; lstm_mma.cuh's tiles take
// either).  A block owns a row tile and a unit tile -- bf16:
// kClusterConfig's 16 rows and kStepUnits = 256 units (lstm_mma.cuh's
// tiles); float32: 32 rows and kF32Units = 128 units, thread (rg, j) owning
// unit j of 16 rows with exact f32 FMAs -- and computes every gate of its
// units.  h goes through device memory instead of distributed shared
// memory, read and written in turn ([2, rows, H], in the compute dtype),
// and each time step is one launch: the launch boundary orders one step's
// h writes before the next step's reads, with no grid-wide barrier.  A
// step's k-sum [x_t | h_{t-1}] @ [W_ih; W_hh] runs slab by slab in
// ascending k: bf16 through the weight ring of the tile's staged matrix
// (stage_lstm_weights(w_ih, w_hh, H / U, NG)) with x_t and h_{t-1} both
// streamed through the x slots -- the GRU's n columns of an x slab into
// its xn slot and of an h slab into hn, as a cluster's ranks sum them;
// float32 in chunks of kF32Chunk k-rows staged k-major, the weights read
// through L2 (the GRU's x @ W_ih and h @ W_hh apart).  The cell update runs
// on the thread's own (row, unit) cells: the LSTM's c read from and written
// to an f32 state [rows, H]; the GRU's h carried in f32 (z * h reads it, as
// on the TPU), bf16 in a state [rows, H] of its own beside the rounded
// buffers; masked steps carry the state and write zeros.  A unit past H
// (bf16's zero padding) has zero weights and biases, so its state stays
// exactly 0 (the GRU's: r = z = 1/2, n = 0).  No shared memory grows with
// E or H (step_smem).
//
// Kernels 4 and 8 copy the state at each chunk's first step out into hb
// (and the LSTM's cb).  Kernel 6 is the step kernel with E = 0, its
// accumulators started from the x_proj columns of its units (kernel 1's
// bias in that role).  Phase A of kernels 5 and 9 recomputes each chunk
// from its boundary with the step kernel, which keeps each cell's f32
// planes (kStepSaved: i, f, g, o, c_prev, c_new; kGruStepSaved: h_prev, r,
// z, n, hn = h_{t-1} @ W_hn + b_hn) and h_{t-1} for phase B, then runs the
// reverse pass a step at a time: an elementwise kernel computes the f32
// gradient slots of each cell from the planes, dout and the carried state
// (the LSTM's dh, dc; the GRU's dh and dh' z), rounds them to the compute
// dtype for phase B, and sums them into per-row-group db partials; then a
// product kernel gives each unit tile's partial of dh_{t-1} over every unit
// -- the LSTM's dgates_c @ W_hh^T, the GRU's slots {da_r, da_z, da_n * r}
// @ W_hh^T -- (bf16: the same staged slabs read untransposed through
// `ldmatrix`, as a cluster's reverse pass reads them; float32: exact FMAs
// against W_hh^T), and the next step adds the tiles' partials in tile order
// (the GRU's then dh' z).  Phases B and C (lstm_bwd.cu, gru_bwd.cu,
// lstm_common.cuh) run over all B*T rows as for a cluster.  No atomics and
// a fixed order: the gradients are the same bits every run.
//
// Launches: T a forward; about 3T a backward.  A persistent kernel that
// keeps its weights across steps is speed work for a later change.

#include "lstm_common.cuh"
#include "lstm_mma.cuh"
#include "lstm_step.cuh"

namespace {

using namespace cair_lstm;

// what a step kernel writes: kernel 1's (7's) output, kernel 4's (8's)
// output and boundaries, kernel 5's (9's) recompute planes and h_prev,
// kernel 6's output
enum StepMode { kFwd = 0, kRes = 1, kRecompute = 2, kRec = 3 };

__device__ __forceinline__ bool first_in_chunk(int t, int n_steps, int tc,
                                               int reverse) {
  return reverse ? (t == n_steps - 1 || (t + 1) % tc == 0) : t % tc == 0;
}

// The state a run starts from: h (in T) and, where given, the LSTM's c
// from the f32 boundaries `hb`, `cb` ([rows, H] each), or zeros without
// them; `h32` (if any) the f32 h.
template <typename T>
__global__ void step_init_kernel(const float* __restrict__ hb,
                                 const float* __restrict__ cb,
                                 T* __restrict__ h, float* __restrict__ c,
                                 float* __restrict__ h32, size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    const float hv = hb ? hb[i] : 0.0f;
    h[i] = from_f32<T>(hv);
    if (c) c[i] = cb ? cb[i] : 0.0f;
    if (h32) h32[i] = hv;
  }
}

// One time step t of a row tile (blockIdx.x) and a unit tile (blockIdx.y)
// on bf16 tensor cores, NG gate blocks (see the header note).  The GRU
// (NG = 3): `bias` is b_ih, `h32` the carried f32 h, `c_state` unused.
// Shared memory (step_smem): weight ring (mbarriers, slabs, x slots) |
// bias slots of the tile's units (f32: the LSTM's four gates; the GRU's r,
// z from b_ih + b_hh, xn from b_ih_n, hn from b_hh_n).
template <int NG, int kMode>
__global__ void __launch_bounds__(tiles::kThreads, 1)
step_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ mask,
                const __nv_bfloat16* __restrict__ w_staged,
                const __nv_bfloat16* __restrict__ bias,
                const __nv_bfloat16* __restrict__ b_hh,
                const __nv_bfloat16* __restrict__ h_cur,
                __nv_bfloat16* __restrict__ h_next,
                float* __restrict__ c_state, float* __restrict__ h32,
                __nv_bfloat16* __restrict__ out, float* __restrict__ hb,
                float* __restrict__ cb, float* __restrict__ act,
                __nv_bfloat16* __restrict__ h_prev_ws, int n_rows,
                int n_steps, int e, int h_dim, int t, int tc, int reverse,
                int ks) {
  using namespace tiles;
  constexpr bool kGru = NG == kGruGates;
  constexpr int G = kClusterConfig.g, MT = kClusterConfig.mt, M = 16 * MT;
  constexpr int U = kStepUnits;
  extern __shared__ __align__(16) char smem[];
  const int u_off = blockIdx.y * U;
  const int row0 = blockIdx.x * M;
  WeightRing ring;
  ring.init(smem,
            w_staged + (size_t)blockIdx.y * (e + h_dim) * (w_stride(U, NG) / 2),
            x, e, h_dim, U, NG, ks, 1, row0, M, n_rows, n_steps);
  ring.hx = h_cur;
  float* bias_s = reinterpret_cast<float*>(ring.end());
  if constexpr (kGru) {
    for (int i = threadIdx.x; i < U; i += kThreads) {
      const int u = u_off + i;
#pragma unroll
      for (int q = 0; q < 2; ++q)  // r, z: both biases
        bias_s[q * U + i] = __bfloat162float(bias[q * h_dim + u]) +
                            __bfloat162float(b_hh[q * h_dim + u]);
      bias_s[2 * U + i] = __bfloat162float(bias[2 * h_dim + u]);  // xn
      bias_s[3 * U + i] = __bfloat162float(b_hh[2 * h_dim + u]);  // hn
    }
  } else if constexpr (kMode != kRec) {
    for (int i = threadIdx.x; i < 4 * U; i += kThreads)
      bias_s[i] = __bfloat162float(bias[(i / U) * h_dim + u_off + i % U]);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ug0 = warp * G;
  ring.prologue(t);
  __syncthreads();  // bias_s

  // slot q of a thread's fragment at (row, unit) is gate q of that cell
  // (the GRU's r, z, xn, hn): it starts from the bias, or kernel 6's x_proj
  float acc[MT][G][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int unit = (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2 v;
          if constexpr (kMode == kRec) {
            const int row = row0 + mt * 16 + g + half * 8;
            v = row < n_rows
                    ? __bfloat1622float2(*reinterpret_cast<const bf162*>(
                          x + ((size_t)row * n_steps + t) * 4 * h_dim +
                          q * h_dim + u_off + unit))
                    : make_float2(0.0f, 0.0f);
          } else {
            v = make_float2(bias_s[q * U + unit], bias_s[q * U + unit + 1]);
          }
          acc[mt][gi][q][half * 2] = v.x;
          acc[mt][gi][q][half * 2 + 1] = v.y;
        }
    }
  // [x_t | h_{t-1}] @ the tile's [W_ih; W_hh] columns, slab by slab (the
  // GRU's n columns of an h slab into hn)
  int n = 0;
  for (int sl = 0; sl < ring.n_slabs; ++sl, ++n) {
    const char* slab = ring.acquire(n, sl, t, t);
    cp_async_commit();
    if (kGru && sl * ks >= e)
      slab_gates<NG, G, MT, true>(acc, ring.x_slab(n), xslot_stride(ks), 0,
                                  slab, ring.ws, ks, U, ug0, lane);
    else
      slab_gates<NG, G, MT, false>(acc, ring.x_slab(n), xslot_stride(ks), 0,
                                   slab, ring.ws, ks, U, ug0, lane);
  }

  // cell update; masked steps carry the state and write zeros
  const bool first = first_in_chunk(t, n_steps, tc, reverse);
  const size_t plane = (size_t)n_rows * h_dim;
  constexpr int kPl = kGru ? kGruStepSaved : kStepSaved;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int col = u_off + (ug0 + gi) * 8 + 2 * tg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mt * 16 + g + half * 8;
        if (row >= n_rows) continue;
        const size_t at = (size_t)row * h_dim + col;
        const size_t pos = (size_t)row * n_steps + t;
        const bool m = mask[pos] != 0;
        const bf162 hold = *reinterpret_cast<const bf162*>(h_cur + at);
        // the carried state the step reads: the LSTM's c, the GRU's f32 h
        const float2 sp = *reinterpret_cast<const float2*>(
            (kGru ? h32 : c_state) + at);
        const float s_prev[2] = {sp.x, sp.y};
        float hn[2], sn[2], pl[kPl][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = half * 2 + u;
          if constexpr (kGru) {
            const float rg = sigmoid_f32(acc[mt][gi][0][i]);
            const float zg = sigmoid_f32(acc[mt][gi][1][i]);
            const float ng =
                tanhf(acc[mt][gi][2][i] + rg * acc[mt][gi][3][i]);
            hn[u] = (1.0f - zg) * ng + zg * s_prev[u];
            sn[u] = m ? hn[u] : s_prev[u];
            pl[0][u] = s_prev[u];
            pl[1][u] = rg;
            pl[2][u] = zg;
            pl[3][u] = ng;
            pl[4][u] = acc[mt][gi][3][i];
          } else {
            const float ig = sigmoid_f32(acc[mt][gi][0][i]);
            const float fg = sigmoid_f32(acc[mt][gi][1][i]);
            const float gg = tanhf(acc[mt][gi][2][i]);
            const float og = sigmoid_f32(acc[mt][gi][3][i]);
            const float c_new = fg * s_prev[u] + ig * gg;
            hn[u] = og * tanhf(c_new);
            sn[u] = m ? c_new : s_prev[u];
            pl[0][u] = ig;
            pl[1][u] = fg;
            pl[2][u] = gg;
            pl[3][u] = og;
            pl[4][u] = s_prev[u];
            pl[5][u] = c_new;
          }
        }
        *reinterpret_cast<float2*>((kGru ? h32 : c_state) + at) =
            make_float2(sn[0], sn[1]);
        const bf162 v = __floats2bfloat162_rn(hn[0], hn[1]);
        *reinterpret_cast<bf162*>(h_next + at) = m ? v : hold;
        if constexpr (kMode != kRecompute)
          *reinterpret_cast<bf162*>(out + pos * h_dim + col) =
              m ? v : __floats2bfloat162_rn(0.0f, 0.0f);
        if constexpr (kMode == kRes) {
          // the state before a chunk's first step, copied out (the LSTM's
          // f32 h from its own copy, kept beside the rounded buffers)
          const size_t bt = ((size_t)(t / tc) * n_rows + row) * h_dim + col;
          if constexpr (kGru) {
            if (first) *reinterpret_cast<float2*>(hb + bt) = sp;
          } else {
            const float2 hp = *reinterpret_cast<const float2*>(h32 + at);
            if (first) {
              *reinterpret_cast<float2*>(hb + bt) = hp;
              *reinterpret_cast<float2*>(cb + bt) = sp;
            }
            *reinterpret_cast<float2*>(h32 + at) =
                m ? make_float2(hn[0], hn[1]) : hp;
          }
        }
        if constexpr (kMode == kRecompute) {
#pragma unroll
          for (int p = 0; p < kPl; ++p)
            *reinterpret_cast<float2*>(act + p * plane + at) =
                make_float2(pl[p][0], pl[p][1]);
          *reinterpret_cast<bf162*>(h_prev_ws + pos * h_dim + col) = hold;
        }
      }
    }
}

// One time step t of a row tile (blockIdx.x, kRows rows) and a unit tile
// (blockIdx.y, kF32Units units) in float32: thread (rg, j) owns unit j of
// rows rg*16 .. rg*16+15, exact f32 FMAs in k order over x_t's chunks, then
// h_{t-1}'s (the GRU's into separate sums, each from its bias, as its
// clusters take them).  The GRU (NG = 3): `bias` is b_ih.  Shared memory:
// one chunk [kF32Chunk][kStride] f32.
template <int NG, int kMode>
__global__ void __launch_bounds__(kRowGroups * kF32Units)
step_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                const float* __restrict__ w_ih,
                const float* __restrict__ bias,
                const float* __restrict__ b_hh,
                const float* __restrict__ w_hh,
                const float* __restrict__ h_cur, float* __restrict__ h_next,
                float* __restrict__ c_state, float* __restrict__ out,
                float* __restrict__ hb, float* __restrict__ cb,
                float* __restrict__ act, float* __restrict__ h_prev_ws,
                int n_rows, int n_steps, int e, int h_dim, int t, int tc,
                int reverse) {
  constexpr bool kGru = NG == tiles::kGruGates;
  extern __shared__ float4 smem4[];
  float* xt = reinterpret_cast<float*>(smem4);
  const int j = threadIdx.x % kF32Units;
  const int rg = threadIdx.x / kF32Units;
  const int unit = blockIdx.y * kF32Units + j;
  const bool active = unit < h_dim;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = row0 + rg * kRowsPerThread;
  const int gn = NG * h_dim;

  // acc: the LSTM's four gates; the GRU's x @ W_ih + b_ih (r, z, n), then
  // in accr the h @ W_hh + b_hh
  float acc[NG][kRowsPerThread], accr[kGru ? 3 : 1][kRowsPerThread];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float bg = kMode != kRec && active ? bias[g * h_dim + unit] : 0.0f;
    const float bh = kGru && active ? b_hh[g * h_dim + unit] : 0.0f;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = my_row0 + i;
      acc[g][i] = kMode != kRec ? bg
                  : active && row < n_rows
                      ? x[((size_t)row * n_steps + t) * gn + g * h_dim + unit]
                      : 0.0f;
      if constexpr (kGru) accr[g][i] = bh;
    }
  }
  for (int k0 = 0; k0 < e; k0 += kF32Chunk) {
    const int kn = e - k0 < kF32Chunk ? e - k0 : kF32Chunk;
    stage_x_chunk<float>(xt, x, row0, n_rows, n_steps, t, e, k0, kn);
    if (active)
      dot_rows<NG, float>(acc, xt, 0, rg, w_ih + (size_t)k0 * gn + unit, kn,
                          gn, h_dim);
    __syncthreads();  // the next chunk overwrites xt
  }
  for (int k0 = 0; k0 < h_dim; k0 += kF32Chunk) {
    const int kn = h_dim - k0 < kF32Chunk ? h_dim - k0 : kF32Chunk;
    stage_x_chunk<float>(xt, h_cur, row0, n_rows, 1, 0, h_dim, k0, kn);
    if (active) {
      const float* w = w_hh + (size_t)k0 * gn + unit;
      if constexpr (kGru)
        dot_rows<NG, float>(accr, xt, 0, rg, w, kn, gn, h_dim);
      else
        dot_rows<NG, float>(acc, xt, 0, rg, w, kn, gn, h_dim);
    }
    __syncthreads();
  }
  if (!active) return;

  // cell update; masked steps carry the state and write zeros
  const bool first = first_in_chunk(t, n_steps, tc, reverse);
  const size_t plane = (size_t)n_rows * h_dim;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = my_row0 + i;
    if (row >= n_rows) continue;
    const size_t at = (size_t)row * h_dim + unit;
    const size_t pos = (size_t)row * n_steps + t;
    const bool m = mask[pos] != 0;
    const float h_prev = h_cur[at];
    float h_new;
    if constexpr (kGru) {
      const float rg_ = sigmoid_f32(acc[0][i] + accr[0][i]);
      const float zg = sigmoid_f32(acc[1][i] + accr[1][i]);
      const float ng = tanhf(acc[2][i] + rg_ * accr[2][i]);
      h_new = (1.0f - zg) * ng + zg * h_prev;
      if constexpr (kMode == kRecompute) {
        act[at] = h_prev;
        act[plane + at] = rg_;
        act[2 * plane + at] = zg;
        act[3 * plane + at] = ng;
        act[4 * plane + at] = accr[2][i];
      }
    } else {
      const float c_prev = c_state[at];
      const float ig = sigmoid_f32(acc[0][i]);
      const float fg = sigmoid_f32(acc[1][i]);
      const float gg = tanhf(acc[2][i]);
      const float og = sigmoid_f32(acc[3][i]);
      const float c_new = fg * c_prev + ig * gg;
      h_new = og * tanhf(c_new);
      c_state[at] = m ? c_new : c_prev;
      if constexpr (kMode == kRes) {
        if (first) cb[((size_t)(t / tc) * n_rows + row) * h_dim + unit] = c_prev;
      }
      if constexpr (kMode == kRecompute) {
        act[at] = ig;
        act[plane + at] = fg;
        act[2 * plane + at] = gg;
        act[3 * plane + at] = og;
        act[4 * plane + at] = c_prev;
        act[5 * plane + at] = c_new;
      }
    }
    h_next[at] = m ? h_new : h_prev;
    if constexpr (kMode != kRecompute) out[pos * h_dim + unit] = m ? h_new : 0.0f;
    if constexpr (kMode == kRes) {
      if (first) hb[((size_t)(t / tc) * n_rows + row) * h_dim + unit] = h_prev;
    }
    if constexpr (kMode == kRecompute) h_prev_ws[pos * h_dim + unit] = h_prev;
  }
}

// The reverse pass's step t for kDgRows rows (blockIdx.y) of unit u: dh is
// the previous step's (t_prev; -1: none, the run's first) tiles' partials
// added in tile order (the GRU's then dh' z of that step) where that step
// was unmasked, else the carried dh; then the f32 gradient slots of the
// cell from its planes -- the LSTM's four dgates, the GRU's [da_r, da_z,
// da_n, da_n * r] --, rounded to T into phase B's operand, and summed over
// the rows, in row order, into the row group's db partial (written at the
// run's first step, else added).  `dc_st` carries the LSTM's dc, the GRU's
// dh' z.
template <typename T, int NG>
__global__ void __launch_bounds__(256)
step_dgates_kernel(const uint8_t* __restrict__ mask,
                   const float* __restrict__ act, const T* __restrict__ dout,
                   const float* __restrict__ partial, int n_tiles,
                   float* __restrict__ dh_st, float* __restrict__ dc_st,
                   T* __restrict__ dgates, float* __restrict__ db_part,
                   int n_rows, int n_steps, int h_dim, int t, int t_prev) {
  constexpr bool kGru = NG == tiles::kGruGates;
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= h_dim) return;
  const size_t plane = (size_t)n_rows * h_dim;
  const int g4 = 4 * h_dim;
  float dbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < kDgRows; ++i) {
    const int row = blockIdx.y * kDgRows + i;
    if (row >= n_rows) break;
    const size_t at = (size_t)row * h_dim + u;
    float dh = 0.0f, dc = 0.0f;
    if (t_prev >= 0) {
      if (mask[(size_t)row * n_steps + t_prev] != 0) {
        dh = partial[at];
        for (int q = 1; q < n_tiles; ++q) dh += partial[q * plane + at];
        if constexpr (kGru) dh += dc_st[at];
      } else {
        dh = dh_st[at];
      }
      if constexpr (!kGru) dc = dc_st[at];
    }
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const size_t pos = (size_t)row * n_steps + t;
    if (mask[pos] != 0) {
      const float dh_new = to_f32(dout[pos * h_dim + u]) + dh;
      if constexpr (kGru) {
        const float hp = act[at], rg = act[plane + at];
        const float zg = act[2 * plane + at], ng = act[3 * plane + at];
        const float hn = act[4 * plane + at];
        const float dz = dh_new * (hp - ng);
        const float da_n = dh_new * (1.0f - zg) * (1.0f - ng * ng);
        d[0] = da_n * hn * rg * (1.0f - rg);
        d[1] = dz * zg * (1.0f - zg);
        d[2] = da_n;
        d[3] = da_n * rg;
        dc = dh_new * zg;
      } else {
        const float ig = act[at], fg = act[plane + at];
        const float gg = act[2 * plane + at], og = act[3 * plane + at];
        const float c_prev = act[4 * plane + at], c_new = act[5 * plane + at];
        const float tanh_c = tanhf(c_new);
        const float do_ = dh_new * tanh_c;
        const float dcn = dc + dh_new * og * (1.0f - tanh_c * tanh_c);
        d[0] = dcn * gg * ig * (1.0f - ig);
        d[1] = dcn * c_prev * fg * (1.0f - fg);
        d[2] = dcn * ig * (1.0f - gg * gg);
        d[3] = do_ * og * (1.0f - og);
        dc = dcn * fg;
      }
    }
    dh_st[at] = dh;
    dc_st[at] = dc;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dgates[pos * g4 + q * h_dim + u] = from_f32<T>(d[q]);
      dbs[q] += d[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float* p = db_part + (size_t)blockIdx.y * g4 + q * h_dim + u;
    *p = t_prev < 0 ? dbs[q] : *p + dbs[q];
  }
}

// The dh partial of unit tile blockIdx.y at step t for a row tile
// (blockIdx.x) on bf16 tensor cores: the tile's four gradient slots (U
// columns each, staged as the tile's staged weights order its gates) times
// its staged W_hh rows read untransposed (a slab's ks rows are ks output
// columns; a warp takes 16 rows x 16 columns), into partial[tile][rows, H]
// f32.  The k extent is the NG gate blocks of the slabs; the GRU's third
// block (the n gate) takes slot 3 (da_n * r) in slot 2's place.  Shared
// memory (step_smem): weight ring (mbarriers, slabs, unused x slots) | the
// slots tile.
template <int NG>
__global__ void __launch_bounds__(tiles::kThreads, 1)
step_dh_mma_kernel(const __nv_bfloat16* __restrict__ w_staged,
                   const __nv_bfloat16* __restrict__ dgates,
                   float* __restrict__ partial, int n_rows, int n_steps,
                   int e, int h_dim, int t, int ks) {
  using namespace tiles;
  constexpr int MT = kClusterConfig.mt, M = 16 * MT, U = kStepUnits;
  extern __shared__ __align__(16) char smem[];
  const int u_off = blockIdx.y * U;
  const int row0 = blockIdx.x * M;
  const int ws = w_stride(U, NG), ss = slot_stride(U);
  const int g4 = 4 * h_dim, gc = NG * U;
  WeightRing ring;
  ring.init(smem, w_staged + (size_t)blockIdx.y * (e + h_dim) * (ws / 2),
            nullptr, e, h_dim, U, NG, ks, 0, row0, M, n_rows, n_steps, 1);
  char* dg_tile = ring.end();
  // row r's slot q columns at q*U of the tile; rows past n_rows zero
  constexpr int kCpr = 4 * U / 8;  // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < M * kCpr; idx += kThreads) {
    const int r = idx / kCpr, c = idx - r * kCpr;
    const int q = c / (U / 8), cc = c - q * (U / 8);
    const bool valid = row0 + r < n_rows;
    cp_async16(dg_tile + r * ss + c * 16,
               valid ? dgates + ((size_t)(row0 + r) * n_steps + t) * g4 +
                           q * h_dim + u_off + cc * 8
                     : dgates,
               valid);
  }
  ring.prologue(kHOnly);  // the tile's copies ride in the first group

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
  int n = 0;
  for (int sl = ring.first_slab(kHOnly); sl < ring.n_slabs; ++sl, ++n) {
    const char* slab = ring.acquire(n, sl, kHOnly, kHOnly);
    cp_async_commit();
    const int col0 = sl * ks - e;
    for (int wu = warp; wu < MT * (ks / 16); wu += kWarps) {
      const int mt = wu % MT, np = wu / MT;
      float o[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[jj][i] = 0.0f;
      const char* a_base =
          dg_tile + (mt * 16 + (lane & 15)) * ss + (lane >> 4) * 16;
      const char* b_base = slab + (np * 16 + b_n) * ws + b_k * 2;
#pragma unroll 4
      for (int kk = 0; kk < gc; kk += 16) {
        const int ka = NG == kGruGates && kk >= 2 * U ? kk + U : kk;
        uint32_t af[4], bfr[4];
        ldsm_x4(af, a_base + ka * 2);
        ldsm_x4(bfr, b_base + kk * 2);
        mma_bf16(o[0], af, bfr[0], bfr[1]);
        mma_bf16(o[1], af, bfr[2], bfr[3]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + mt * 16 + g + half * 8;
          const int col = col0 + np * 16 + jj * 8 + 2 * tg;
          if (row < n_rows)
            *reinterpret_cast<float2*>(
                partial + ((size_t)blockIdx.y * n_rows + row) * h_dim + col) =
                make_float2(o[jj][half * 2], o[jj][half * 2 + 1]);
        }
    }
  }
}

// The dh partial of unit tile blockIdx.z at step t in float32: output
// columns blockIdx.y * kF32Units + j of a row tile (blockIdx.x, kRows rows),
// exact f32 FMAs over the tile's NG gate blocks' units in order (a cluster
// rank's product in lstm_bwd.cu, gru_bwd.cu; the GRU's n block from slot 3,
// da_n * r).  Shared memory: the tile's slots [NG kF32Units][kStride] f32,
// k-major.
template <int NG>
__global__ void __launch_bounds__(kRowGroups * kF32Units)
step_dh_f32_kernel(const float* __restrict__ dgates,
                   const float* __restrict__ w_hh_t,
                   float* __restrict__ partial, int n_rows, int n_steps,
                   int h_dim, int t) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  constexpr int K = NG * kF32Units;
  const int j = threadIdx.x % kF32Units;
  const int rg = threadIdx.x / kF32Units;
  const int col = blockIdx.y * kF32Units + j;
  const int u0 = blockIdx.z * kF32Units;
  const int own = min(kF32Units, h_dim - u0);
  const int row0 = blockIdx.x * kRows;
  const int g4 = 4 * h_dim;
  for (int idx = threadIdx.x; idx < kRows * K; idx += blockDim.x) {
    const int r = idx / K, k = idx - r * K;
    const int q = k / kF32Units, u = k - q * kF32Units;
    const int slot = NG == tiles::kGruGates && q == 2 ? 3 : q;
    const int row = row0 + r;
    tile[(size_t)k * kStride + r] =
        row < n_rows && u < own
            ? dgates[((size_t)row * n_steps + t) * g4 + slot * h_dim + u0 +
                     u]
            : 0.0f;
  }
  __syncthreads();
  if (col >= h_dim) return;
  float acc[1][kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[0][i] = 0.0f;
#pragma unroll
  for (int q = 0; q < NG; ++q)
    dot_rows<1, float>(acc, tile, q * kF32Units, rg,
                       w_hh_t + ((size_t)q * h_dim + u0) * h_dim + col, own,
                       h_dim, 0);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + rg * kRowsPerThread + i;
    if (row < n_rows)
      partial[((size_t)blockIdx.z * n_rows + row) * h_dim + col] = acc[0][i];
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // clear it for the next launch
  return err;
}

template <typename T>
cudaError_t launch_init(const float* hb, const float* cb, void* h, float* c,
                        float* h32, size_t count, cudaStream_t stream) {
  const size_t blocks = (count + 255) / 256;
  step_init_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                        stream>>>(hb, cb, static_cast<T*>(h), c, h32, count);
  return cudaGetLastError();
}

// The operands of a step: the input, its mask, the weights (bf16: the
// staged tiles in w_ih) and biases (the GRU's b_ih in b).
struct StepIn {
  const void* x;
  const void* mask;
  const void* w_ih;
  const void* b;
  const void* b_hh;
  const void* w_hh;
};

// Where a step kernel reads and writes one step.
struct StepIo {
  const void* h_cur;
  void* h_next;
  float* c;
  float* h32;
  void* out;
  float* hb;
  float* cb;
  float* act;
  void* h_prev;
};

template <int NG, int kMode>
cudaError_t launch_step(int dtype, const StepIn& in, const StepIo& io,
                        int n_rows, int n_steps, int e, int h_dim, int t,
                        int tc, int reverse, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int tiles_u = step_unit_tiles(h_dim, dtype);
  const uint8_t* mask = static_cast<const uint8_t*>(in.mask);
  if (dtype == 1) {
    int ks = 0;
    const size_t smem = tiles::step_smem(false, NG, &ks);
    const int m_rows = 16 * tiles::kClusterConfig.mt;
    auto* kernel = step_mma_kernel<NG, kMode>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((n_rows + m_rows - 1) / m_rows, tiles_u), tiles::kThreads,
             smem, stream>>>(
        static_cast<const bf16*>(in.x), mask,
        static_cast<const bf16*>(in.w_ih), static_cast<const bf16*>(in.b),
        static_cast<const bf16*>(in.b_hh), static_cast<const bf16*>(io.h_cur),
        static_cast<bf16*>(io.h_next), io.c, io.h32,
        static_cast<bf16*>(io.out), io.hb, io.cb, io.act,
        static_cast<bf16*>(io.h_prev), n_rows, n_steps, e, h_dim, t, tc,
        reverse, ks);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)kF32Chunk * kStride * sizeof(float);
  step_f32_kernel<NG, kMode>
      <<<dim3((n_rows + kRows - 1) / kRows, tiles_u), kRowGroups * kF32Units,
         smem, stream>>>(
          static_cast<const float*>(in.x), mask,
          static_cast<const float*>(in.w_ih), static_cast<const float*>(in.b),
          static_cast<const float*>(in.b_hh),
          static_cast<const float*>(in.w_hh),
          static_cast<const float*>(io.h_cur),
          static_cast<float*>(io.h_next), io.c, static_cast<float*>(io.out),
          io.hb, io.cb, io.act, static_cast<float*>(io.h_prev), n_rows,
          n_steps, e, h_dim, t, tc, reverse);
  return cudaGetLastError();
}

template <int NG>
int forward(const StepIn& in, void* out, void* hb, void* cb, void* workspace,
            int n_rows, int n_steps, int e, int h_dim, int reverse, int tc,
            bool res, bool rec, int dtype, cudaStream_t stream) {
  constexpr bool kGru = NG == tiles::kGruGates;
  const StepState L = step_state(n_rows, h_dim, dtype, NG);
  char* ws = static_cast<char*>(workspace);
  const size_t plane = (size_t)n_rows * h_dim;
  const size_t elt = dtype == 1 ? 2 : 4;
  void* hbuf[2] = {ws + L.hbuf, ws + L.hbuf + plane * elt};
  float* c = kGru ? nullptr : reinterpret_cast<float*>(ws + L.c);
  // bf16's f32 h: the GRU's carried state, the LSTM's kernel 4 boundaries
  float* h32 = dtype == 1 && (kGru || res)
                   ? reinterpret_cast<float*>(ws + L.h32)
                   : nullptr;
  cudaError_t err =
      dtype == 1
          ? launch_init<__nv_bfloat16>(nullptr, nullptr, hbuf[0], c, h32,
                                       plane, stream)
          : launch_init<float>(nullptr, nullptr, hbuf[0], c, nullptr, plane,
                               stream);
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    // (float32: the h buffers hold the f32 h the boundaries copy out)
    const StepIo io = {hbuf[s & 1], hbuf[(s + 1) & 1], c, h32, out,
                       static_cast<float*>(hb), static_cast<float*>(cb),
                       nullptr, nullptr};
    if constexpr (!kGru) {
      if (rec) {
        err = launch_step<NG, kRec>(dtype, in, io, n_rows, n_steps, e, h_dim,
                                    t, tc, reverse, stream);
        if (err != cudaSuccess) return (int)err;
        continue;
      }
    }
    if (res)
      err = launch_step<NG, kRes>(dtype, in, io, n_rows, n_steps, e, h_dim,
                                  t, tc, reverse, stream);
    else
      err = launch_step<NG, kFwd>(dtype, in, io, n_rows, n_steps, e, h_dim,
                                  t, tc, reverse, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, int NG>
int phase_a(const StepIn& in, const void* w_hh_t, const void* hb,
            const void* cb, const void* dout, const StepBwd& ws, int n_rows,
            int n_steps, int e, int h_dim, int reverse, int tc, int dtype,
            cudaStream_t stream) {
  constexpr bool kGru = NG == tiles::kGruGates;
  const size_t plane = (size_t)n_rows * h_dim;
  const size_t elt = sizeof(T);
  const int n_chunks = (n_steps + tc - 1) / tc;
  const int tiles_u = step_unit_tiles(h_dim, dtype);
  const int saved = step_planes(NG);
  char* hbuf[2] = {static_cast<char*>(ws.hbuf),
                   static_cast<char*>(ws.hbuf) + plane * elt};
  int ks_bwd = 0;
  const size_t smem_bwd = tiles::step_smem(true, NG, &ks_bwd);
  const size_t smem_f32 = (size_t)NG * kF32Units * kStride * sizeof(float);
  cudaError_t err = dtype == 1 ? set_smem(step_dh_mma_kernel<NG>, smem_bwd)
                               : set_smem(step_dh_f32_kernel<NG>, smem_f32);
  if (err != cudaSuccess) return (int)err;
  const int row_groups = (n_rows + kDgRows - 1) / kDgRows;
  int t_prev = -1;
  for (int q = 0; q < n_chunks; ++q) {
    // chunks in the reverse of the forward's processing order
    const int chunk = reverse ? q : n_chunks - 1 - q;
    const int t_lo = chunk * tc;
    const int len = min(tc, n_steps - t_lo);
    err = launch_init<T>(static_cast<const float*>(hb) + chunk * plane,
                         kGru ? nullptr
                              : static_cast<const float*>(cb) + chunk * plane,
                         hbuf[0], ws.c, ws.h32, plane, stream);
    if (err != cudaSuccess) return (int)err;
    // the recompute, a launch a step
    for (int k = 0; k < len; ++k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      const StepIo io = {hbuf[k & 1], hbuf[(k + 1) & 1], ws.c, ws.h32,
                         nullptr, nullptr, nullptr,
                         ws.act + (size_t)k * saved * plane, ws.h_prev};
      err = launch_step<NG, kRecompute>(dtype, in, io, n_rows, n_steps, e,
                                        h_dim, t, tc, reverse, stream);
      if (err != cudaSuccess) return (int)err;
    }
    // the reverse pass: the gradient slots, then (but after the run's last
    // step) the unit tiles' dh partials
    for (int k = len - 1; k >= 0; --k) {
      const int t = reverse ? t_lo + len - 1 - k : t_lo + k;
      step_dgates_kernel<T, NG><<<dim3((h_dim + 255) / 256, row_groups), 256,
                                  0, stream>>>(
          static_cast<const uint8_t*>(in.mask),
          ws.act + (size_t)k * saved * plane, static_cast<const T*>(dout),
          ws.partial, tiles_u, ws.dh, ws.dc, static_cast<T*>(ws.dgates),
          ws.db_part, n_rows, n_steps, h_dim, t, t_prev);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      t_prev = t;
      if (q + 1 == n_chunks && k == 0) break;
      if (dtype == 1) {
        const int m_rows = 16 * tiles::kClusterConfig.mt;
        step_dh_mma_kernel<NG><<<dim3((n_rows + m_rows - 1) / m_rows,
                                      tiles_u),
                                 tiles::kThreads, smem_bwd, stream>>>(
            static_cast<const __nv_bfloat16*>(in.w_ih),
            static_cast<const __nv_bfloat16*>(ws.dgates), ws.partial,
            n_rows, n_steps, e, h_dim, t, ks_bwd);
      } else {
        step_dh_f32_kernel<NG><<<dim3((n_rows + kRows - 1) / kRows,
                                      (h_dim + kF32Units - 1) / kF32Units,
                                      tiles_u),
                                 kRowGroups * kF32Units, smem_f32, stream>>>(
            static_cast<const float*>(ws.dgates),
            static_cast<const float*>(w_hh_t), ws.partial, n_rows, n_steps,
            h_dim, t);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

namespace cair_lstm {

int step_forward(const void* x, const void* mask, const void* w_ih,
                 const void* b, const void* b_hh, const void* w_hh, void* out,
                 void* hb, void* cb, void* workspace, int n_rows, int n_steps,
                 int e, int h_dim, int reverse, int tc, bool res, bool rec,
                 int gates, int dtype, cudaStream_t stream) {
  if (n_rows == 0 || n_steps == 0) return 0;
  const bool gru = gates == tiles::kGruGates;
  const int route = gru ? tiles::gru_route(h_dim, dtype == 1)
                        : tiles::lstm_route(h_dim, dtype == 1, rec);
  if (n_rows < 0 || n_steps < 0 || tc <= 0 || (rec && (e != 0 || gru)) ||
      (!rec && e <= 0) || !step_shape_ok(e, h_dim, dtype) ||
      route != tiles::kRouteStep)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (!tiles::aligned16(x) || !tiles::aligned16(w_ih) ||
                     !tiles::aligned16(workspace)))
    return (int)cudaErrorInvalidValue;
  const StepIn in = {x, mask, w_ih, b, b_hh, w_hh};
  return gru ? forward<tiles::kGruGates>(in, out, hb, cb, workspace, n_rows,
                                         n_steps, e, h_dim, reverse, tc, res,
                                         rec, dtype, stream)
             : forward<tiles::kLstmGates>(in, out, hb, cb, workspace, n_rows,
                                          n_steps, e, h_dim, reverse, tc, res,
                                          rec, dtype, stream);
}

int step_phase_a(const void* x, const void* mask, const void* w_ih,
                 const void* b, const void* b_hh, const void* w_hh,
                 const void* w_hh_t, const void* hb, const void* cb,
                 const void* dout, const StepBwd& ws, int n_rows, int n_steps,
                 int e, int h_dim, int reverse, int tc, int gates, int dtype,
                 cudaStream_t stream) {
  const StepIn in = {x, mask, w_ih, b, b_hh, w_hh};
  const bool gru = gates == tiles::kGruGates;
#define CAIR_PHASE_A(T_, NG_)                                               \
  return phase_a<T_, NG_>(in, w_hh_t, hb, cb, dout, ws, n_rows, n_steps, e, \
                          h_dim, reverse, tc, dtype, stream);
  if (dtype == 1) {
    if (gru) CAIR_PHASE_A(__nv_bfloat16, tiles::kGruGates)
    CAIR_PHASE_A(__nv_bfloat16, tiles::kLstmGates)
  }
  if (gru) CAIR_PHASE_A(float, tiles::kGruGates)
  CAIR_PHASE_A(float, tiles::kLstmGates)
#undef CAIR_PHASE_A
}

}  // namespace cair_lstm

// Bytes of workspace cair_lstm_step needs (its state: h in turn, c, and
// for bf16 the f32 h), or -1 for an invalid shape.
extern "C" long long cair_lstm_step_workspace(int n_rows, int h_dim,
                                              int dtype) {
  if (n_rows < 0 || h_dim <= 0 || (dtype != 0 && dtype != 1)) return -1;
  return (long long)cair_lstm::step_state(n_rows, h_dim, dtype,
                                          cair_lstm::tiles::kLstmGates)
      .total;
}

// The route rule of lstm_mma.cuh (`lstm_route`): 0 one block, 1 a cluster,
// 2 the step route, for hidden size h_dim in dtype (0 = float32, 1 =
// bfloat16) of kernels 1 and 4 (kernel 0), 5 (1) or 6 (2); 1, 4 and 5
// share one route.
extern "C" int cair_lstm_route(int h_dim, int dtype, int kernel) {
  return cair_lstm::tiles::lstm_route(h_dim, dtype == 1, kernel == 2);
}

// Kernels 1 (res = 0), 4 (res = 1) and 6 (rec = 1) on the step route:
// cair_lstm_fwd's / cair_lstm_fwd_res's arguments and `workspace`
// (cair_lstm_step_workspace(n_rows, h_dim, dtype) bytes, 16-byte aligned).
// bfloat16: E a multiple of 32 and H of 256 (the wrapper zero-pads), `w_ih`
// the staged weights of H / 256 unit tiles (stage_lstm_weights(..., H /
// 256); kernel 6: an empty W_ih over W_hh), `w_hh` not read.  Kernel 6: `x`
// is x_proj [B, T, 4H], e = 0, `b` not read.  Refuses a shape whose route
// (cair_lstm_route) is not the step route.  Returns the first cudaError_t
// (0 on success).
extern "C" int cair_lstm_step(const void* x, const void* mask,
                              const void* w_ih, const void* b,
                              const void* w_hh, void* out, void* hb, void* cb,
                              void* workspace, int n_rows, int n_steps, int e,
                              int h_dim, int reverse, int tc, int res, int rec,
                              int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || (res && rec))
    return (int)cudaErrorInvalidValue;
  return cair_lstm::step_forward(
      x, mask, w_ih, b, nullptr, w_hh, out, hb, cb, workspace, n_rows,
      n_steps, e, h_dim, reverse, tc, res != 0, rec != 0,
      cair_lstm::tiles::kLstmGates, dtype, static_cast<cudaStream_t>(stream));
}

// Bytes of workspace cair_gru_step needs (its state: h in turn, and for
// bf16 the carried f32 h), or -1 for an invalid shape.
extern "C" long long cair_gru_step_workspace(int n_rows, int h_dim,
                                             int dtype) {
  if (n_rows < 0 || h_dim <= 0 || (dtype != 0 && dtype != 1)) return -1;
  return (long long)cair_lstm::step_state(n_rows, h_dim, dtype,
                                          cair_lstm::tiles::kGruGates)
      .total;
}

// Kernels 7 (res = 0) and 8 (res = 1) on the step route: cair_gru_fwd's /
// cair_gru_fwd_res's arguments and `workspace` (cair_gru_step_workspace(
// n_rows, h_dim, dtype) bytes, 16-byte aligned).  bfloat16: E a multiple
// of 32 and H of 256 (the wrapper zero-pads), `w_ih` the staged weights of
// H / 256 unit tiles (stage_lstm_weights(..., H / 256, 3)), `w_hh` not
// read.  Refuses a shape whose route (cair_gru_route) is not the step
// route.  Returns the first cudaError_t (0 on success).
extern "C" int cair_gru_step(const void* x, const void* mask,
                             const void* w_ih, const void* b_ih,
                             const void* w_hh, const void* b_hh, void* out,
                             void* hb, void* workspace, int n_rows,
                             int n_steps, int e, int h_dim, int reverse,
                             int tc, int res, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return cair_lstm::step_forward(
      x, mask, w_ih, b_ih, b_hh, w_hh, out, hb, nullptr, workspace, n_rows,
      n_steps, e, h_dim, reverse, tc, res != 0, false,
      cair_lstm::tiles::kGruGates, dtype, static_cast<cudaStream_t>(stream));
}
