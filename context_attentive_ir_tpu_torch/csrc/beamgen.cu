// Fused tied-generator step for Hopper (sm_90a): top-kc + logsumexp of
// x [R, E] @ table_t [E, V] without writing the [R, V] logits.
//
// Replaces the TPU kernels reached through `generator_topk_lse` in
// context_attentive_ir_tpu/ops/pallas/beamgen.py:
//   - `_beamgen_kernel` (serial), on a float table, with or without
//     `prune` (kernel 2), and on an int8 table with a per-column scale
//     (kernel 2's int8 mode: logits = scale_v * (x @ q_v), the scale applied
//     after the dot as in the TPU kernel);
//   - `_beamgen_pipelined_kernel` (kernel 3, `pipeline=True`, float table).
// Outputs: vals [R, kc] f32 and idx [R, kc] i32 (descending, ties to the
// LOWER vocab index, exactly as lax.top_k) and lse [R] f32.  Every mode
// gives the same bits on the same float table.
//
// What bounds it on the H100: at the beam-5 serving shape (R = 1600,
// E = 256, V = 50,000) one call is 2*R*E*V = 4.1e10 flops (41 us at the
// 989 TFLOP/s bf16 tensor-core peak) against a 25.6 MB bf16 table (8 us at
// 3.35 TB/s; the int8 table 12.8 MB): compute-bound.
//
// Design.  The TPU sweeps the vocab in order on one core with the running
// top-k and (max, sumexp) in VMEM.  Blocks on Hopper run in parallel and
// share nothing, so the vocab is split: block (row_block, split) owns 64
// rows and a contiguous run of 128-column vocab tiles, and writes a partial
// top-kc plus its (max, sumexp) pair; a second, tiny kernel merges the
// splits per row with the same tie rule and the log-sum-exp merge
// m + log(sum_s s_s * exp(m_s - m)).  The wrapper picks the split count
// (`vocab_splits` in ops/kernels/beamgen.py), the same for every mode of a
// table.  Inside a block each selection warp owns 8 rows and each lane 4
// columns of a tile (beamgen_common.cuh: rows_select, four rows at once so
// their shuffle chains overlap): the online logsumexp, then with `prune`
// an insertion of only the columns that beat the row's running kc-th entry
// (a tile with none costs one warp vote), without it kc exact argmax passes
// on every tile, as the TPU's unpruned kernel.
//
// bf16 x (the serving path) takes the tensor cores (beamgen_common.cuh,
// namespace tc): the x rows staged once in bf16, the table streamed in
// 32-row slabs through a four-slot `cp.async` ring, the 64 x 128 score
// tile as `mma.sync.m16n8k16` (bf16 in, f32 accumulate) staged in shared
// memory, then read back by the selection warps.  64-row blocks (not 128)
// keep a block's registers under 128 a thread and its shared memory at
// 103.4 KB for E = 256, so two blocks share an SM; the price is the table
// crossing L2 -> SM once per 64 rows (25 x 25.6 MB a beam-5 call; 128 rows
// would halve it, at 64 KB more x tile and twice the accumulators).
//   - kernel 2 (tc_serial_kernel): the same eight warps run a tile's
//     product, then its selection, then the next tile's product; the ring
//     keeps the next tile's first slabs in flight under the selection.
//   - kernel 3 (tc_pipelined_kernel): sixteen warps, eight running the
//     product into one of two score buffers while the other eight select
//     the previous tile from the other buffer -- the overlap the TPU's
//     double-buffered score scratch gives.  mbarriers (full / empty per
//     buffer, one arrival a warp) hand the buffers over; a barrier that
//     never completes traps.
// Both run the same product and the same selection in the same order, so
// kernel 3, and kernel 2 with or without `prune`, give the same bits.  The
// int8 mode stages the int8 table (half the bytes) and widens each slab to
// bf16 in shared memory; x float32 keeps the exact CUDA-core kernels below
// (one fmaf per product, the parent's bits), as do int8 tables with f32 x.
//
// What holds the bf16 kernels at the beam-5 shape (PERF.md): the product
// is bound by shared-memory traffic (the slabs' copies and `ldmatrix`, about
// 384 KB a block-tile) and its copies and `mma` do not overlap; the two
// blocks of an SM run product and selection in step; kernel 3's eight
// selection warps, which run every pass, set its pace.  `wgmma` from
// shared memory and a 128-row tile are the next steps.
//
// Table layout: table_t [E, V] with rows `ld` >= V elements apart.  The
// bf16 kernels and the f32 pipelined kernel copy 16-byte pieces, so they
// need a 16-byte aligned table and ld * sizeof(element) a multiple of 16;
// the wrapper pads a table that is not (`aligned_table`), the decoders
// build the padded table once per decode (decode/fusedgen.py).  Columns in
// [V, ld) are never selected and never enter the logsumexp.

#include "beamgen_common.cuh"

namespace {

using namespace beamgen;

// One signature for every partial kernel, so the launcher and the
// occupancy query can pick one by mode (x and table typed inside).
using PartialFn = void (*)(const void*, const void*, const float*, int, int,
                           int, int, int, int, float*, int*, float*, float*);

// -- float32 x: exact CUDA-core kernels --------------------------------------

template <typename TX, typename TW, bool kScale, bool kPrune>
__global__ void __launch_bounds__(kWarps * 32)
beamgen_partial_kernel(const void* x_, const void* table_,
                       const float* __restrict__ scale, int n_rows, int e,
                       int v_size, int ld, int kc, int tiles_per_split,
                       float* __restrict__ part_v, int* __restrict__ part_i,
                       float* __restrict__ part_m,
                       float* __restrict__ part_s) {
  const TX* __restrict__ x = static_cast<const TX*>(x_);
  const TW* __restrict__ table = static_cast<const TW*>(table_);
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [e][kRowBlock]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int split = blockIdx.y;
  const int n_tiles = (v_size + kTile - 1) / kTile;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);

  stage_x(x, xs, n_rows, e, row0);
  __syncthreads();

  float m_run[kRowsPerWarp], s_run[kRowsPerWarp], buf_v[kRowsPerWarp];
  int buf_i[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    s_run[r] = 0.0f;
    buf_v[r] = -INFINITY;  // lane l < kc holds buffer slot l of row r
    buf_i[r] = kNoIndex;
  }
  const float* a_base = xs + warp * kRowsPerWarp;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * kTile + lane;
    bool ok[kColsPerLane];
    float scl[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      ok[c] = col0 + 32 * c < v_size;
      scl[c] = kScale && ok[c] ? __ldg(scale + col0 + 32 * c) : 1.0f;
    }
    float acc[kRowsPerWarp][kColsPerLane] = {};
    tile_fma<TW, true>(acc, a_base, table + col0, ld, 0, e, ok);
    int vi[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) vi[c] = ok[c] ? col0 + 32 * c : kNoIndex;
    rows_select<kPrune>(
        [&](int r, int c) { return kScale ? acc[r][c] * scl[c] : acc[r][c]; },
        vi, ok, m_run, s_run, buf_v, buf_i, kc, lane);
  }
  store_partials(m_run, s_run, buf_v, buf_i, row0, warp, lane, split, n_rows,
                 kc, part_v, part_i, part_m, part_s);
}

// table rows of one k-chunk staged per ring slot of the f32 pipelined
// kernel: 32 KB per stage
constexpr int kF32Chunk = 32768 / (kTile * 4);

// Start the copy of table rows [k0, k1) x tile columns into a ring slot
// [kF32Chunk][kTile]; pieces past v_size are zero-filled.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ table,
                                            float* stage, int v_size, int ld,
                                            int tile, int k0, int k1) {
  constexpr int kCopiesPerRow = kTile / 4;
  const int n = (k1 - k0) * kCopiesPerRow;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = i / kCopiesPerRow;
    const int piece = i - row * kCopiesPerRow;
    const int col = tile * kTile + piece * 4;
    const bool in = col < v_size;  // rows hold whole 16-byte pieces
    const float* src = in ? table + (size_t)(k0 + row) * ld + col : table;
    tc::cp_async16(stage + row * kTile + piece * 4, src, in);
  }
}

// Kernel 3 in float32: a two-stage cp.async ring of table k-chunks under
// the same tile_fma / rows_select as beamgen_partial_kernel.
__global__ void __launch_bounds__(kWarps * 32)
beamgen_pipelined_kernel(const void* x_, const void* table_,
                         const float* __restrict__ /*scale*/, int n_rows,
                         int e, int v_size, int ld, int kc,
                         int tiles_per_split, float* __restrict__ part_v,
                         int* __restrict__ part_i, float* __restrict__ part_m,
                         float* __restrict__ part_s) {
  const float* __restrict__ x = static_cast<const float*>(x_);
  const float* __restrict__ table = static_cast<const float*>(table_);
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [e][kRowBlock]
  float* ring = xs + e * kRowBlock;             // [2][kF32Chunk][kTile]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int split = blockIdx.y;
  const int n_tiles = (v_size + kTile - 1) / kTile;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const int n_chunks = (e + kF32Chunk - 1) / kF32Chunk;
  const int n_units = max(0, tile_end - tile_begin) * n_chunks;

  if (n_units > 0)
    stage_chunk(table, ring, v_size, ld, tile_begin, 0, min(e, kF32Chunk));
  tc::cp_async_commit();
  stage_x(x, xs, n_rows, e, row0);

  float m_run[kRowsPerWarp], s_run[kRowsPerWarp], buf_v[kRowsPerWarp];
  int buf_i[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    s_run[r] = 0.0f;
    buf_v[r] = -INFINITY;
    buf_i[r] = kNoIndex;
  }
  const float* a_base = xs + warp * kRowsPerWarp;
  float acc[kRowsPerWarp][kColsPerLane];

  for (int u = 0; u < n_units; ++u) {
    if (u + 1 < n_units) {
      const int nt = tile_begin + (u + 1) / n_chunks;
      const int nk0 = ((u + 1) % n_chunks) * kF32Chunk;
      stage_chunk(table, ring + ((u + 1) & 1) * kF32Chunk * kTile, v_size,
                  ld, nt, nk0, min(e, nk0 + kF32Chunk));
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this thread's copies of chunk u have landed
    __syncthreads();        // ... and everyone's (and xs, at u = 0)

    const int tile = tile_begin + u / n_chunks;
    const int chunk = u % n_chunks;
    const int k0 = chunk * kF32Chunk;
    const int col0 = tile * kTile + lane;
    bool ok[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) ok[c] = col0 + 32 * c < v_size;
    if (chunk == 0) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.0f;
      }
    }
    tile_fma<float, false>(acc, a_base,
                           ring + (u & 1) * kF32Chunk * kTile + lane, kTile,
                           k0, min(e, k0 + kF32Chunk), ok);
    if (chunk == n_chunks - 1) {
      int vi[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        vi[c] = ok[c] ? col0 + 32 * c : kNoIndex;
      rows_select<false>([&](int r, int c) { return acc[r][c]; }, vi, ok,
                         m_run, s_run, buf_v, buf_i, kc, lane);
    }
    __syncthreads();  // slot u & 1 is refilled at iteration u + 1
  }
  store_partials(m_run, s_run, buf_v, buf_i, row0, warp, lane, split, n_rows,
                 kc, part_v, part_i, part_m, part_s);
}

// -- bf16 x: tensor-core kernels ---------------------------------------------

__device__ __forceinline__ void init_rows(float (&m_run)[kRowsPerWarp],
                                          float (&s_run)[kRowsPerWarp],
                                          float (&buf_v)[kRowsPerWarp],
                                          int (&buf_i)[kRowsPerWarp]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    s_run[r] = 0.0f;
    buf_v[r] = -INFINITY;
    buf_i[r] = kNoIndex;
  }
}

// Kernel 2 on bf16 x (TW: bf16 table, or int8 with `scale`): eight warps,
// each tile's product then its selection.  Shared memory: the x tile, one
// score buffer, the slab ring (tc::smem_bytes(e, false)).
template <typename TW, bool kScale, bool kPrune>
__global__ void __launch_bounds__(tc::kThreads, 2)
tc_serial_kernel(const void* x_, const void* table_,
                 const float* __restrict__ scale, int n_rows, int e,
                 int v_size, int ld, int kc, int tiles_per_split,
                 float* __restrict__ part_v, int* __restrict__ part_i,
                 float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) char smem[];
  char* xs = smem;
  float* scores = reinterpret_cast<float*>(xs + kRowBlock * tc::x_stride(e));
  char* ring_base = reinterpret_cast<char*>(scores) + tc::kScoreBytes;
  // an int8 ring's widened slab sits after its kStages narrow slots
  char* wide = ring_base + tc::kStages * tc::kKs * tc::kNarrowStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int split = blockIdx.y;
  const int n_tiles = (v_size + kTile - 1) / kTile;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const int n_slabs = (e + tc::kKs - 1) / tc::kKs;

  tc::SlabRing<TW, true> ring{ring_base, static_cast<const TW*>(table_), e,
                              v_size, ld, n_slabs, tile_begin,
                              max(0, tile_end - tile_begin) * n_slabs};
  ring.prologue(tid);
  tc::stage_x_bf16(static_cast<const tc::bf16*>(x_), xs, n_rows, e, row0,
                   tid, tc::kThreads);  // visible after the first acquire

  float m_run[kRowsPerWarp], s_run[kRowsPerWarp], buf_v[kRowsPerWarp];
  int buf_i[kRowsPerWarp];
  init_rows(m_run, s_run, buf_v, buf_i);
  const int wm = warp & 1, wn = warp >> 1;
  int n = 0;
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    float acc[2][4][4];
    tc::tile_mma<TW, true>(acc, ring, n, xs, wide, e, wm, wn, tid, lane);
    // every warp's selection of the previous tile ended before this
    // tile's first acquire, so the score buffer is free
    tc::store_scores(acc, scores, wm, wn, lane);
    __syncthreads();
    tc::select_tile<kScale, kPrune>(scores, scale, tile, v_size, kc, warp,
                                    lane, m_run, s_run, buf_v, buf_i);
  }
  store_partials(m_run, s_run, buf_v, buf_i, row0, warp, lane, split, n_rows,
                 kc, part_v, part_i, part_m, part_s);
}

// Kernel 3 on bf16: warps 0-7 run the product of tile t into score buffer
// t & 1 while warps 8-15 select tile t - 1 from the other.  full[b]
// completes when the eight product warps have stored into buffer b,
// empty[b] when the eight selection warps have read it (one arrival a
// warp); use u of buffer b (tile 2u + b) completes phase u of each, so its
// parity is u & 1.
__global__ void __launch_bounds__(2 * tc::kThreads, 1)
tc_pipelined_kernel(const void* x_, const void* table_,
                    const float* __restrict__ /*scale*/, int n_rows, int e,
                    int v_size, int ld, int kc, int tiles_per_split,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 2;
  char* xs = smem + tc::kHeader;
  float* scores = reinterpret_cast<float*>(xs + kRowBlock * tc::x_stride(e));
  char* ring_base = reinterpret_cast<char*>(scores) + 2 * tc::kScoreBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool producer = warp < kWarps;
  const int row0 = blockIdx.x * kRowBlock;
  const int split = blockIdx.y;
  const int n_tiles = (v_size + kTile - 1) / kTile;
  const int tile_begin = split * tiles_per_split;
  const int n_local = max(0, min(n_tiles, tile_begin + tiles_per_split) -
                                 tile_begin);
  const int n_slabs = (e + tc::kKs - 1) / tc::kKs;

  tc::SlabRing<tc::bf16, false> ring{
      ring_base, static_cast<const tc::bf16*>(table_), e, v_size, ld,
      n_slabs, tile_begin, n_local * n_slabs};
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      tc::mbar_init(&full[b], kWarps);
      tc::mbar_init(&empty[b], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (producer) ring.prologue(tid);
  tc::stage_x_bf16(static_cast<const tc::bf16*>(x_), xs, n_rows, e, row0,
                   tid, 2 * tc::kThreads);
  __syncthreads();  // the barriers and the x tile; no block barrier after

  if (producer) {
    const int wm = warp & 1, wn = warp >> 1;
    int n = 0;
    for (int t = 0; t < n_local; ++t) {
      float acc[2][4][4];
      // bf16 slabs are read in place: no widened slab
      tc::tile_mma<tc::bf16, false>(acc, ring, n, xs, nullptr, e, wm, wn,
                                    tid, lane);
      const int b = t & 1;
      if (t >= 2) tc::mbar_wait(&empty[b], (uint32_t)((t >> 1) - 1) & 1u);
      tc::store_scores(acc, scores + b * kRowBlock * tc::kScoreStride, wm,
                       wn, lane);
      tc::warp_arrive(&full[b], lane);
    }
    return;
  }
  const int sw = warp - kWarps;
  float m_run[kRowsPerWarp], s_run[kRowsPerWarp], buf_v[kRowsPerWarp];
  int buf_i[kRowsPerWarp];
  init_rows(m_run, s_run, buf_v, buf_i);
  for (int t = 0; t < n_local; ++t) {
    const int b = t & 1;
    tc::mbar_wait(&full[b], (uint32_t)(t >> 1) & 1u);
    tc::select_tile<false, false>(scores + b * kRowBlock * tc::kScoreStride,
                                  nullptr, tile_begin + t, v_size, kc, sw,
                                  lane, m_run, s_run, buf_v, buf_i);
    tc::warp_arrive(&empty[b], lane);
  }
  store_partials(m_run, s_run, buf_v, buf_i, row0, sw, lane, split, n_rows,
                 kc, part_v, part_i, part_m, part_s);
}

__global__ void beamgen_merge_kernel(const float* __restrict__ part_v,
                                     const int* __restrict__ part_i,
                                     const float* __restrict__ part_m,
                                     const float* __restrict__ part_s,
                                     int n_rows, int kc, int n_split,
                                     float* __restrict__ vals,
                                     int* __restrict__ idx,
                                     float* __restrict__ lse) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_m[(size_t)s * n_rows + row]);
  float total = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const size_t at = (size_t)s * n_rows + row;
    total += part_s[at] * expf(part_m[at] - m);
  }
  lse[row] = m + logf(total);

  float bv[kMaxK];
  int bi[kMaxK];
  for (int q = 0; q < kc; ++q) {
    bv[q] = -INFINITY;
    bi[q] = kNoIndex;
  }
  for (int s = 0; s < n_split; ++s) {
    const size_t at = ((size_t)s * n_rows + row) * kc;
    for (int q = 0; q < kc; ++q) {
      const float v = part_v[at + q];
      const int i = part_i[at + q];
      if (!beats(v, i, bv[kc - 1], bi[kc - 1])) break;  // partials are sorted
      int pos = kc - 1;
      while (pos > 0 && beats(v, i, bv[pos - 1], bi[pos - 1])) {
        bv[pos] = bv[pos - 1];
        bi[pos] = bi[pos - 1];
        --pos;
      }
      bv[pos] = v;
      bi[pos] = i;
    }
  }
  for (int q = 0; q < kc; ++q) {
    vals[(size_t)row * kc + q] = bv[q];
    idx[(size_t)row * kc + q] = bi[q];
  }
}

// The partial kernel of one mode, its block size and dynamic shared memory
// for E = e; fn == nullptr for a mode no kernel takes.
struct Plan {
  PartialFn fn;
  int threads;
  size_t smem;
  size_t elem;  // bytes per table element (the 16-byte rule of ld)
  bool copies;  // stages the table by 16-byte copies
};

template <typename TX, typename TW, bool kScale>
PartialFn f32_serial(bool prune) {
  return prune ? beamgen_partial_kernel<TX, TW, kScale, true>
               : beamgen_partial_kernel<TX, TW, kScale, false>;
}

template <typename TW, bool kScale>
PartialFn tc_serial(bool prune) {
  return prune ? tc_serial_kernel<TW, kScale, true>
               : tc_serial_kernel<TW, kScale, false>;
}

Plan plan(int x_dtype, int table_dtype, bool prune, bool pipeline, int e) {
  const bool int8_table = table_dtype == 2;
  const size_t f32_tile = (size_t)e * kRowBlock * sizeof(float);
  if (x_dtype == 0) {
    if (pipeline)
      return {beamgen_pipelined_kernel, kWarps * 32,
              f32_tile + 2 * (size_t)kF32Chunk * kTile * sizeof(float), 4,
              true};
    if (int8_table)
      return {f32_serial<float, int8_t, true>(prune), kWarps * 32, f32_tile,
              1, false};
    return {f32_serial<float, float, false>(prune), kWarps * 32, f32_tile, 4,
            false};
  }
  if (pipeline)
    return {tc_pipelined_kernel, 2 * tc::kThreads, tc::smem_bytes(e, true), 2,
            true};
  if (int8_table)
    return {tc_serial<int8_t, true>(prune), tc::kThreads,
            tc::smem_bytes(e, false), 1, true};
  return {tc_serial<tc::bf16, false>(prune), tc::kThreads,
          tc::smem_bytes(e, false), 2, true};
}

// Set the plan's dynamic shared memory (an E too large for it is refused
// here, and the error cleared so the next launch reads clean).
int prepare(const Plan& p) {
  if (p.smem > (size_t)tc::kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return 0;
}

bool valid_mode(int x_dtype, int table_dtype, bool prune, bool pipeline,
                bool has_scale) {
  const bool int8_table = table_dtype == 2;
  return int8_table == has_scale && (int8_table || table_dtype == x_dtype) &&
         !(pipeline && prune) && !(pipeline && int8_table) &&
         (x_dtype == 0 || x_dtype == 1);
}

}  // namespace

// How many blocks of the mode's partial kernel at E = e one SM holds at
// once (the wrapper sizes the vocab split to fill the card with them).
// Returns the cudaError_t (0 = ok); an E the kernel cannot hold is refused.
extern "C" int cair_beamgen_occupancy(int e, int x_dtype, int table_dtype,
                                      int prune, int pipeline, int* blocks) {
  if (e <= 0 || !valid_mode(x_dtype, table_dtype, prune, pipeline,
                            table_dtype == 2))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(x_dtype, table_dtype, prune, pipeline, e);
  int rc = prepare(p);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, p.fn,
                                                            p.threads, p.smem);
}

// x [R, E] contiguous (x_dtype 0 = float32, 1 = bfloat16), table_t [E, V]
// with rows ld elements apart (table_dtype: x_dtype for a float table, 2 =
// int8 with scale [V] float32); scratch part_v/part_i [n_split, R, kc],
// part_m/part_s [n_split, R]; outputs vals/idx [R, kc], lse [R].  prune
// selects the pruned serial kernel, pipeline the pipelined one (float table
// only, not with prune).  Every split must own at least one vocab tile of
// 128 columns.  The bf16 kernels and the float32 pipelined one need a
// 16-byte aligned table with ld * element size a multiple of 16.  Returns
// the cudaError_t (0 = ok).
extern "C" int cair_beamgen(const void* x, const void* table,
                            const void* scale, int n_rows, int e, int v_size,
                            int ld, int kc, int n_split, int tiles_per_split,
                            void* part_v, void* part_i, void* part_m,
                            void* part_s, void* vals, void* idx, void* lse,
                            int x_dtype, int table_dtype, int prune,
                            int pipeline, void* stream) {
  if (n_rows == 0) return 0;
  if (kc <= 0 || kc > kMaxK || kc > v_size || n_split <= 0 || e <= 0 ||
      ld < v_size ||
      !valid_mode(x_dtype, table_dtype, prune, pipeline, scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(x_dtype, table_dtype, prune, pipeline, e);
  if (p.copies && (reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
                   ((size_t)ld * p.elem) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  int rc = prepare(p);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_rows + kRowBlock - 1) / kRowBlock, n_split);
  p.fn<<<grid, p.threads, p.smem, s>>>(
      x, table, static_cast<const float*>(scale), n_rows, e, v_size, ld, kc,
      tiles_per_split, static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<float*>(part_m), static_cast<float*>(part_s));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  beamgen_merge_kernel<<<(n_rows + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      n_rows, kc, n_split, static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse));
  return (int)cudaGetLastError();
}
