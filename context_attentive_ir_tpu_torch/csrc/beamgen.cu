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
// LOWER vocab index, exactly as lax.top_k) and lse [R] f32, for any
// 1 <= kc <= 128 (the TPU kernel's _KPAD) and any E >= 1.  Every mode
// gives the same bits on the same float table.
//
// What bounds it on the H100: at the beam-5 serving shape (R = 1600,
// E = 256, V = 50,000) one call is 2*R*E*V = 4.1e10 flops: 41 us at the
// 989 TFLOP/s bf16 tensor-core peak against a 25.6 MB bf16 table (8 us at
// 3.35 TB/s; the int8 table 12.8 MB), 249 us at split TF32's 165 TFLOP/s
// (a third of TF32's 495) against a 51.2 MB float32 table (15 us):
// compute-bound in every mode and dtype.
//
// Design.  The TPU sweeps the vocab in order on one core with the running
// top-k and (max, sumexp) in VMEM.  Blocks on Hopper run in parallel and
// share nothing, so the vocab is split: block (row_block, split) owns 64
// rows and a contiguous run of 128-column vocab tiles, and writes a partial
// top-kc plus its (max, sumexp) pair; a second, tiny kernel merges the
// splits per row with the same tie rule and the log-sum-exp merge
// m + log(sum_s s_s * exp(m_s - m)) (a warp a row).  The wrapper picks
// the split count (`vocab_splits` in ops/kernels/beamgen.py) from the
// serial kernel's residency, the same for every mode of a table at one kc.
// Every kernel takes its score tiles from the tensor cores
// (beamgen_common.cuh, namespace tc): the x rows staged once in x's type
// (past the E that fits, streamed in 32-column slabs beside the table's:
// tc::stream_x), the table streamed in 32-row slabs through a four-slot
// `cp.async` ring, the 64 x 128 score tile as `mma.sync.m16n8k16` for bf16
// x (bf16 in, f32 accumulate) or as split-TF32 `mma.sync.m16n8k8` for
// float32 x (lo*hi + hi*lo + hi*hi, a fresh accumulator a slab; about 21
// of float32's 24 bits, tf32_mma.cuh), staged in shared memory, then read
// back by the selection warps.  64-row blocks (not 128) keep a bf16
// block's registers under 128 a thread and its shared memory at 103.4 KB
// for E = 256, so two blocks share an SM (float32: 171.0 KB, one block);
// the price is the table crossing L2 -> SM once per 64 rows.
// Inside a block each selection warp owns 8 rows and each lane 4 columns
// of a tile (beamgen_common.cuh: rows_select, four rows at once so their
// shuffle chains overlap): the online logsumexp, then the insertion of
// only the columns that beat the row's running kc-th entry (a row with
// none costs one warp vote; `prune` votes four rows in lockstep first and
// skips the rows without one).  The TPU's unpruned kernel merges every
// tile whole; here the selection costs what enters the top-kc, which after
// the first tiles is a few columns a row.  A row's running top-kc lies
// across its warp's lanes, 1, 2 or 4 register slots a lane (kc up to 32,
// 64, 128: a template parameter, so kc <= 32 compiles to the one-slot
// code); the bf16 kernel 2 with more than one slot runs one block an SM
// (its registers past 128 a thread), and the split follows that residency.
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
// int8 mode stages the int8 table (half the bytes): widened to bf16 in
// shared memory for bf16 x, read as TF32 values (exact) for float32 x.
//
// What holds the bf16 kernels at the beam-5 shape (PERF.md): the product
// is bound by shared-memory traffic (the slabs' copies and `ldmatrix`, about
// 384 KB a block-tile) and its copies and `mma` do not overlap; the two
// blocks of an SM run product and selection in step.  `wgmma` from shared
// memory and a 128-row tile are the next steps.
//
// Table layout: table_t [E, V] with rows `ld` >= V elements apart.  Every
// kernel copies 16-byte pieces, so it needs a 16-byte aligned table and
// ld * sizeof(element) a multiple of 16; the wrapper pads a table that is
// not (`aligned_table`), the decoders build the padded table once per
// decode (decode/fusedgen.py).  Columns in [V, ld) are never selected and
// never enter the logsumexp.

#include "beamgen_common.cuh"

namespace {

using namespace beamgen;

// One signature for every partial kernel, so the launcher and the
// occupancy query can pick one by mode (x and table typed inside).
using PartialFn = void (*)(const void*, const void*, const float*, int, int,
                           int, int, int, int, int, float*, int*, float*,
                           float*);

// Kernel 2 (TX: bf16 or float x; TW: a table of x's type, or int8 with
// `scale`): eight warps, each tile's product then its selection.  Shared
// memory: the x tile (unless streamed), one score buffer, the slab ring
// (tc::smem_bytes<TX>(e, false, tc::stream_x<TX>(e, false))).  Two bf16
// blocks an SM for a one-slot top-kc (registers under 128 a thread); one
// for more slots, whose buffers take a thread to 156-160 registers at two
// slots and 188-193 at four (ptxas, sm_90a), and one for float32, whose
// tile alone takes 171.0 KB at E = 256.
template <typename TX, typename TW, bool kScale, bool kPrune, int S>
__global__ void __launch_bounds__(tc::kThreads,
                                  sizeof(TX) == 2 && S == 1 ? 2 : 1)
tc_serial_kernel(const void* x_, const void* table_,
                 const float* __restrict__ scale, int n_rows, int e, int ldx,
                 int v_size, int ld, int kc, int tiles_per_split,
                 float* __restrict__ part_v, int* __restrict__ part_i,
                 float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) char smem[];
  const bool stream = tc::stream_x<TX>(e, false);
  char* xs = smem;
  float* scores = reinterpret_cast<float*>(
      xs + (stream ? 0 : kRowBlock * tc::x_stride<TX>(e)));
  char* ring_base = reinterpret_cast<char*>(scores) + tc::kScoreBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int split = blockIdx.y;
  const int n_tiles = (v_size + kTile - 1) / kTile;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const int n_slabs = (e + tc::kKs - 1) / tc::kKs;
  const TX* x = static_cast<const TX*>(x_);

  tc::SlabRing<TX, TW, true> ring{ring_base, static_cast<const TW*>(table_),
                                  stream ? x : nullptr, e, v_size, ld,
                                  n_slabs, tile_begin,
                                  max(0, tile_end - tile_begin) * n_slabs,
                                  ldx, n_rows, row0};
  // a bf16 int8 ring's widened slab sits after its kStages narrow slots
  char* wide = ring.end();
  ring.prologue(tid);
  if (!stream)  // visible after the first acquire
    tc::stage_x(x, xs, n_rows, e, ldx, row0, tid, tc::kThreads);

  float m_run[kRowsPerWarp], s_run[kRowsPerWarp], buf_v[kRowsPerWarp][S];
  int buf_i[kRowsPerWarp][S];
  init_rows(m_run, s_run, buf_v, buf_i);
  const int wm = warp & 1, wn = warp >> 1;
  int n = 0;
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    float acc[2][4][4];
    tc::tile_mma(acc, ring, n, xs, wide, e, wm, wn, tid, lane);
    // every warp's selection of the previous tile ended before this
    // tile's first acquire, so the score buffer is free
    tc::store_scores(acc, scores, wm, wn, lane);
    __syncthreads();
    tc::select_tile<kScale, kPrune, S>(scores, scale, tile, v_size, kc, warp,
                                       lane, m_run, s_run, buf_v, buf_i);
  }
  store_partials(m_run, s_run, buf_v, buf_i, row0, warp, lane, split, n_rows,
                 kc, part_v, part_i, part_m, part_s);
}

// Kernel 3: warps 0-7 run the product of tile t into score buffer t & 1
// while warps 8-15 select tile t - 1 from the other.  full[b] completes
// when the eight product warps have stored into buffer b, empty[b] when
// the eight selection warps have read it (one arrival a warp); use u of
// buffer b (tile 2u + b) completes phase u of each, so its parity is
// u & 1.  The selection warps keep the same S-slot buffers as kernel 2's;
// at 512 threads a block a thread has 128 registers, so the four-slot
// instance spills (ptxas).
template <typename TX, int S>
__global__ void __launch_bounds__(2 * tc::kThreads, 1)
tc_pipelined_kernel(const void* x_, const void* table_,
                    const float* __restrict__ /*scale*/, int n_rows, int e,
                    int ldx, int v_size, int ld, int kc, int tiles_per_split,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) char smem[];
  const bool stream = tc::stream_x<TX>(e, true);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 2;
  char* xs = smem + tc::kHeader;
  float* scores = reinterpret_cast<float*>(
      xs + (stream ? 0 : kRowBlock * tc::x_stride<TX>(e)));
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
  const TX* x = static_cast<const TX*>(x_);

  tc::SlabRing<TX, TX, false> ring{
      ring_base, static_cast<const TX*>(table_), stream ? x : nullptr, e,
      v_size, ld, n_slabs, tile_begin, n_local * n_slabs, ldx, n_rows, row0};
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      tc::mbar_init(&full[b], kWarps);
      tc::mbar_init(&empty[b], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (producer) ring.prologue(tid);
  if (!stream) tc::stage_x(x, xs, n_rows, e, ldx, row0, tid, 2 * tc::kThreads);
  __syncthreads();  // the barriers and the x tile; no block barrier after

  if (producer) {
    const int wm = warp & 1, wn = warp >> 1;
    int n = 0;
    for (int t = 0; t < n_local; ++t) {
      float acc[2][4][4];
      // float tables are read in place: no widened slab
      tc::tile_mma(acc, ring, n, xs, nullptr, e, wm, wn, tid, lane);
      const int b = t & 1;
      if (t >= 2) tc::mbar_wait(&empty[b], (uint32_t)((t >> 1) - 1) & 1u);
      tc::store_scores(acc, scores + b * kRowBlock * tc::kScoreStride, wm,
                       wn, lane);
      tc::warp_arrive(&full[b], lane);
    }
    return;
  }
  const int sw = warp - kWarps;
  float m_run[kRowsPerWarp], s_run[kRowsPerWarp], buf_v[kRowsPerWarp][S];
  int buf_i[kRowsPerWarp][S];
  init_rows(m_run, s_run, buf_v, buf_i);
  for (int t = 0; t < n_local; ++t) {
    const int b = t & 1;
    tc::mbar_wait(&full[b], (uint32_t)(t >> 1) & 1u);
    tc::select_tile<false, false, S>(
        scores + b * kRowBlock * tc::kScoreStride, nullptr, tile_begin + t,
        v_size, kc, sw, lane, m_run, s_run, buf_v, buf_i);
    tc::warp_arrive(&empty[b], lane);
  }
  store_partials(m_run, s_run, buf_v, buf_i, row0, sw, lane, split, n_rows,
                 kc, part_v, part_i, part_m, part_s);
}

// The vocab splits' partials of a row merged, a warp a row (kMergeWarps
// rows a block): lse = m + log(sum_s s_s * exp(m_s - m)) with the sum in
// split order (every lane runs it, lane 0 stores it), and the top-kc by
// `beats`.  The running top-kc lies as in the partial kernels (entry p on
// lane p % 32, slot p / 32), and each split's sorted partial is inserted
// entry by entry (insert_entry) until an entry no longer beats the kc-th.
constexpr int kMergeWarps = 4;

template <int S>
__global__ void __launch_bounds__(kMergeWarps * 32)
beamgen_merge_warp_kernel(const float* __restrict__ part_v,
                          const int* __restrict__ part_i,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_s, int n_rows,
                          int kc, int n_split, float* __restrict__ vals,
                          int* __restrict__ idx, float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_m[(size_t)s * n_rows + row]);
  float total = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const size_t at = (size_t)s * n_rows + row;
    total += part_s[at] * expf(part_m[at] - m);
  }
  if (lane == 0) lse[row] = m + logf(total);

  float bv[S];
  int bi[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    bv[j] = -INFINITY;
    bi[j] = kNoIndex;
  }
  for (int s = 0; s < n_split; ++s) {
    const size_t at = ((size_t)s * n_rows + row) * kc;
    float pv[S];
    int pi[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int q = 32 * j + lane;
      pv[j] = q < kc ? part_v[at + q] : -INFINITY;
      pi[j] = q < kc ? part_i[at + q] : kNoIndex;
    }
    for (int q = 0; q < kc; ++q) {
      float cv = pv[0];
      int ci = pi[0];
#pragma unroll
      for (int j = 1; j < S; ++j) {
        if (j == (q >> 5)) {
          cv = pv[j];
          ci = pi[j];
        }
      }
      cv = __shfl_sync(kFull, cv, q & 31);
      ci = __shfl_sync(kFull, ci, q & 31);
      float kth_v;
      int kth_i;
      kth_entry(bv, bi, kc, kth_v, kth_i);
      if (!beats(cv, ci, kth_v, kth_i)) break;  // partials are sorted
      insert_entry(bv, bi, cv, ci, kc, lane);
    }
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int q = 32 * j + lane;
    if (q < kc) {
      vals[(size_t)row * kc + q] = bv[j];
      idx[(size_t)row * kc + q] = bi[j];
    }
  }
}

// The partial kernel of one mode, its block size and dynamic shared memory
// for E = e.
struct Plan {
  PartialFn fn;
  int threads;
  size_t smem;
  size_t elem;    // bytes per table element (the 16-byte rule of ld)
  size_t x_elem;  // bytes per x element (the 16-byte rule of a streamed ldx)
  bool stream;    // streams x by 16-byte copies
};

template <typename TX, typename TW, bool kScale, int S>
PartialFn tc_serial(bool prune) {
  return prune ? tc_serial_kernel<TX, TW, kScale, true, S>
               : tc_serial_kernel<TX, TW, kScale, false, S>;
}

template <typename TX, int S>
Plan plan_x(bool int8_table, bool prune, bool pipeline, int e) {
  const bool stream = tc::stream_x<TX>(e, pipeline);
  const size_t smem = tc::smem_bytes<TX>(e, pipeline, stream);
  if (pipeline)
    return {tc_pipelined_kernel<TX, S>, 2 * tc::kThreads, smem, sizeof(TX),
            sizeof(TX), stream};
  if (int8_table)
    return {tc_serial<TX, int8_t, true, S>(prune), tc::kThreads, smem, 1,
            sizeof(TX), stream};
  return {tc_serial<TX, TX, false, S>(prune), tc::kThreads, smem,
          sizeof(TX), sizeof(TX), stream};
}

template <int S>
Plan plan_slots(int x_dtype, int table_dtype, bool prune, bool pipeline,
                int e) {
  const bool int8_table = table_dtype == 2;
  return x_dtype == 0
             ? plan_x<float, S>(int8_table, prune, pipeline, e)
             : plan_x<tc::bf16, S>(int8_table, prune, pipeline, e);
}

Plan plan(int x_dtype, int table_dtype, bool prune, bool pipeline, int e,
          int kc) {
  switch (slots_for(kc)) {
    case 1:
      return plan_slots<1>(x_dtype, table_dtype, prune, pipeline, e);
    case 2:
      return plan_slots<2>(x_dtype, table_dtype, prune, pipeline, e);
    default:
      return plan_slots<4>(x_dtype, table_dtype, prune, pipeline, e);
  }
}

// Set the plan's dynamic shared memory (a sum past the limit is refused
// here, and the error cleared so the next launch reads clean).
int prepare(const Plan& p) {
  if (p.smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
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

bool valid_shape(int e, int kc) { return e > 0 && kc > 0 && kc <= kMaxK; }

}  // namespace

// The mode's partial kernel at E = e and top-kc: its dynamic shared memory
// in *bytes and whether it streams x (*streamed), for the wrapper's
// `beamgen_smem_bytes` / `beamgen_streams_x` to be held to.  Returns the
// cudaError_t (0 = ok).
extern "C" int cair_beamgen_smem(int e, int kc, int x_dtype, int table_dtype,
                                 int prune, int pipeline, long long* bytes,
                                 int* streamed) {
  if (!valid_shape(e, kc) ||
      !valid_mode(x_dtype, table_dtype, prune, pipeline, table_dtype == 2))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(x_dtype, table_dtype, prune, pipeline, e, kc);
  *bytes = (long long)p.smem;
  *streamed = (int)p.stream;
  return 0;
}

// How many blocks of the mode's partial kernel at E = e and top-kc one SM
// holds at once (the wrapper sizes the vocab split to fill the card with
// them).  Returns the cudaError_t (0 = ok).
extern "C" int cair_beamgen_occupancy(int e, int kc, int x_dtype,
                                      int table_dtype, int prune,
                                      int pipeline, int* blocks) {
  if (!valid_shape(e, kc) ||
      !valid_mode(x_dtype, table_dtype, prune, pipeline, table_dtype == 2))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(x_dtype, table_dtype, prune, pipeline, e, kc);
  int rc = prepare(p);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, p.fn,
                                                            p.threads, p.smem);
}

// x [R, E] with rows ldx >= E elements apart (x_dtype 0 = float32, 1 =
// bfloat16), table_t [E, V] with rows ld elements apart (table_dtype:
// x_dtype for a float table, 2 = int8 with scale [V] float32); scratch
// part_v/part_i [n_split, R, kc], part_m/part_s [n_split, R]; outputs
// vals/idx [R, kc], lse [R].  1 <= kc <= min(kMaxK, V).  prune selects the
// pruned serial kernel, pipeline the pipelined one (float table only, not
// with prune).  Every split must own at least one vocab tile of 128
// columns.  Every kernel needs a 16-byte aligned table with ld * element
// size a multiple of 16; a kernel that streams x (tc::stream_x) needs x
// 16-byte aligned, ldx * element size a multiple of 16 and x's columns
// [E, ldx) finite.  Returns the cudaError_t (0 = ok).
extern "C" int cair_beamgen(const void* x, const void* table,
                            const void* scale, int n_rows, int e, int ldx,
                            int v_size, int ld, int kc, int n_split,
                            int tiles_per_split, void* part_v, void* part_i,
                            void* part_m, void* part_s, void* vals, void* idx,
                            void* lse, int x_dtype, int table_dtype,
                            int prune, int pipeline, void* stream) {
  if (n_rows == 0) return 0;
  if (!valid_shape(e, kc) || kc > v_size || n_split <= 0 || ld < v_size ||
      ldx < e ||
      !valid_mode(x_dtype, table_dtype, prune, pipeline, scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(x_dtype, table_dtype, prune, pipeline, e, kc);
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      ((size_t)ld * p.elem) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (p.stream && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                   ((size_t)ldx * p.x_elem) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  int rc = prepare(p);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_rows + kRowBlock - 1) / kRowBlock, n_split);
  p.fn<<<grid, p.threads, p.smem, s>>>(
      x, table, static_cast<const float*>(scale), n_rows, e, ldx, v_size, ld,
      kc, tiles_per_split, static_cast<float*>(part_v),
      static_cast<int*>(part_i), static_cast<float*>(part_m),
      static_cast<float*>(part_s));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* pv = static_cast<const float*>(part_v);
  const int* pi = static_cast<const int*>(part_i);
  const float* pm = static_cast<const float*>(part_m);
  const float* ps = static_cast<const float*>(part_s);
  float* ov = static_cast<float*>(vals);
  int* oi = static_cast<int*>(idx);
  float* ol = static_cast<float*>(lse);
  const int warp_blocks = (n_rows + kMergeWarps - 1) / kMergeWarps;
  switch (slots_for(kc)) {
    case 1:
      beamgen_merge_warp_kernel<1><<<warp_blocks, kMergeWarps * 32, 0, s>>>(
          pv, pi, pm, ps, n_rows, kc, n_split, ov, oi, ol);
      break;
    case 2:
      beamgen_merge_warp_kernel<2><<<warp_blocks, kMergeWarps * 32, 0, s>>>(
          pv, pi, pm, ps, n_rows, kc, n_split, ov, oi, ol);
      break;
    default:
      beamgen_merge_warp_kernel<4><<<warp_blocks, kMergeWarps * 32, 0, s>>>(
          pv, pi, pm, ps, n_rows, kc, n_split, ov, oi, ol);
      break;
  }
  return (int)cudaGetLastError();
}
