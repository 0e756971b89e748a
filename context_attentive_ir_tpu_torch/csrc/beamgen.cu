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
// Design (first, simple versions): the TPU sweeps the vocab in order on one
// core with the running top-k and (max, sumexp) in VMEM.  Blocks on Hopper
// run in parallel and share nothing, so the vocab is split: block
// (row_block, split) owns 64 rows and a contiguous run of 128-column vocab
// tiles, and writes a partial top-kc plus its (max, sumexp) pair; a second,
// tiny kernel merges the splits per row with the same tie rule and the
// log-sum-exp merge m + log(sum_s s_s * exp(m_s - m)).  The split count
// (`cair_beamgen_splits`) fills the SMs (R = 320 greedy rows give only
// five row blocks).  Inside a block each warp owns 8 rows and each lane 4
// columns of a tile, so the f32 FMA accumulators of the score tile are
// already laid out for the per-row selection: no shared-memory round trip
// (beamgen_common.cuh).  With `prune` a row skips a tile's kc warp-argmax
// passes when no lane beats its running kc-th entry (warp vote); without,
// every tile runs them, as the TPU's unpruned kernel.
//
// Kernel 3 overlaps what the TPU overlaps with its double-buffered score
// scratch, the next tile's data with this tile's work: here the table
// arrives in shared memory through a two-stage cp.async ring of k-chunks
// (32 KB per stage: 128 rows of a bf16 tile, 64 of an f32 one), so the
// copy of chunk u+1 runs under the FMAs (and, at a tile's last chunk, the
// selection) of chunk u.  Kernel 2 reads the table straight from global
// memory (L2).  Both call the same tile_fma / tile_select in the
// same order, so kernel 3 gives kernel 2's bits.  The 16-byte copies need a
// 16-byte aligned table whose rows are a multiple of 16 bytes; the launcher
// refuses any other table.  Scores use CUDA-core FMAs (no tensor cores
// yet), so both run far above their bound; wgmma on bf16 tiles is the
// later step.

#include "beamgen_common.cuh"

namespace {

using namespace beamgen;

template <typename TX, typename TW, bool kScale, bool kPrune>
__global__ void __launch_bounds__(kWarps * 32)
beamgen_partial_kernel(const TX* __restrict__ x, const TW* __restrict__ table,
                       const float* __restrict__ scale, int n_rows, int e,
                       int v_size, int kc, int tiles_per_split,
                       float* __restrict__ part_v, int* __restrict__ part_i,
                       float* __restrict__ part_m,
                       float* __restrict__ part_s) {
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
    tile_fma<TW, true>(acc, a_base, table + col0, v_size, 0, e, ok);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float v[kColsPerLane];
      int vi[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const float logit = kScale ? acc[r][c] * scl[c] : acc[r][c];
        v[c] = ok[c] ? logit : -INFINITY;
        vi[c] = ok[c] ? col0 + 32 * c : kNoIndex;
      }
      tile_select<kPrune>(v, vi, ok, m_run[r], s_run[r], buf_v[r], buf_i[r],
                          kc, lane);
    }
  }
  store_partials(m_run, s_run, buf_v, buf_i, row0, warp, lane, split, n_rows,
                 kc, part_v, part_i, part_m, part_s);
}

// table rows of one k-chunk staged per ring slot: 32 KB per stage
template <typename T>
__host__ __device__ constexpr int chunk_rows() {
  return 32768 / (kTile * (int)sizeof(T));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start the copy of table rows [k0, k1) x tile columns into a ring slot
// [chunk_rows][kTile]; columns past v_size are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ table,
                                            T* stage, int v_size, int tile,
                                            int k0, int k1) {
  constexpr int kPerCopy = 16 / sizeof(T);
  constexpr int kCopiesPerRow = kTile / kPerCopy;
  const int n = (k1 - k0) * kCopiesPerRow;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = i / kCopiesPerRow;
    const int piece = i - row * kCopiesPerRow;
    const int col = tile * kTile + piece * kPerCopy;
    const bool in = col < v_size;  // rows hold whole 16-byte pieces
    const T* src = in ? table + (size_t)(k0 + row) * v_size + col : table;
    cp_async16(stage + row * kTile + piece * kPerCopy, src, in ? 16 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
beamgen_pipelined_kernel(const T* __restrict__ x, const T* __restrict__ table,
                         int n_rows, int e, int v_size, int kc,
                         int tiles_per_split, float* __restrict__ part_v,
                         int* __restrict__ part_i, float* __restrict__ part_m,
                         float* __restrict__ part_s) {
  constexpr int kChunk = chunk_rows<T>();
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [e][kRowBlock]
  T* ring = reinterpret_cast<T*>(xs + e * kRowBlock);  // [2][kChunk][kTile]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int split = blockIdx.y;
  const int n_tiles = (v_size + kTile - 1) / kTile;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const int n_chunks = (e + kChunk - 1) / kChunk;
  const int n_units = max(0, tile_end - tile_begin) * n_chunks;

  if (n_units > 0)
    stage_chunk(table, ring, v_size, tile_begin, 0, min(e, kChunk));
  cp_async_commit();
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
      const int nk0 = ((u + 1) % n_chunks) * kChunk;
      stage_chunk(table, ring + ((u + 1) & 1) * kChunk * kTile, v_size, nt,
                  nk0, min(e, nk0 + kChunk));
    }
    cp_async_commit();
    cp_async_wait_prior();  // this thread's copies of chunk u have landed
    __syncthreads();        // ... and everyone's (and xs, at u = 0)

    const int tile = tile_begin + u / n_chunks;
    const int chunk = u % n_chunks;
    const int k0 = chunk * kChunk;
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
    tile_fma<T, false>(acc, a_base, ring + (u & 1) * kChunk * kTile + lane,
                       kTile, k0, min(e, k0 + kChunk), ok);
    if (chunk == n_chunks - 1) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float v[kColsPerLane];
        int vi[kColsPerLane];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          v[c] = ok[c] ? acc[r][c] : -INFINITY;
          vi[c] = ok[c] ? col0 + 32 * c : kNoIndex;
        }
        tile_select<false>(v, vi, ok, m_run[r], s_run[r], buf_v[r],
                           buf_i[r], kc, lane);
      }
    }
    __syncthreads();  // slot u & 1 is refilled at iteration u + 1
  }
  store_partials(m_run, s_run, buf_v, buf_i, row0, warp, lane, split, n_rows,
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

struct Args {
  const void* x;
  const void* table;
  const float* scale;
  int n_rows, e, v_size, kc, n_split, tiles_per_split;
  float* part_v;
  int* part_i;
  float* part_m;
  float* part_s;
  float* vals;
  int* idx;
  float* lse;
  cudaStream_t stream;
};

// Set the kernel's dynamic shared memory and launch it on the (row block,
// split) grid, then the merge; returns the first cudaError_t (an E too
// large for the shared tile is refused here, and the error cleared so the
// next launch reads clean).
template <typename Kernel, typename... KArgs>
int launch(Kernel kernel, size_t smem, const Args& a, KArgs... kargs) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const dim3 grid((a.n_rows + kRowBlock - 1) / kRowBlock, a.n_split);
  kernel<<<grid, kWarps * 32, smem, a.stream>>>(kargs...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  beamgen_merge_kernel<<<(a.n_rows + 127) / 128, 128, 0, a.stream>>>(
      a.part_v, a.part_i, a.part_m, a.part_s, a.n_rows, a.kc, a.n_split,
      a.vals, a.idx, a.lse);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, bool kScale, bool kPrune>
int launch_serial(const Args& a) {
  return launch(beamgen_partial_kernel<TX, TW, kScale, kPrune>,
                (size_t)a.e * kRowBlock * sizeof(float), a,
                static_cast<const TX*>(a.x), static_cast<const TW*>(a.table),
                a.scale, a.n_rows, a.e, a.v_size, a.kc, a.tiles_per_split,
                a.part_v, a.part_i, a.part_m, a.part_s);
}

template <typename TX, typename TW, bool kScale>
int launch_serial(const Args& a, bool prune) {
  return prune ? launch_serial<TX, TW, kScale, true>(a)
               : launch_serial<TX, TW, kScale, false>(a);
}

template <typename T>
int launch_pipelined(const Args& a) {
  if (reinterpret_cast<uintptr_t>(a.table) % 16 != 0 ||
      ((size_t)a.v_size * sizeof(T)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = (size_t)a.e * kRowBlock * sizeof(float) +
                      2 * (size_t)chunk_rows<T>() * kTile * sizeof(T);
  return launch(beamgen_pipelined_kernel<T>, smem, a,
                static_cast<const T*>(a.x), static_cast<const T*>(a.table),
                a.n_rows, a.e, a.v_size, a.kc, a.tiles_per_split, a.part_v,
                a.part_i, a.part_m, a.part_s);
}

}  // namespace

// The vocab split for R rows on n_sm SMs: enough blocks for two per SM,
// every split owning at least one tile.  Writes the split count and the
// tiles per split (the scratch of cair_beamgen is [n_split, R, ...]).
extern "C" int cair_beamgen_splits(int n_rows, int v_size, int n_sm,
                                   int* n_split, int* tiles_per_split) {
  if (v_size <= 0 || n_sm <= 0) return (int)cudaErrorInvalidValue;
  const int row_blocks = max(1, (n_rows + kRowBlock - 1) / kRowBlock);
  const int tiles = (v_size + kTile - 1) / kTile;
  const int want =
      max(1, min(tiles, (2 * n_sm + row_blocks - 1) / row_blocks));
  *tiles_per_split = (tiles + want - 1) / want;
  *n_split = (tiles + *tiles_per_split - 1) / *tiles_per_split;
  return 0;
}

// x [R, E] (x_dtype 0 = float32, 1 = bfloat16), table_t [E, V]
// (table_dtype: x_dtype for a float table, 2 = int8 with scale [V] float32),
// all contiguous; scratch part_v/part_i [n_split, R, kc], part_m/part_s
// [n_split, R]; outputs vals/idx [R, kc], lse [R].  prune selects the
// pruned serial kernel, pipeline the pipelined one (float table only, not
// with prune).  Every split must own at least one vocab tile of 128
// columns.  Returns the cudaError_t (0 = ok).
extern "C" int cair_beamgen(const void* x, const void* table,
                            const void* scale, int n_rows, int e, int v_size,
                            int kc, int n_split, int tiles_per_split,
                            void* part_v, void* part_i, void* part_m,
                            void* part_s, void* vals, void* idx, void* lse,
                            int x_dtype, int table_dtype, int prune,
                            int pipeline, void* stream) {
  if (n_rows == 0) return 0;
  if (kc <= 0 || kc > kMaxK || kc > v_size || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  const bool int8_table = table_dtype == 2;
  if (int8_table != (scale != nullptr) ||
      (!int8_table && table_dtype != x_dtype) || (pipeline && prune) ||
      (pipeline && int8_table) || (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{x, table, static_cast<const float*>(scale), n_rows, e, v_size,
               kc, n_split, tiles_per_split, static_cast<float*>(part_v),
               static_cast<int*>(part_i), static_cast<float*>(part_m),
               static_cast<float*>(part_s), static_cast<float*>(vals),
               static_cast<int*>(idx), static_cast<float*>(lse),
               static_cast<cudaStream_t>(stream)};
  if (pipeline)
    return x_dtype == 0 ? launch_pipelined<float>(a)
                        : launch_pipelined<__nv_bfloat16>(a);
  if (int8_table)
    return x_dtype == 0 ? launch_serial<float, int8_t, true>(a, prune)
                        : launch_serial<__nv_bfloat16, int8_t, true>(a, prune);
  return x_dtype == 0 ? launch_serial<float, float, false>(a, prune)
                      : launch_serial<__nv_bfloat16, __nv_bfloat16, false>(
                            a, prune);
}
