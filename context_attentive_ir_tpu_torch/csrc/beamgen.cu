// Fused tied-generator step for Hopper (sm_90a): top-kc + logsumexp of
// x [R, E] @ table_t [E, V] without writing the [R, V] logits.
//
// Replaces the TPU kernel `_beamgen_kernel` / `generator_topk_lse` (serial,
// float table) in context_attentive_ir_tpu/ops/pallas/beamgen.py.  Outputs:
// vals [R, kc] f32 and idx [R, kc] i32 (descending, ties to the LOWER vocab
// index, exactly as lax.top_k) and lse [R] f32.
//
// What bounds it on the H100: at the beam-5 serving shape (R = 1600,
// E = 256, V = 50,000) one call is 2*R*E*V = 4.1e10 flops (41 us at the
// 989 TFLOP/s bf16 tensor-core peak) against a 25.6 MB bf16 table (8 us at
// 3.35 TB/s): compute-bound.
//
// Design (first, simple version): the TPU sweeps the vocab in order on one
// core with the running top-k and (max, sumexp) in VMEM.  Blocks on Hopper
// run in parallel and share nothing, so the vocab is split: block
// (row_block, split) owns 64 rows and a contiguous run of 128-column vocab
// tiles, and writes a partial top-kc plus its (max, sumexp) pair; a second,
// tiny kernel merges the splits per row with the same tie rule and the
// log-sum-exp merge m + log(sum_s s_s * exp(m_s - m)).  The split count
// (`cair_beamgen_splits`) fills the SMs (R = 320 greedy rows give only
// five row blocks).  Inside a block each warp owns 8 rows and each lane 4 columns
// of a tile, so the f32 FMA accumulators of the score tile are already laid
// out for the per-row selection: no shared-memory round trip.  A tile joins
// the top-kc only when some lane beats the running kc-th entry (warp vote);
// then kc warp-argmax passes over [tile | buffer] rebuild the buffer.  The
// scores use CUDA-core FMAs (no tensor cores yet), so the kernel runs far
// above its bound; wgmma on bf16 tiles is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowBlock = kWarps * kRowsPerWarp;  // 64 rows per block
constexpr int kColsPerLane = 4;
constexpr int kTile = 32 * kColsPerLane;  // 128 vocab columns per tile
constexpr int kMaxK = 32;
constexpr int kNoIndex = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a ranks before b: larger value, or equal value and lower index
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
beamgen_partial_kernel(const T* __restrict__ x, const T* __restrict__ table,
                       int n_rows, int e, int v_size, int kc,
                       int tiles_per_split, float* __restrict__ part_v,
                       int* __restrict__ part_i, float* __restrict__ part_m,
                       float* __restrict__ part_s) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [e][kRowBlock]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int split = blockIdx.y;
  const int n_tiles = (v_size + kTile - 1) / kTile;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);

  for (int i = tid; i < kRowBlock * e; i += blockDim.x) {
    const int r = i / e;
    const int k = i - r * e;
    const int row = row0 + r;
    xs[k * kRowBlock + r] =
        row < n_rows ? to_f32(x[(size_t)row * e + k]) : 0.0f;
  }
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
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) ok[c] = col0 + 32 * c < v_size;

    float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < e; ++k) {
      const float4* a4 = reinterpret_cast<const float4*>(a_base + k * kRowBlock);
      const float4 lo = a4[0];
      const float4 hi = a4[1];
      const float a[kRowsPerWarp] = {lo.x, lo.y, lo.z, lo.w,
                                     hi.x, hi.y, hi.z, hi.w};
      const T* tr = table + (size_t)k * v_size + col0;
      float w[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        w[c] = ok[c] ? to_f32(__ldg(tr + 32 * c)) : 0.0f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[r][c] += a[r] * w[c];
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float v[kColsPerLane];
      int vi[kColsPerLane];
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        v[c] = ok[c] ? acc[r][c] : -INFINITY;
        vi[c] = ok[c] ? col0 + 32 * c : kNoIndex;
        tmax = fmaxf(tmax, v[c]);
      }
      // online logsumexp; every tile holds at least one real column
      const float m_new = fmaxf(m_run[r], warp_max(tmax));
      float se = 0.0f;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        if (ok[c]) se += expf(v[c] - m_new);
      s_run[r] = s_run[r] * expf(m_run[r] - m_new) + warp_sum(se);
      m_run[r] = m_new;

      // running top-kc: skip the tile unless a lane beats the kc-th entry
      const float kth_v = __shfl_sync(kFull, buf_v[r], kc - 1);
      const int kth_i = __shfl_sync(kFull, buf_i[r], kc - 1);
      bool gain = false;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        gain |= ok[c] && beats(v[c], vi[c], kth_v, kth_i);
      if (!__any_sync(kFull, gain)) continue;

      unsigned taken = 0;  // bit c: tile column c, bit kColsPerLane: buffer
      float new_v = -INFINITY;
      int new_i = kNoIndex;
      for (int p = 0; p < kc; ++p) {
        float lv = -INFINITY;
        int li = kNoIndex;
        int slot = -1;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          if (ok[c] && !(taken >> c & 1u) &&
              (slot < 0 || beats(v[c], vi[c], lv, li))) {
            lv = v[c];
            li = vi[c];
            slot = c;
          }
        }
        if (lane < kc && !(taken >> kColsPerLane & 1u) &&
            (slot < 0 || beats(buf_v[r], buf_i[r], lv, li))) {
          lv = buf_v[r];
          li = buf_i[r];
          slot = kColsPerLane;
        }
        float gv = lv;
        int gi = li;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, gv, off);
          const int oi = __shfl_xor_sync(kFull, gi, off);
          if (beats(ov, oi, gv, gi)) {
            gv = ov;
            gi = oi;
          }
        }
        const unsigned owners =
            __ballot_sync(kFull, slot >= 0 && lv == gv && li == gi);
        if (owners != 0 && lane == __ffs(owners) - 1) taken |= 1u << slot;
        if (lane == p) {
          new_v = gv;
          new_i = gi;
        }
      }
      if (lane < kc) {
        buf_v[r] = new_v;
        buf_i[r] = new_i;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    const size_t at = (size_t)split * n_rows + row;
    if (lane < kc) {
      part_v[at * kc + lane] = buf_v[r];
      part_i[at * kc + lane] = buf_i[r];
    }
    if (lane == 0) {
      part_m[at] = m_run[r];
      part_s[at] = s_run[r];
    }
  }
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

template <typename T>
int launch(const void* x, const void* table, int n_rows, int e, int v_size,
           int kc, int n_split, int tiles_per_split, void* part_v,
           void* part_i, void* part_m, void* part_s, void* vals, void* idx,
           void* lse, cudaStream_t stream) {
  const size_t smem = (size_t)e * kRowBlock * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      beamgen_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {  // e.g. E too large for the shared tile
    cudaGetLastError();      // clear it so the next launch reads clean
    return (int)err;
  }
  const dim3 grid((n_rows + kRowBlock - 1) / kRowBlock, n_split);
  beamgen_partial_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(table), n_rows, e,
      v_size, kc, tiles_per_split, static_cast<float*>(part_v),
      static_cast<int*>(part_i), static_cast<float*>(part_m),
      static_cast<float*>(part_s));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  beamgen_merge_kernel<<<(n_rows + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      n_rows, kc, n_split, static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse));
  return (int)cudaGetLastError();
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

// x [R, E], table_t [E, V] (contiguous, one dtype: 0 = float32,
// 1 = bfloat16); scratch part_v/part_i [n_split, R, kc], part_m/part_s
// [n_split, R]; outputs vals/idx [R, kc], lse [R].  Every split must own at
// least one vocab tile of 128 columns.  Returns the cudaError_t (0 = ok).
extern "C" int cair_beamgen(const void* x, const void* table, int n_rows,
                            int e, int v_size, int kc, int n_split,
                            int tiles_per_split, void* part_v, void* part_i,
                            void* part_m, void* part_s, void* vals, void* idx,
                            void* lse, int dtype, void* stream) {
  if (n_rows == 0) return 0;
  if (kc <= 0 || kc > kMaxK || kc > v_size || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, table, n_rows, e, v_size, kc, n_split,
                         tiles_per_split, part_v, part_i, part_m, part_s,
                         vals, idx, lse, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, table, n_rows, e, v_size, kc, n_split,
                                 tiles_per_split, part_v, part_i, part_m,
                                 part_s, vals, idx, lse, s);
  return (int)cudaErrorInvalidValue;
}
