// Device pieces shared by the serial (kernel 2) and pipelined (kernel 3)
// generator kernels in beamgen.cu: the block geometry, the score tile's
// FMA loop and the per-row online logsumexp + running top-kc update.
// Both kernels run these very functions, in the same order over k and over
// the vocab tiles, so their outputs are the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace beamgen {

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
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
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

// x rows [row0, row0 + kRowBlock) of x [n_rows, e] into shared memory as
// f32, k-major: xs[k * kRowBlock + r] (rows past n_rows read 0).
template <typename TX>
__device__ __forceinline__ void stage_x(const TX* __restrict__ x, float* xs,
                                        int n_rows, int e, int row0) {
  for (int i = threadIdx.x; i < kRowBlock * e; i += blockDim.x) {
    const int r = i / e;
    const int k = i - r * e;
    const int row = row0 + r;
    xs[k * kRowBlock + r] =
        row < n_rows ? to_f32(x[(size_t)row * e + k]) : 0.0f;
  }
}

template <typename TW, bool kGlobal>
__device__ __forceinline__ float load_w(const TW* p) {
  if constexpr (kGlobal) {
    return to_f32(__ldg(p));
  } else {
    return to_f32(*p);
  }
}

// acc[r][c] += sum over k in [k0, k1) of x[row r][k] * table[k][col c] for
// the warp's 8 rows (a_base: xs at the warp's first row) and the lane's 4
// columns (w: table row k0 at the lane's first column, consecutive k rows
// `stride` elements apart, the lane's columns 32 apart).  One fmaf per
// product, k ascending: the same sequence in every kernel.
template <typename TW, bool kGlobal>
__device__ __forceinline__ void tile_fma(float (&acc)[kRowsPerWarp][kColsPerLane],
                                         const float* a_base,
                                         const TW* w, size_t stride, int k0,
                                         int k1,
                                         const bool (&ok)[kColsPerLane]) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4* a4 = reinterpret_cast<const float4*>(a_base + k * kRowBlock);
    const float4 lo = a4[0];
    const float4 hi = a4[1];
    const float a[kRowsPerWarp] = {lo.x, lo.y, lo.z, lo.w,
                                   hi.x, hi.y, hi.z, hi.w};
    const TW* wr = w + (size_t)(k - k0) * stride;
    float wv[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      wv[c] = ok[c] ? load_w<TW, kGlobal>(wr + 32 * c) : 0.0f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        acc[r][c] = fmaf(a[r], wv[c], acc[r][c]);
    }
  }
}

// One row's scores of one tile (v: the lane's columns, vi their vocab ids,
// ok whether they exist) folded into the row's online logsumexp (m_run,
// s_run) and running top-kc (lane l < kc holds buffer slot l).  kPrune
// skips the selection passes when no lane beats the running kc-th entry:
// they would rebuild the same buffer, since tiles arrive in ascending vocab
// order and ties go to the lower index.
template <bool kPrune>
__device__ __forceinline__ void tile_select(const float (&v)[kColsPerLane],
                                            const int (&vi)[kColsPerLane],
                                            const bool (&ok)[kColsPerLane],
                                            float& m_run, float& s_run,
                                            float& buf_v, int& buf_i, int kc,
                                            int lane) {
  float tmax = -INFINITY;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) tmax = fmaxf(tmax, v[c]);
  // online logsumexp; every tile holds at least one real column
  const float m_new = fmaxf(m_run, warp_max(tmax));
  float se = 0.0f;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c)
    if (ok[c]) se += expf(v[c] - m_new);
  s_run = s_run * expf(m_run - m_new) + warp_sum(se);
  m_run = m_new;

  if constexpr (kPrune) {
    const float kth_v = __shfl_sync(kFull, buf_v, kc - 1);
    const int kth_i = __shfl_sync(kFull, buf_i, kc - 1);
    bool gain = false;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      gain |= ok[c] && beats(v[c], vi[c], kth_v, kth_i);
    if (!__any_sync(kFull, gain)) return;
  }

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
        (slot < 0 || beats(buf_v, buf_i, lv, li))) {
      lv = buf_v;
      li = buf_i;
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
    buf_v = new_v;
    buf_i = new_i;
  }
}

// The warp's rows' partial results for its vocab split.
__device__ __forceinline__ void store_partials(
    const float (&m_run)[kRowsPerWarp], const float (&s_run)[kRowsPerWarp],
    const float (&buf_v)[kRowsPerWarp], const int (&buf_i)[kRowsPerWarp],
    int row0, int warp, int lane, int split, int n_rows, int kc,
    float* __restrict__ part_v, int* __restrict__ part_i,
    float* __restrict__ part_m, float* __restrict__ part_s) {
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

}  // namespace beamgen
