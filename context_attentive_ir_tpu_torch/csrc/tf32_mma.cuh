// Split-TF32 tensor-core tiles: the float32 backward kernels 5 and 9
// (lstm_bwd.cu, gru_bwd.cu) and their phases B and C.
//
// A float32 product on the H100 has two engines: the CUDA cores' exact f32
// FMAs (67 TFLOP/s) and the tensor cores' TF32 (495 TFLOP/s dense), whose
// operands keep 10 of float32's 23 mantissa bits.  Split TF32 keeps about
// 21 of them at a third of the TF32 rate (165 TFLOP/s): each operand v is
// split into hi = tf32(v) (`cvt.rna`'s rounding: to nearest, ties away
// from zero) and lo = v - hi (exact in f32; the tensor core reads its top
// 19 bits, so it enters the product as tf32(v - hi) rounded toward zero),
// and a product is the three terms lo*hi + hi*lo + hi*hi -- lo*lo, below
// 2^-22 of the product, is dropped.  The `mma.sync.aligned.m16n8k8` tiles
// of a k step add the three terms in a fixed order, small terms first: into
// one f32 accumulator (the recompute's products, phases B and C) or the
// small ones and hi*hi into accumulators of their own, added at the end
// (the reverse pass, tf32_rev_product in lstm_mma.cuh).  No atomics
// anywhere: a kernel built on these tiles gives the same bits every run.
//
// Operands are split where a fragment is loaded, from f32 values staged in
// shared memory, by integer ops that round as `cvt.rna` does (the same
// bits; the conversion instruction issued slower, PERF.md): a staged
// float32 weight slab keeps one plane (hi and lo planes would double the
// ring's bytes, halving the hidden sizes one block holds), and
// activations arrive as f32 anyway.
//
// Fragment layouts (PTX ISA, m16n8k8 .tf32), g = lane / 4, tg = lane % 4:
//   A (16 x 8, row): a0 = A[g][tg], a1 = A[g+8][tg], a2 = A[g][tg+4],
//                    a3 = A[g+8][tg+4]
//   B (8 x 8, col):  b0 = B[tg][g],  b1 = B[tg+4][g]
//   C (16 x 8):      c0, c1 = C[g][2tg, 2tg+1]; c2, c3 = C[g+8][2tg, 2tg+1]
// -- the accumulator layout of the bf16 m16n8k16 tile, so the cell updates
// of the recurrent kernels read either tile's accumulators alike.  32 bytes
// of k are one k step of either (16 bf16, 8 f32), and an `ldmatrix.x4` of
// f32 rows, each 8 x 8 b16 matrix read as 8 rows of 4 floats, hands a lane
// exactly the A fragment above (rows from lanes 0-15, k + 4 from lanes
// 16-31) or, of a matrix stored n-major, two n-tiles' B fragments: the byte
// addresses of the bf16 tiles' `ldmatrix` serve both types.  A k-major B
// (a weight slab as the recompute reads it) has no transposing `ldmatrix`
// for 32-bit elements: its fragments are two scalar loads a lane, which a
// slab row stride of 8 words modulo 32 (8 zero columns a staged row) keeps
// free of bank conflicts.

#pragma once

#include "lstm_common.cuh"

namespace cair_lstm {
namespace tf32 {

// v rounded to tf32 as `cvt.rna.tf32.f32` rounds it (to nearest, ties away
// from zero) by integer ops, which issue faster than the conversion: half
// a tf32 ulp added to the magnitude bits, the low 13 bits cleared
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(v), lo = v - hi as an f32 bit pattern: the tensor core reads
// the upper 19 bits of a .tf32 register, so lo enters the product rounded
// toward zero (below 2^-10 of |lo| <= 2^-11 |v| lost) with no rounding op
// of its own
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment split into its hi and lo planes
struct AFrag {
  uint32_t hi[4], lo[4];
};

// a B fragment (b0, b1) split
struct BFrag {
  uint32_t hi0, hi1, lo0, lo1;
};

__device__ __forceinline__ void split_a(AFrag& a, const uint32_t (&raw)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(raw[i]), a.hi[i], a.lo[i]);
}

__device__ __forceinline__ BFrag split_b(float b0, float b1) {
  BFrag b;
  split(b0, b.hi0, b.lo0);
  split(b1, b.hi1, b.lo1);
  return b;
}

// term 0, 1, 2 of d += a * b in split TF32: lo*hi, hi*lo, hi*hi, added in
// that order (a caller interleaves the terms of independent accumulators)
__device__ __forceinline__ void mma_term(float (&d)[4], const AFrag& a,
                                         const BFrag& b, int term) {
  if (term == 0)
    mma(d, a.lo, b.hi0, b.hi1);
  else if (term == 1)
    mma(d, a.hi, b.lo0, b.lo1);
  else
    mma(d, a.hi, b.hi0, b.hi1);
}

}  // namespace tf32

// -- phases B and C in split TF32 -------------------------------------------
//
// out[z][m][out_col0 + n] (rows of out_ld floats) = sum over the k of split
// z of A(m, k) * B(k, n), for M x N outputs in 128 x 128 tiles, a block of
// 8 warps (2 x 4 warps of 64 x 32), k in slabs of kWgK through a
// kWgStages-deep `cp.async` ring of 16-byte copies where the operands allow
// them (kVec: 16-byte aligned, leading dimensions and the extents a copy
// runs along multiples of 4), else of 4-byte copies (the float32 step
// route's any E and H); past the matrices zero-filled.  A lies
// k-major, a[k * lda + m] (kAM false: phase B's x, h_prev) or m-major,
// a[m * lda + k] (phase C's dgates); B k-major, b[k * ldb + n] (phase B's
// gradient slots) or n-major, b[n * ldb + k] (phase C's W_ih, read
// untransposed: dx = dgates @ W_ih^T).  m-major and n-major slabs are read
// by `ldmatrix`, k-major ones by scalar loads; the three split products of
// each fragment pair run in a fixed order, each slab's into a fresh
// accumulator that f32 adds then promote into the tile's sum (the tensor
// core's accumulation does not round to nearest: over a split's thousands
// of rows it biased dW by up to 8.8e-5 of its largest value, PERF.md), so
// a partial is the same bits every run.
constexpr int kTfKRow = kWgTile + 8;     // floats a k-major slab row
constexpr int kTfMRow = kWgK + 4;        // floats an m- (n-) major slab row
constexpr int kTfKSlab = kWgK * kTfKRow;  // floats of a k-major slab
constexpr int kTfMSlab = kWgTile * kTfMRow;

__host__ __device__ constexpr int tf_slab(bool mn_major) {
  return mn_major ? kTfMSlab : kTfKSlab;
}
__host__ __device__ constexpr int tf_smem(bool am, bool bn) {
  return kWgStages * (tf_slab(am) + tf_slab(bn)) * 4;
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tiles::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

template <bool kAM, bool kBN, bool kVec>
__global__ void __launch_bounds__(256)
wgrad_tf32_kernel(const float* __restrict__ a, int lda, int m_count,
                  const float* __restrict__ b, int ldb, int n_count,
                  int k_count, int k_per_split, float* __restrict__ out,
                  int out_ld, int out_col0) {
  extern __shared__ __align__(16) float tf_buf[];
  constexpr int kStage = tf_slab(kAM) + tf_slab(kBN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.x * kWgTile;
  const int n0 = blockIdx.y * kWgTile;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k_count, k_begin + k_per_split);
  const int n_iter =
      k_end > k_begin ? (k_end - k_begin + kWgK - 1) / kWgK : 0;

  // one operand's slab: kWgK k values of kWgTile m (n) values, from p with
  // leading dimension ld and `count` m (n) values in all
  auto load_operand = [&](float* s, const float* p, int ld, int count,
                          int base, int kb, bool mn_major) {
    if constexpr (kVec) {
      for (int idx = threadIdx.x; idx < kWgK * kWgTile / 4; idx += 256) {
        if (mn_major) {
          const int i = idx / (kWgK / 4), kk = (idx - i * (kWgK / 4)) * 4;
          const bool v = base + i < count && kb + kk < k_end;
          tiles::cp_async16(s + i * kTfMRow + kk,
                            v ? p + (size_t)(base + i) * ld + kb + kk : p, v);
        } else {
          const int kk = idx / (kWgTile / 4);
          const int i = (idx - kk * (kWgTile / 4)) * 4;
          const bool v = base + i < count && kb + kk < k_end;
          tiles::cp_async16(s + kk * kTfKRow + i,
                            v ? p + (size_t)(kb + kk) * ld + base + i : p, v);
        }
      }
      return;
    }
    for (int idx = threadIdx.x; idx < kWgK * kWgTile; idx += 256) {
      if (mn_major) {
        const int i = idx / kWgK, kk = idx - i * kWgK;
        const bool v = base + i < count && kb + kk < k_end;
        cp_async4(s + i * kTfMRow + kk,
                  v ? p + (size_t)(base + i) * ld + kb + kk : p, v);
      } else {
        const int kk = idx / kWgTile, i = idx - kk * kWgTile;
        const bool v = base + i < count && kb + kk < k_end;
        cp_async4(s + kk * kTfKRow + i,
                  v ? p + (size_t)(kb + kk) * ld + base + i : p, v);
      }
    }
  };
  auto load = [&](int it) {
    float* as = tf_buf + (it % kWgStages) * kStage;
    const int kb = k_begin + it * kWgK;
    load_operand(as, a, lda, m_count, m0, kb, kAM);
    load_operand(as + tf_slab(kAM), b, ldb, n_count, n0, kb, kBN);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  for (int p = 0; p < kWgStages - 1; ++p) {
    if (p < n_iter) load(p);
    tiles::cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    tiles::cp_async_wait<kWgStages - 2>();
    __syncthreads();
    if (it + kWgStages - 1 < n_iter) load(it + kWgStages - 1);
    tiles::cp_async_commit();
    const float* as = tf_buf + (it % kWgStages) * kStage;
    const float* bs = as + tf_slab(kAM);
    // a slab's sums start from 0 in the tensor core's accumulator and are
    // added into acc by f32 adds: the accumulator's own adds do not round
    // to nearest, which over thousands of k would bias a long sum
    float part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][j][v] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kWgK; kk += 8) {
      tf32::AFrag af[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int mb = wm * 64 + mt * 16;
        if constexpr (kAM) {
          uint32_t raw[4];
          tiles::ldsm_x4(raw, as + (mb + (lane & 15)) * kTfMRow + kk +
                                  (lane >> 4) * 4);
          tf32::split_a(af[mt], raw);
        } else {
          const float* r0 = as + (kk + tg) * kTfKRow + mb + g;
          const float* r1 = r0 + 4 * kTfKRow;
          tf32::split(r0[0], af[mt].hi[0], af[mt].lo[0]);
          tf32::split(r0[8], af[mt].hi[1], af[mt].lo[1]);
          tf32::split(r1[0], af[mt].hi[2], af[mt].lo[2]);
          tf32::split(r1[8], af[mt].hi[3], af[mt].lo[3]);
        }
      }
      tf32::BFrag bf[4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nb = wn * 32 + np * 16;
        if constexpr (kBN) {
          uint32_t raw[4];
          tiles::ldsm_x4(raw, bs + (nb + (lane & 7) + (lane >> 4) * 8) *
                                       kTfMRow +
                                   kk + ((lane >> 3) & 1) * 4);
          bf[2 * np] = tf32::split_b(__uint_as_float(raw[0]),
                                     __uint_as_float(raw[1]));
          bf[2 * np + 1] = tf32::split_b(__uint_as_float(raw[2]),
                                         __uint_as_float(raw[3]));
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* r0 = bs + (kk + tg) * kTfKRow + nb + h * 8 + g;
            bf[2 * np + h] = tf32::split_b(r0[0], r0[4 * kTfKRow]);
          }
        }
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tf32::mma_term(part[mt][nt], af[mt], bf[nt], term);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + wm * 64 + mt * 16 + g + (v >> 1) * 8;
        const int nn = n0 + wn * 32 + nt * 8 + 2 * tg + (v & 1);
        if (m < m_count && nn < n_count)
          out[((size_t)blockIdx.z * m_count + m) * out_ld + out_col0 + nn] =
              acc[mt][nt][v];
      }
}

template <bool kAM, bool kBN>
inline cudaError_t launch_tf32(const float* a, int lda, int m_count,
                               const float* b, int ldb, int n_count,
                               int k_count, Splits sp, float* out, int out_ld,
                               int out_col0, cudaStream_t stream) {
  // 16-byte copies: aligned operands, a copy's four floats all inside an
  // extent or all past it
  const auto runs = [&](bool mn_major, int count) {
    return mn_major ? k_count % 4 == 0 && sp.rows_per_split % 4 == 0
                    : count % 4 == 0;
  };
  const bool vec = tiles::aligned16(a) && tiles::aligned16(b) &&
                   lda % 4 == 0 && ldb % 4 == 0 && runs(kAM, m_count) &&
                   runs(kBN, n_count);
  auto* kernel = vec ? wgrad_tf32_kernel<kAM, kBN, true>
                     : wgrad_tf32_kernel<kAM, kBN, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tf_smem(kAM, kBN));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((m_count + kWgTile - 1) / kWgTile,
                (n_count + kWgTile - 1) / kWgTile, sp.splits),
           256, tf_smem(kAM, kBN), stream>>>(a, lda, m_count, b, ldb, n_count,
                                             k_count, sp.rows_per_split, out,
                                             out_ld, out_col0);
  return cudaGetLastError();
}

// Phase B in float32: partial[z][m][out_col0 + c] = sum over the rows r of
// split z of a[r][m] * g[r][c] (a [n_rows, a_cols], g at columns c <
// g_cols of rows g_ld apart), launch_wgrad_partial's float32 form.
inline cudaError_t launch_wgrad_tf32(const float* a, int a_cols,
                                     const float* g, int g_cols, int g_ld,
                                     int n_rows, Splits sp, float* partial,
                                     int out_ld, int out_col0,
                                     cudaStream_t stream) {
  return launch_tf32<false, false>(a, a_cols, a_cols, g, g_ld, g_cols, n_rows,
                                   sp, partial, out_ld, out_col0, stream);
}

// Phase C in float32: out [n_rows, n_cols] = a [n_rows, k_dim] (rows lda
// apart) @ w^T, w [n_cols, k_dim] (rows ldw apart) -- dx = dgates_c @
// W_ih^T with W_ih [E, gates * H] read as it lies.
inline cudaError_t launch_matmul_tf32(const float* a, int lda, const float* w,
                                      int ldw, int n_rows, int n_cols,
                                      int k_dim, float* out,
                                      cudaStream_t stream) {
  const Splits one = {1, k_dim};
  return launch_tf32<true, true>(a, lda, n_rows, w, ldw, n_cols, k_dim, one,
                                 out, n_cols, 0, stream);
}

// One phase-B product: float32 in split TF32 (launch_wgrad_tf32); bf16 on
// the tensor-core kernel where its operands are aligned, else
// wgrad_partial_kernel's f32 FMAs (lstm_common.cuh).
template <typename T>
inline cudaError_t launch_wgrad_partial(const T* a, int a_cols, const T* g,
                                        int g_cols, int g_ld, int n_rows,
                                        Splits sp, float* partial, int out_ld,
                                        int out_col0, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_wgrad_tf32(a, a_cols, g, g_cols, g_ld, n_rows, sp, partial,
                             out_ld, out_col0, stream);
  } else {
    if (tiles::aligned16(a) && tiles::aligned16(g) && a_cols % 8 == 0 &&
        g_cols % 8 == 0 && g_ld % 8 == 0) {
      auto* kernel = wgrad_partial_mma_kernel<T, false, float>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem(false));
      if (err != cudaSuccess) return err;
      kernel<<<dim3((a_cols + kWgTile - 1) / kWgTile,
                    (g_cols + kWgTile - 1) / kWgTile, sp.splits),
               256, wg_smem(false), stream>>>(
          a, a_cols, g, g_cols, g_ld, n_rows, sp.rows_per_split, partial,
          out_ld, out_col0, 0);
      return cudaGetLastError();
    }
    wgrad_partial_kernel<T><<<dim3((a_cols + kTile - 1) / kTile,
                                   (g_cols + kTile - 1) / kTile, sp.splits),
                              256, 0, stream>>>(a, a_cols, g, g_cols, g_ld,
                                                n_rows, sp.rows_per_split,
                                                partial, out_ld, out_col0);
    return cudaGetLastError();
  }
}

}  // namespace cair_lstm
