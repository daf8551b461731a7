// Float64 tensor-core building blocks of the gate kernels (gated_block_attn.cu:
// the LN-folded gate signature K6c; mincut_gate_block.cu: the min-cut gate K7).
//
// The gate logits (X A_sig) X^T must give the same float32 bits as the
// plain versions' float64 matmuls: every product of two bf16 or float32
// values is exact in float64 and a sum of D <= 128 of them is exact or
// within 2^-53, so the result rounded once to float32 does not depend on
// the order of the sums (gated_common.cuh: block_gemm). The H100's float64
// tensor cores (DMMA) keep that argument: they take float64 operands and
// sum in float64. Of their shapes, sm_90's mma.sync m16n8k16 .f64 reaches
// the card's 67 TFLOP/s; m8n8k4, the sm_80 shape, runs at half that
// (benchmarks/f64_mma_rate.cu).
//
// The operands stay in shared memory in their exact narrow type (bf16 or
// float32) and are widened to float64 only as a lane loads its fragment
// values into registers (widening is exact). Each lane loads 8 consecutive
// k values of a row with one or two 16-byte loads and feeds them to two
// m16n8k16 DMMAs, the lane's k index t + 4j of the m16n8k16 standing for
// k0 + 8t + 4m + j in the m-th of them (the products' order is permuted,
// which the exact products allow); a warp reuses each loaded fragment
// across an MT x NT block of 16x8 tiles, which keeps both the
// shared-memory traffic and the widening conversions under the DMMA rate.

#pragma once

#include "gated_common.cuh"

namespace rvt {

using bf16 = __nv_bfloat16;

constexpr int kDmmaMaxB = 256;  // largest partition of the float64 tensor-core bodies

// c += a b for one 16x8 tile, k = 16: float64 operands and sums. Lane
// l = 4g + t holds a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[j] =
// B[t + 4j][g] and c = C[g][2t, 2t + 1], C[g + 8][2t, 2t + 1].
__device__ __forceinline__ void dmma16816(double (&c)[4], const double (&a)[8],
                                          const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Eight consecutive operand values of one row, loaded from shared memory
// in their stored type and widened one at a time.
template <typename T>
struct Oct;

template <>
struct Oct<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ double operator[](int e) const {
    const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return (double)__uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Oct<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = reinterpret_cast<const float4*>(p)[0];
    hi = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ double operator[](int e) const {
    const float4& q = e < 4 ? lo : hi;
    const int i = e & 3;
    return (double)(i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w);
  }
};

// c += a b for one 16x8 tile, k = 4 (the same fragment layout, k = t)
__device__ __forceinline__ void dmma1684(double (&c)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

template <int MT, int NT>
__device__ __forceinline__ void zero_tiles(double (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0;
}

// acc[i][j] += the 16x8 tile (rows 16i.., columns 8j..) of A B^T over
// k < K, for A [16 MT, K] and B [8 NT, K] (the right operand transposed: k
// contiguous in both), row-major in shared memory with leading dimensions
// lda and ldb (multiples of 8), K a multiple of 32. Accumulator layout
// (dmma16816): lane l = 4g + t holds acc[i][j][2h + e] = C[16i + g + 8h]
// [8j + 2t + e]. F32ACC (a test-only fault) takes the k = 16 step as four
// k = 4 DMMAs and rounds the sums to float32 after each.
template <int MT, int NT, bool F32ACC = false, typename TA, typename TB>
__device__ __forceinline__ void f64_mma_tiles(double (&acc)[MT][NT][4], const TA* A, int lda,
                                              const TB* B, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const TA* pa = A + (size_t)g * lda + 8 * t;
  const TB* pb = B + (size_t)g * ldb + 8 * t;
  for (int k0 = 0; k0 < K; k0 += 32) {
    Oct<TA> a[MT][2];  // rows g and g + 8 of each 16-row tile
    Oct<TB> b[NT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[i][h].load(pa + (size_t)(16 * i + 8 * h) * lda + k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j].load(pb + (size_t)8 * j * ldb + k0);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      double ad[MT][8], bd[NT][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ad[i][2 * q] = a[i][0][4 * m + q];
          ad[i][2 * q + 1] = a[i][1][4 * m + q];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) bd[j][q] = b[j][4 * m + q];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (F32ACC) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              dmma1684(acc[i][j], ad[i][2 * q], ad[i][2 * q + 1], bd[j][q]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] = (double)(float)acc[i][j][e];
            }
          } else {
            dmma16816(acc[i][j], ad[i], bd[j]);
          }
        }
    }
  }
}

// LN(x[r]) * g + b for rows r < B into the bf16 rows of H [Bp, D] in
// shared memory (one warp per row), the steps of layer_norm_rows
// (gated_common.cuh) rounded to bf16 at the end; rows [B, Bp) become 0.
// Ends with a barrier.
template <int D, typename XT>
__device__ void ln_rows_bf16(const XT* __restrict__ x, bf16* H, const float* __restrict__ g,
                             const float* __restrict__ bb, int B, int Bp, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float fd = (float)D;
  for (int r = warp; r < Bp; r += kWarps) {
    if (r >= B) {
      for (int c = lane; c < D; c += 32) H[(size_t)r * D + c] = __float2bfloat16(0.f);
      continue;
    }
    const XT* xr = x + (size_t)r * D;
    float v[4], t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < D ? ldf(xr + c) : 0.f;
      t[j] = v[j];
    }
    const float mean = __fdiv_rn(tree_sum(t), fd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = lane + 32 * j < D ? __fsub_rn(v[j], mean) : 0.f;
      t[j] = __fmul_rn(v[j], v[j]);
    }
    const float sd = __fsqrt_rn(__fadd_rn(__fdiv_rn(tree_sum(t), fd), eps));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      if (c < D)
        H[(size_t)r * D + c] =
            __float2bfloat16(__fadd_rn(__fmul_rn(__fdiv_rn(v[j], sd), g[c]), bb[c]));
    }
  }
  __syncthreads();
}

// Opt a kernel in to `smem` bytes of dynamic shared memory (above 48 KB).
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace rvt
