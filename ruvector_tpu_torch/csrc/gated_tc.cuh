// Tensor-core building blocks of the gated graph transformer's kernels
// (gated_block_layer.cu: the fused layer K4a/K4b; gated_block_mha.cu: the
// gated MHA K5a and its recompute backward K5b) and of the fused
// RuvectorLayer's tensor-core body (block_dense_attn.cu: K1).
//
// mma.sync m16n8k16 with bf16 operands and float32 sums, the operands read
// from shared memory with ldmatrix (rows XOR-swizzled so that the eight
// row addresses of an ldmatrix fall in different banks), cp.async staging
// of [D, D] weight tiles, and the pieces of a softmax over 32-column
// chunks of scores that stay in registers: a warp owns a 16-row strip,
// whose accumulators (the m16n8 layout) are repacked as the A operand of
// the next product (the m16k16 layout) without a shuffle. Float32-grade
// products run as 3xTF32 on mma.sync m16n8k8 (split_tf32 and the row
// helpers at the end).

#pragma once

#include "gated_common.cuh"

namespace rvt {

using bf16 = __nv_bfloat16;

constexpr int kTcMaxB = 256;  // largest partition of the tensor-core bodies

// Shared-memory index of element (row, col) of a row-major [rows, D] bf16
// array: the 16-byte chunks of a row are XOR-swizzled with the row, so
// that the eight row addresses of an ldmatrix fall in different banks.
template <int D>
__device__ __forceinline__ int sw(int row, int col) {
  constexpr int kMask = (D / 8 < 8 ? D / 8 : 8) - 1;
  return row * D + ((((col >> 3) ^ (row & kMask))) << 3) + (col & 7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one 16x8 tile, k = 16: bf16 operands, float32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying one [D, D] bf16 weight tile into shared memory (one
// commit group per call, issued by every thread).
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < D * D / 8; i += kThreads) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    cp_async16(dst + sw<D>(row, col), src + row * D + col);
  }
  cp_async_commit();
}

// The accumulators of a 16 x D strip (D/8 tiles of 16x8) as the A operand
// of the next product (D/16 fragments of 16x16), rounded to bf16.
template <int D>
__device__ __forceinline__ void to_frags(uint32_t (&f)[D / 16][4], const float (&c)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    f[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    f[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    f[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&c)[D / 8][4]) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;
}

// c += A[k0:k0+16 of the strip] W[k0:k0+16, :D], B operand W row-major
// [K, D] in shared memory
template <int D>
__device__ __forceinline__ void mma_row_k16(float (&c)[D / 8][4], const uint32_t (&a)[4],
                                            const bf16* W, int k0) {
  const int lane = threadIdx.x & 31;
  const int kr = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int n0 = 0; n0 < D; n0 += 16) {
    uint32_t bb[4];
    ldsm_x4_t(bb, W + sw<D>(kr, n0 + ((lane >> 4) << 3)));
    mma16816(c[n0 / 8], a, bb[0], bb[1]);
    mma16816(c[n0 / 8 + 1], a, bb[2], bb[3]);
  }
}

// c = M[r0:r0+16, :D] W for M row-major [*, D] and W [D, D], both in shared memory
template <int D>
__device__ __forceinline__ void strip_gemm(float (&c)[D / 8][4], const bf16* M, int r0,
                                           const bf16* W) {
  const int lane = threadIdx.x & 31;
  zero<D>(c);
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, M + sw<D>(r0 + (lane & 15), k0 + ((lane >> 4) << 3)));
    mma_row_k16<D>(c, af, W, k0);
  }
}

// c = F W for a strip held as A fragments F and W [D, D] in shared memory
template <int D>
__device__ __forceinline__ void frag_gemm(float (&c)[D / 8][4], const uint32_t (&f)[D / 16][4],
                                          const bf16* W) {
  zero<D>(c);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_row_k16<D>(c, f[kk], W, kk * 16);
}

// s = q Hn[j0:j0+32]^T for a strip: four 16x8 tiles of scores
template <int D>
__device__ __forceinline__ void score_chunk(float (&s)[4][4], const uint32_t (&q)[D / 16][4],
                                            const bf16* Hn, int j0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t bb[4];
      ldsm_x4(bb, Hn + sw<D>(j0 + 16 * half + (lane & 7) + ((lane >> 4) << 3),
                             kk * 16 + (((lane >> 3) & 1) << 3)));
      mma16816(s[2 * half], q[kk], bb[0], bb[1]);
      mma16816(s[2 * half + 1], q[kk], bb[2], bb[3]);
    }
  }
}

// The gate: a score (row r, column j) is kept where bit r of word j is
// set in kw, the strip's gate words with the pad pair already folded in
// (the staging in tc_layer_kernel); the others become -1e30. bitA: the
// bit of the thread's first row (its second row is bitA + 8).
__device__ __forceinline__ void mask_chunk(float (&s)[4][4], const int32_t* kw, int j0,
                                           int bitA) {
  const int c4 = threadIdx.x & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int2 w = *reinterpret_cast<const int2*>(kw + j0 + 8 * t + 2 * c4);
    if (!((w.x >> bitA) & 1)) s[t][0] = kNeg;
    if (!((w.y >> bitA) & 1)) s[t][1] = kNeg;
    if (!((w.x >> (bitA + 8)) & 1)) s[t][2] = kNeg;
    if (!((w.y >> (bitA + 8)) & 1)) s[t][3] = kNeg;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Float32 products as 3xTF32: a float32 x splits into hi, x rounded to
// tf32's 11 significant bits (an integer add and mask on its bits), and lo
// = x - hi (exact, |lo| <= 2^-11 |x|), of which the tensor cores read the
// top 11 significant bits; a product sums lo*hi + hi*lo + hi*hi on
// mma.sync m16n8k8 (tf32 operands, float32 sums). What it drops, lo*lo
// and the bits of lo past its 11th, is below 2^-21 of the product, the
// grade of a float32 FMA (2^-24), where one pass of TF32 keeps 2^-11. An
// operand that holds bf16 values (K5b's Xc and bf16 weight tiles) is exact in
// tf32: its lo is 0 and its products take two passes.
//
// Fragments of m16n8k8: the tf32 A operand of a strip takes its k pair
// (2c, 2c+1) where the PTX layout has (c, c + 4), and B the same pair, so
// that the accumulators of one 16x8 tile (columns 2c, 2c+1 of each thread)
// are the A operand of the next product's k8 block as they stand.

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // 11 significant bits, ties away from 0
  lo = __float_as_uint(x - __uint_as_float(hi));      // exact; the tensor cores read its tf32 bits
}

// c += a b for one 16x8 tile, k = 8: tf32 operands, float32 sums
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A operand (a0: row g k 2c, a1: row g+8 k 2c, a2: row g k 2c+1, a3:
// row g+8 k 2c+1) split into hi and lo.
struct Tf32A {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ Tf32A split_a(float a0, float a1, float a2, float a3) {
  Tf32A r;
  split_tf32(a0, r.hi[0], r.lo[0]);
  split_tf32(a1, r.hi[1], r.lo[1]);
  split_tf32(a2, r.hi[2], r.lo[2]);
  split_tf32(a3, r.hi[3], r.lo[3]);
  return r;
}

// k8 block t of a strip's accumulators c[t] as an A operand
__device__ __forceinline__ Tf32A acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// c[n] += A B_n over the NT 16x8 tiles of a strip, B_n = b(n): a float2
// (k 2c, 2c+1 of column 8n + g) for mma3_row (three passes: lo hi, hi lo,
// hi hi), mma2a_row (A exact: A lo, A hi) and a pair of tf32 bit patterns
// (exact) for mma2b_row (A lo B, A hi B). The passes go over kGroup tiles
// at a time, so that a product does not wait on the one before it.
constexpr int kGroup = 4;

template <int NT, bool ONE = false, typename FB>
__device__ __forceinline__ void mma3_row(float (&c)[NT][4], const Tf32A& a, FB b) {
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += kGroup) {
    uint32_t h[kGroup][2], l[kGroup][2];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float2 v = b(n0 + u);
      split_tf32(v.x, h[u][0], l[u][0]);
      split_tf32(v.y, h[u][1], l[u][1]);
    }
    if constexpr (!ONE) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) mma1688(c[n0 + u], a.lo, h[u][0], h[u][1]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) mma1688(c[n0 + u], a.hi, l[u][0], l[u][1]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) mma1688(c[n0 + u], a.hi, h[u][0], h[u][1]);
  }
}

template <int NT, bool ONE = false, typename FB>
__device__ __forceinline__ void mma2a_row(float (&c)[NT][4], const uint32_t (&a)[4], FB b) {
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += kGroup) {
    uint32_t h[kGroup][2], l[kGroup][2];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float2 v = b(n0 + u);
      split_tf32(v.x, h[u][0], l[u][0]);
      split_tf32(v.y, h[u][1], l[u][1]);
    }
    if constexpr (!ONE) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) mma1688(c[n0 + u], a, l[u][0], l[u][1]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) mma1688(c[n0 + u], a, h[u][0], h[u][1]);
  }
}

template <int NT, bool ONE = false, typename FB>
__device__ __forceinline__ void mma2b_row(float (&c)[NT][4], const Tf32A& a, FB b) {
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += kGroup) {
    uint2 v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) v[u] = b(n0 + u);
    if constexpr (!ONE) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) mma1688(c[n0 + u], a.lo, v[u].x, v[u].y);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) mma1688(c[n0 + u], a.hi, v[u].x, v[u].y);
  }
}

}  // namespace rvt
