// Device building blocks shared by the gated graph transformer's kernels
// (gated_block_attn.cu, gated_block_layer.cu, gated_block_mha.cu,
// mincut_gate_block.cu).
//
// One block of kThreads threads works on one [B, D] partition at a time;
// everything larger than a few KB lives in a per-block slice of a global
// scratch buffer (0.4-1.4 MB per block, so over the grid more than the
// L2 holds), and the block
// synchronises between stages. The pieces:
//   * block_gemm: C = A B over the whole block, 128x128 output tiles,
//     8x8 outputs per thread, k-steps of 8 staged through shared memory;
//     operands are rounded to the compute type as they are loaded (bf16
//     mode: bf16 operands, float32 sums, as the TPU kernels' bf16 MXU
//     products) and every output passes through an epilogue functor.
//     Each output is one fma chain over k in order, so the same call on
//     the same operands gives the same bits wherever it runs. With a
//     float64 accumulator (the gate logits and signatures) every product
//     of two float32 values is exact and a sum of D <= 128 of them is
//     exact or within 2^-53, so the rounded float32 result does not
//     depend on the order: the plain versions (float64 matmuls rounded
//     once) give the same bits.
//   * layer_norm_rows: LayerNorm over D per row (biased variance), every
//     step correctly rounded (no contraction, a pairwise halving tree for
//     the row sums) so that the plain versions reproduce it bit for bit
//     (ops/kernels/gated_block_attn.py: layer_norm_rows).
//   * masked_exp_rows: the gated attention's masked exponentials of one
//     head, shared by the fused layer (K4a/K4b) and the gated MHA
//     forward and backward (K5a/K5b).
//   * logits_of_rows and positive_row_sums: the gate signature's logits
//     and per-row reduction; gate_signature (LN first) is the LN-folded
//     signature of K6c's block_gemm body and the epilogue of the fused
//     layer with signature (K4b). K6c's tensor-core body
//     (gated_block_attn.cu, gated_f64tc.cuh) gives the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace rvt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;   // output tile edge of block_gemm
constexpr int kKStep = 8;    // k-step staged through shared memory
constexpr int kMaxB = 512;   // largest partition the kernels take
constexpr int kMaxD = 128;   // widest row (D = 32, 64 or 128)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The feature widths the row code takes: D = 32, 64 or 128.
inline bool width_ok(int d) { return d == 32 || d == 64 || d == 128; }

// Sum of a row of D = 32 m values (m = 1, 2 or 4) held by a warp, lane l
// holding v[j] = row[l + 32 j] (0 for j >= m): the pairwise halving tree
// row[c] + row[c + D/2], then again on the first half, ..., whose last
// five levels are the warp butterfly; every lane gets the sum. The plain
// versions sum in the same tree (gated_block_attn.py: tree_sum).
__device__ __forceinline__ float tree_sum(float v[4]) {
  return warp_sum(__fadd_rn(__fadd_rn(v[0], v[2]), __fadd_rn(v[1], v[3])));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// round to the compute type and back (round to nearest even)
template <bool BF16> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<false>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<true>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// acc + a b: float32 fma, or float64 with the (exact) float64 product
__device__ __forceinline__ float fma_acc(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ double fma_acc(float a, float b, double acc) {
  return fma((double)a, (double)b, acc);
}

struct GemmSmem {
  float a[kKStep][kTile];   // A tile, k-major
  float b[kKStep][kTile];   // B tile
};

// C[m][n] = sum_k A[m][k] * B[k][n] for m < M, n < N, summed in Acc
// (float or double) and handed to epi(m, n, value) rounded to float. A is
// row-major [M][K] with leading dimension lda or, with TRANS_A, stored as
// [K][M] so that A[m][k] = At[k * lda + m]; B is row-major [K][N] (ldb)
// or, with TRANS_B, stored as [N][K] so that B[k][n] = Bt[n * ldb + k].
// Ends with a barrier, so the block may read what the epilogue wrote.
template <bool BF16, bool TRANS_B, typename Acc = float, bool TRANS_A = false,
          typename AT, typename BT, typename Epi>
__device__ void block_gemm(const AT* __restrict__ A, int lda, const BT* __restrict__ B,
                           int ldb, int M, int N, int K, GemmSmem& sm, Epi epi) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    for (int n0 = 0; n0 < N; n0 += kTile) {
      Acc acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0;
      for (int k0 = 0; k0 < K; k0 += kKStep) {
        __syncthreads();  // the previous k-step's tiles are consumed
        for (int i = tid; i < kTile * kKStep; i += kThreads) {
          int r, c;
          if (TRANS_A) { r = i % kTile; c = i / kTile; }
          else { r = i / kKStep; c = i % kKStep; }
          const int m = m0 + r, k = k0 + c;
          float v = 0.f;
          if (m < M && k < K)
            v = TRANS_A ? ldf(A + (size_t)k * lda + m) : ldf(A + (size_t)m * lda + k);
          sm.a[c][r] = rnd<BF16>(v);
        }
        for (int i = tid; i < kTile * kKStep; i += kThreads) {
          int r, c;
          if (TRANS_B) { r = i % kKStep; c = i / kKStep; }
          else { r = i / kTile; c = i % kTile; }
          const int k = k0 + r, n = n0 + c;
          float v = 0.f;
          if (k < K && n < N)
            v = TRANS_B ? ldf(B + (size_t)n * ldb + k) : ldf(B + (size_t)k * ldb + n);
          sm.b[r][c] = rnd<BF16>(v);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKStep; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[kk][ty * 4]);
          const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[kk][64 + ty * 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[kk][tx * 4]);
          const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[kk][64 + tx * 4]);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fma_acc(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
          if (m < M && n < N) epi(m, n, (float)acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// out[r][c] = LN(x[r])[c] * g[c] + b[c] over rows r < B (one warp per
// row, D <= kMaxD), biased variance; ROUND rounds the result to bf16.
// mean = tree_sum(x) / D, xc = x - mean, var = tree_sum(xc xc) / D,
// out = xc / sqrt(var + eps) * g + b, each step correctly rounded and
// none contracted into an fma, as the plain version computes it.
template <bool ROUND, typename XT>
__device__ void layer_norm_rows(const XT* __restrict__ x, float* __restrict__ out,
                                const float* __restrict__ g, const float* __restrict__ bb,
                                int B, int D, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float fd = (float)D;
  for (int r = warp; r < B; r += kWarps) {
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
        out[(size_t)r * D + c] =
            rnd<ROUND>(__fadd_rn(__fmul_rn(__fdiv_rn(v[j], sd), g[c]), bb[c]));
    }
  }
  __syncthreads();
}

// The gated attention's masked exponentials of one head (K4a, K5a, K5b):
// S [B, B] holds the scores; entry (r, j) is kept where the gate bit
// (word r / 32 of column j, bit r % 32) and the pad pair are set, and
// becomes exp(s - row max of the kept), rounded to float32 and not
// normalised (exp(-1e30 - max) = 0 for the others); INV[r] =
// 1 / max(row sum, 1e-10), or 0 for a row that keeps nothing (its entries
// are then exp(0) = 1, so a caller that needs them as weights multiplies
// by INV). One warp per row, sums in a fixed order.
__device__ void masked_exp_rows(float* __restrict__ S, const int32_t* __restrict__ keepk,
                                const float* pad, int B, float* __restrict__ INV) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < B; r += kWarps) {
    float* sr = S + (size_t)r * B;
    const bool row_ok = pad[r] > 0.f;
    const int32_t* kw = keepk + (size_t)(r >> 5) * B;
    const int bit = r & 31;
    float mx = kNeg;
    for (int j = lane; j < B; j += 32) {
      const bool kept = row_ok && pad[j] > 0.f && ((kw[j] >> bit) & 1);
      const float v = kept ? sr[j] : kNeg;
      sr[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    const float shift = fmaxf(mx, kNeg);
    float sum = 0.f;
    for (int j = lane; j < B; j += 32) {
      const float p = expf(sr[j] - shift);
      sr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) INV[r] = mx > -1e29f ? 1.f / fmaxf(sum, 1e-10f) : 0.f;
  }
  __syncthreads();
}

// S = (H A_sig) H^T for one partition, H [B, D] of type XT: compute-type
// operands, float64 sums rounded to float32 (so that the plain version
// gives the same bits). Scratch Q [B, D]; S is [B, B].
template <bool BF16, typename XT>
__device__ void logits_of_rows(const XT* __restrict__ H, const float* __restrict__ A_sig,
                               int B, int D, float* Q, float* S, GemmSmem& gs) {
  block_gemm<BF16, false, double>(H, D, A_sig, D, B, D, D, gs,
                                  [&](int m, int n, float v) { Q[(size_t)m * D + n] = v; });
  block_gemm<BF16, true, double>(Q, D, H, D, B, B, D, gs,
                                 [&](int m, int n, float v) { S[(size_t)m * B + n] = v; });
}

// Per row r of the logits S [B, B]: the sum (float64, rounded) and count
// of S[r][c] > eps over valid pairs (pad[r] > 0 and pad[c] > 0). pad is in
// shared memory.
__device__ void positive_row_sums(const float* __restrict__ S, const float* pad, float eps,
                                  int B, float* __restrict__ rsum, float* __restrict__ rcnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < B; r += kWarps) {
    double s = 0.0;
    float c = 0.f;
    if (pad[r] > 0.f) {
      for (int j = lane; j < B; j += 32) {
        const float v = S[(size_t)r * B + j];
        if (pad[j] > 0.f && v > eps) {
          s += v;
          c += 1.f;
        }
      }
    }
    s = warp_sum(s);
    c = warp_sum(c);
    if (lane == 0) {
      rsum[r] = (float)s;
      rcnt[r] = c;
    }
  }
  __syncthreads();
}

// LN-folded gate signature of one partition (K6c, and K4b's epilogue):
// h = LN(x) (eps 1e-5), s = (h A_sig) h^T (logits_of_rows), then
// positive_row_sums. Scratch: Hn, Q [B, D] and S [B, B].
template <bool BF16, typename XT>
__device__ void gate_signature(const XT* __restrict__ x, const float* pad,
                               const float* __restrict__ A_sig, const float* __restrict__ g,
                               const float* __restrict__ bb, float eps, int B, int D,
                               float* Hn, float* Q, float* S, GemmSmem& gs,
                               float* __restrict__ rsum, float* __restrict__ rcnt) {
  layer_norm_rows<false>(x, Hn, g, bb, B, D, 1e-5f);
  logits_of_rows<BF16>(static_cast<const float*>(Hn), A_sig, B, D, Q, S, gs);
  positive_row_sums(S, pad, eps, B, rsum, rcnt);
}

// Blocks a persistent launch may keep resident: min(grid, per-SM
// occupancy x SMs), so that every block of the grid runs at once.
template <typename Kernel>
inline int resident_grid(Kernel kernel, int grid, size_t smem) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const int cap = (per_sm > 0 ? per_sm : 1) * sms;
  return grid < cap ? grid : cap;
}

}  // namespace rvt

extern "C" const char* rvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
