// The gated MHA of the min-cut-gated graph transformer (K5a), its
// recompute backward (K5b), and the fixed-order reduction of K5b's
// per-block parameter gradients.
//
// Replaces ruvector_tpu/ops/pallas/gated_block_attn.py:119 _fwd_pallas
// (kernel :65-116) and :239 _bwd_pallas (kernel :154-236), the two halves
// of the custom_vjp `gated_block_attention` (:284-337). Per partition (a
// block of the block-dense layout) and head h, with X the [B, D] rows,
// A_h, Wvo_h the head-folded [D, D] slices of A_cat, Wvo_cat [D, H D]:
//   forward:  q = X A_h, y = X Wvo_h, s = q X^T masked to -1e30 where the
//             gate bit and the pad pair are not both set, pu = exp(s - max)
//             (rounded to the compute type un-normalised),
//             out += (pu y) / max(sum pu, 1e-10); out *= pad.
//   backward: g *= pad; recompute q, y and p = pu / denom; dp = g y^T,
//             dy = p^T g, ds = p (dp - rowsum(dp p)), dq = ds X,
//             dX += ds^T q + dq A_h^T + dy Wvo_h^T, dA_h += X^T dq,
//             dWvo_h += X^T dy.
// Rounding follows the TPU kernels: in bf16 compute mode the forward's
// products (and the backward's recompute of q, y and s) take bf16
// operands with float32 sums; every product of the backward proper takes
// float32 X, q, y, g and p, as the TPU kernel does.
//
// What bounds it on an H100: the least work at 1M nodes, B=256, D=128,
// H=4 is 2 n H (2D + 2B) D bf16 operations forward (7.9e11: 0.8 ms at
// 989 TFLOP/s) and, backward, 2 n H (2D + B) D bf16 operations for the
// recompute plus 2 n H (4D + 4B) D float32 ones (1.57e12: 9.5 ms at 165
// TFLOP/s, the tensor cores' 495 TFLOP/s of TF32 over the three passes of
// a float32-grade product; 23 ms at the 67 TFLOP/s of float32 FMA),
// against 0.5-1.5 GB of bytes (0.2-0.5 ms): both are bound by operations,
// K5a by bf16 ones and K5b by float32-grade ones.
//
// Two bodies of each, chosen by the wrapper (mha_body: an explicit
// dispatch, not a fallback):
//
// * tc_mha_fwd_kernel / tc_mha_bwd_kernel (bf16 compute, B <= 256): the
//   products on the tensor cores with mma.sync, the partition's rows in
//   shared memory as bf16 (gated_tc.cuh, as the fused layer's body). One
//   block of 8 warps per SM owns one partition at a time; a warp owns
//   16-row strips and keeps the scores in registers 32 columns at a time,
//   so no [B, B] array leaves the SM. B is padded to a multiple of 32 with
//   zero rows and stores are masked (the halo layout's B = 240 runs here).
//   K5a is K4a's sublayer 1 on Xc = bf16(x) in place of LN1's Hn: bf16
//   [D, D] tiles of A_h and Wvo_h staged with cp.async, y_h = Xc Wvo_h and
//   q_h = Xc A_h as bf16, two passes over the score chunks (the row max,
//   then p = exp(s - max) rounded to bf16 into p y_h, so p is rounded
//   against the row max as on the TPU), heads outermost with the f32 sum
//   over heads in the block's [B, D] slice of the scratch (128 KB; 17 MB
//   over the grid, in L2). K5b recomputes q and s on bf16 operands and runs
//   the backward proper as float32-grade products: 3xTF32 on mma.sync
//   m16n8k8 (the split and its error at split_tf32 below). It is the
//   backward of FlashAttention-2 with the gated softmax: row strips find
//   the row max and sum and Delta_i = sum_j dp_ij p_ij, then dq; column
//   strips recompute s^T from the same row statistics for dy and dX;
//   associativity moves the float32 factors of y and q onto products with
//   the bf16 rows Xc (exact in tf32), which take two passes instead of
//   three (tc_mha_bwd_kernel's note). Per block, gw, dq and dy live in a
//   3 Bp D slice of the scratch (384 KB at B=256, D=128).
// * mha_fwd_kernel / mha_bwd_kernel (float32 compute, or B in (256, 512]):
//   every product through block_gemm (gated_common.cuh) on the CUDA cores
//   in float32 FMA, the partition's rows, one head's projections and its
//   [B, B] scores in the block's slice of a global scratch buffer.
//   Single-pass TF32 would break the float32 tolerance of 1e-4 / 1e-5 and
//   3xTF32 would only tie with FMA there; at B > 256 the bf16 rows of the
//   tensor-core bodies no longer fit in shared memory with their tiles.
//
// The TPU kernel sums dA and dWvo over its sequential grid into one output
// block; here blocks run in parallel, so each block adds its partitions'
// dA and dWvo into its own [D, H D] slice of a partial buffer (zeroed by
// the caller), and reduce_partials sums the slices in block order. No
// float atomics: runs repeat bit for bit.

#include "gated_tc.cuh"

namespace {

using namespace rvt;

struct MhaArgs {
  const void* x;        // [nB, B, D] float32 or bf16
  const int32_t* keep;  // [nB, ceil(B/32), B] gate bits
  const float* pad;     // [nB, B]
  const float* A_cat;   // [D, H D]
  const float* Wvo_cat; // [D, H D]
  const bf16* wt;       // tensor-core bodies: bf16 [D, D] tiles A_0..A_{H-1}, Wvo_0..Wvo_{H-1}
  const void* g;        // [nB, B, D] like x (backward)
  void* out;            // [nB, B, D] like x: the output (forward) or dx (backward)
  float* dA;            // grid x [D, H D] partials (backward)
  float* dWvo;          // grid x [D, H D] partials (backward)
  float* scratch;       // grid x scratch_floats(...)
  int nb, b, d, heads;
};

// Floats of the scratch that each block of the grid owns. block_gemm
// bodies: the rows, one head's projections and its [B, B] scores (4 B D +
// B B + B forward, 7 B D + 2 B B + B backward). Tensor-core forward: the
// [B, D] sum over heads. Tensor-core backward: gw, dq and dy, and dX for
// bf16 x, [Bp, D] each, Bp = B rounded up to a multiple of 32.
__host__ __device__ size_t scratch_floats(bool fwd, bool tc, int b, int d, bool x_bf16) {
  const size_t bd = (size_t)b * d;
  if (!tc) return fwd ? 4 * bd + (size_t)b * b + b : 7 * bd + 2 * (size_t)b * b + b;
  if (fwd) return bd;
  return (x_bf16 ? 4 : 3) * (size_t)((b + 31) / 32 * 32) * d;
}

template <typename XT>
__device__ __forceinline__ void store(XT* p, float v) {
  if constexpr (sizeof(XT) == 2) *p = __float2bfloat16(v);
  else *p = v;
}

// Per head of one partition: Q = X A_h, Y = X Wvo_h, S = q X^T through
// masked_exp_rows (compute-type operands, float32 sums).
template <bool BF16>
__device__ void head_scores(const float* X, const float* A_cat, const float* Wvo_cat, int h,
                            int b, int d, int hd, const int32_t* keepk, const float* pad,
                            float* Q, float* Y, float* S, float* INV, GemmSmem& gs) {
  block_gemm<BF16, false>(X, d, A_cat + h * d, hd, b, d, d, gs,
                          [&](int m, int n, float v) { Q[(size_t)m * d + n] = v; });
  block_gemm<BF16, false>(X, d, Wvo_cat + h * d, hd, b, d, d, gs,
                          [&](int m, int n, float v) { Y[(size_t)m * d + n] = v; });
  block_gemm<BF16, true>(Q, d, X, d, b, b, d, gs,
                         [&](int m, int n, float v) { S[(size_t)m * b + n] = v; });
  masked_exp_rows(S, keepk, pad, b, INV);
}

template <typename XT, bool BF16>
__global__ void __launch_bounds__(kThreads) mha_fwd_kernel(const MhaArgs a) {
  __shared__ GemmSmem gs;
  __shared__ float pad[kMaxB];
  const int b = a.b, d = a.d, hd = a.heads * d;
  const int words = (b + 31) / 32;
  const size_t bd = (size_t)b * d;
  float* X = a.scratch + (size_t)blockIdx.x * scratch_floats(true, false, b, d, false);
  float* Q = X + bd;
  float* Y = Q + bd;
  float* ATT = Y + bd;
  float* S = ATT + bd;
  float* INV = S + (size_t)b * b;
  const int tid = threadIdx.x;
  for (int k = blockIdx.x; k < a.nb; k += gridDim.x) {
    const XT* xk = static_cast<const XT*>(a.x) + (size_t)k * bd;
    const int32_t* keepk = a.keep + (size_t)k * words * b;
    __syncthreads();  // the previous partition's pad and ATT are no longer read
    for (int i = tid; i < b; i += kThreads) pad[i] = a.pad[(size_t)k * b + i];
    for (size_t i = tid; i < bd; i += kThreads) {
      X[i] = ldf(xk + i);
      ATT[i] = 0.f;
    }
    __syncthreads();
    for (int h = 0; h < a.heads; ++h) {
      head_scores<BF16>(X, a.A_cat, a.Wvo_cat, h, b, d, hd, keepk, pad, Q, Y, S, INV, gs);
      block_gemm<BF16, false>(S, b, Y, d, b, d, b, gs, [&](int m, int n, float v) {
        ATT[(size_t)m * d + n] += v * INV[m];
      });
    }
    XT* outk = static_cast<XT*>(a.out) + (size_t)k * bd;
    for (size_t i = tid; i < bd; i += kThreads) store(outk + i, ATT[i] * pad[i / d]);
  }
}

template <typename XT, bool BF16>
__global__ void __launch_bounds__(kThreads) mha_bwd_kernel(const MhaArgs a) {
  __shared__ GemmSmem gs;
  __shared__ float pad[kMaxB];
  const int b = a.b, d = a.d, hd = a.heads * d;
  const int words = (b + 31) / 32;
  const size_t bd = (size_t)b * d;
  float* X = a.scratch + (size_t)blockIdx.x * scratch_floats(false, false, b, d, false);
  float* G = X + bd;
  float* Q = G + bd;
  float* Y = Q + bd;
  float* DQ = Y + bd;
  float* DY = DQ + bd;
  float* DX = DY + bd;
  float* S = DX + bd;           // scores, then p
  float* DP = S + (size_t)b * b;  // dp, then ds
  float* INV = DP + (size_t)b * b;
  float* dA = a.dA + (size_t)blockIdx.x * d * hd;
  float* dW = a.dWvo + (size_t)blockIdx.x * d * hd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int k = blockIdx.x; k < a.nb; k += gridDim.x) {
    const XT* xk = static_cast<const XT*>(a.x) + (size_t)k * bd;
    const XT* gk = static_cast<const XT*>(a.g) + (size_t)k * bd;
    const int32_t* keepk = a.keep + (size_t)k * words * b;
    __syncthreads();  // the previous partition's pad and DX are no longer read
    for (int i = tid; i < b; i += kThreads) pad[i] = a.pad[(size_t)k * b + i];
    __syncthreads();
    for (size_t i = tid; i < bd; i += kThreads) {
      X[i] = ldf(xk + i);
      G[i] = ldf(gk + i) * pad[i / d];  // the forward's `out * pad`
      DX[i] = 0.f;
    }
    __syncthreads();
    for (int h = 0; h < a.heads; ++h) {
      head_scores<BF16>(X, a.A_cat, a.Wvo_cat, h, b, d, hd, keepk, pad, Q, Y, S, INV, gs);
      // dp = g y^T (float32)
      block_gemm<false, true>(G, d, Y, d, b, b, d, gs,
                              [&](int m, int n, float v) { DP[(size_t)m * b + n] = v; });
      // p = pu / denom (0 off the kept entries), then ds = p (dp - sum_j dp p)
      for (int r = warp; r < b; r += kWarps) {
        float* sr = S + (size_t)r * b;
        float* dr = DP + (size_t)r * b;
        const float inv = INV[r];
        float acc = 0.f;
        for (int j = lane; j < b; j += 32) {
          const float p = sr[j] * inv;
          sr[j] = p;
          acc += dr[j] * p;
        }
        acc = warp_sum(acc);
        for (int j = lane; j < b; j += 32) dr[j] = sr[j] * (dr[j] - acc);
      }
      __syncthreads();
      // dy = p^T g, dq = ds X, dX += ds^T q
      block_gemm<false, false, float, true>(S, b, G, d, b, d, b, gs,
                                            [&](int m, int n, float v) {
                                              DY[(size_t)m * d + n] = v;
                                            });
      block_gemm<false, false>(DP, b, X, d, b, d, b, gs,
                               [&](int m, int n, float v) { DQ[(size_t)m * d + n] = v; });
      block_gemm<false, false, float, true>(DP, b, Q, d, b, d, b, gs,
                                            [&](int m, int n, float v) {
                                              DX[(size_t)m * d + n] += v;
                                            });
      // dA_h += X^T dq, dWvo_h += X^T dy (this block's partials)
      block_gemm<false, false, float, true>(X, d, DQ, d, d, d, b, gs,
                                            [&](int m, int n, float v) {
                                              dA[(size_t)m * hd + h * d + n] += v;
                                            });
      block_gemm<false, false, float, true>(X, d, DY, d, d, d, b, gs,
                                            [&](int m, int n, float v) {
                                              dW[(size_t)m * hd + h * d + n] += v;
                                            });
      // dX += dq A_h^T + dy Wvo_h^T
      block_gemm<false, true>(DQ, d, a.A_cat + h * d, hd, b, d, d, gs,
                              [&](int m, int n, float v) { DX[(size_t)m * d + n] += v; });
      block_gemm<false, true>(DY, d, a.Wvo_cat + h * d, hd, b, d, d, gs,
                              [&](int m, int n, float v) { DX[(size_t)m * d + n] += v; });
    }
    XT* dxk = static_cast<XT*>(a.out) + (size_t)k * bd;
    for (size_t i = tid; i < bd; i += kThreads) store(dxk + i, DX[i]);
  }
}

// ---------------------------------------------------------------------------
// the tensor-core bodies (bf16 compute, B <= kTcMaxB)
// ---------------------------------------------------------------------------

// The partition's rows rounded to bf16 into the swizzled Xn [Bp, D] in
// shared memory, 8 columns (16 bytes) a thread at a time; rows [B, Bp)
// become 0.
template <int D, typename XT>
__device__ __forceinline__ void stage_rows(bf16* Xn, const XT* __restrict__ src, int B, int Bp) {
#pragma unroll 4
  for (int i = threadIdx.x; i < Bp * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < B) {
      if constexpr (sizeof(XT) == 2) {
        v = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
      } else {
        const float4 lo = *reinterpret_cast<const float4*>(src + (size_t)r * D + c);
        const float4 hi = *reinterpret_cast<const float4*>(src + (size_t)r * D + c + 4);
        v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                       pack_bf16(hi.z, hi.w));
      }
    }
    *reinterpret_cast<uint4*>(Xn + sw<D>(r, c)) = v;
  }
}

// pad [Bp] (0 past B) and the gate words [Bp/32, Bp] of partition k with
// the pad pair folded in: bit r of word j is kept only where the gate bit
// is set and rows r and j are both pad-valid. Ends with a barrier.
__device__ __forceinline__ void stage_gate(int32_t* keep_s, float* pad_s, uint32_t* rows_s,
                                           const int32_t* __restrict__ keepk,
                                           const float* __restrict__ padk, int B, int Bp) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < Bp; i += kThreads) pad_s[i] = i < B ? padk[i] : 0.f;
  __syncthreads();
  if (warp < Bp / 32) rows_s[warp] = __ballot_sync(0xffffffffu, pad_s[warp * 32 + lane] > 0.f);
  __syncthreads();
  for (int i = tid; i < (Bp / 32) * Bp; i += kThreads) {
    const int w = i / Bp, j = i % Bp;
    keep_s[i] = pad_s[j] > 0.f ? keepk[(size_t)w * B + j] & (int32_t)rows_s[w] : 0;
  }
  __syncthreads();
}

// Shared-memory bytes of the forward's tensor-core body for a partition
// padded to Bp rows: Xn and Y [Bp, D], two [D, D] tiles (bf16), the gate
// words [Bp/32, Bp] and pad [Bp] (K4a's layout, Hn replaced by Xn).
inline size_t tc_fwd_smem_bytes(int bp, int d) {
  return (size_t)2 * bp * d * 2 + (size_t)2 * d * d * 2 + (size_t)(bp / 32) * bp * 4 +
         (size_t)bp * 4;
}

// K5a on the tensor cores: K4a's sublayer 1 (gated_block_layer.cu) on the
// rows x rounded to bf16 (Xn) in place of LN1's Hn. Heads run outermost;
// a warp owns the same 16-row strips in every head, so the float32 sum
// over heads (ATT, the block's [B, D] slice of the scratch) is read and
// written by the same threads and needs no barrier; the last head adds
// its share, multiplies by pad and writes the output in x's type.
template <int D, typename XT>
__global__ void __launch_bounds__(kThreads, 1) tc_mha_fwd_kernel(const MhaArgs a) {
  constexpr int ND = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t rows_s[kTcMaxB / 32];  // pad-valid rows of each gate word
  const int B = a.b, H = a.heads;
  const int Bp = (B + 31) / 32 * 32;   // rows and score columns, zero-filled past B
  const int B16 = (B + 15) / 16 * 16;  // rows that hold a valid row
  bf16* Xn = reinterpret_cast<bf16*>(smem_raw);
  bf16* Y = Xn + Bp * D;
  bf16* W0 = Y + Bp * D;
  bf16* W1 = W0 + D * D;
  int32_t* keep_s = reinterpret_cast<int32_t*>(W1 + D * D);
  float* pad_s = reinterpret_cast<float*>(keep_s + (Bp / 32) * Bp);
  const size_t bd = (size_t)B * D;
  float* ATT = a.scratch + (size_t)blockIdx.x * scratch_floats(true, true, B, D, false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const bf16* tA = a.wt;              // A_h: tile h
  const bf16* tV = a.wt + H * D * D;  // Wvo_h: tile H + h

  for (int k = blockIdx.x; k < a.nb; k += gridDim.x) {
    __syncthreads();  // the previous partition's shared memory is no longer read
    stage_tile<D>(W1, tV);  // Wvo_0, then A_0: the order the heads wait for them
    stage_tile<D>(W0, tA);
    stage_rows<D>(Xn, static_cast<const XT*>(a.x) + k * bd, B, Bp);
    stage_gate(keep_s, pad_s, rows_s, a.keep + (size_t)k * (Bp / 32) * B, a.pad + (size_t)k * B,
               B, Bp);
    XT* outk = static_cast<XT*>(a.out) + k * bd;

    // in flight on entry to head h: Wvo_h (W1), A_h (W0)
    for (int h = 0; h < H; ++h) {
      cp_async_wait<1>();
      __syncthreads();  // Wvo_h (and Xn) visible
      for (int r0 = warp * 16; r0 < Bp; r0 += kWarps * 16) {  // y_h = Xn Wvo_h, every row
        float c[ND][4];
        strip_gemm<D>(c, Xn, r0, W1);
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const int n = 8 * t + 2 * c4;
          *reinterpret_cast<uint32_t*>(Y + sw<D>(r0 + g, n)) = pack_bf16(c[t][0], c[t][1]);
          *reinterpret_cast<uint32_t*>(Y + sw<D>(r0 + g + 8, n)) = pack_bf16(c[t][2], c[t][3]);
        }
      }
      __syncthreads();  // Y complete, W1 free
      if (h + 1 < H) {
        stage_tile<D>(W1, tV + (h + 1) * D * D);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // A_h visible
      for (int r0 = warp * 16; r0 < B16; r0 += kWarps * 16) {
        uint32_t q[KD][4];
        {
          float c[ND][4];
          strip_gemm<D>(c, Xn, r0, W0);
          to_frags<D>(q, c);
        }
        const int rA = r0 + g, rB = rA + 8;
        const int32_t* kw = keep_s + (r0 >> 5) * Bp;
        const int bitA = (r0 & 31) + g;
        // pass 1: the row max of the kept scores
        float mA = kNeg, mB = kNeg;
        for (int j0 = 0; j0 < Bp; j0 += 32) {
          float s[4][4];
          score_chunk<D>(s, q, Xn, j0);
          mask_chunk(s, kw, j0, bitA);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            mA = fmaxf(mA, fmaxf(s[t][0], s[t][1]));
            mB = fmaxf(mB, fmaxf(s[t][2], s[t][3]));
          }
        }
        mA = quad_max(mA);
        mB = quad_max(mB);
        // pass 2: p = exp(s - max), rounded to bf16 into p y_h; sums unrounded
        float o[ND][4];
        zero<D>(o);
        float sumA = 0.f, sumB = 0.f;
        for (int j0 = 0; j0 < Bp; j0 += 32) {
          float s[4][4];
          score_chunk<D>(s, q, Xn, j0);
          mask_chunk(s, kw, j0, bitA);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            s[t][0] = expf(s[t][0] - mA);
            s[t][1] = expf(s[t][1] - mA);
            s[t][2] = expf(s[t][2] - mB);
            s[t][3] = expf(s[t][3] - mB);
            sumA += s[t][0] + s[t][1];
            sumB += s[t][2] + s[t][3];
          }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint32_t p[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                   pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                   pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                   pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
            mma_row_k16<D>(o, p, Y, j0 + 16 * kk);
          }
        }
        sumA = quad_sum(sumA);
        sumB = quad_sum(sumB);
        const float inv[2] = {mA > -1e29f ? 1.f / fmaxf(sumA, 1e-10f) : 0.f,
                              mB > -1e29f ? 1.f / fmaxf(sumB, 1e-10f) : 0.f};
        const int rows[2] = {rA, rB};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = rows[u];
          if (r >= B) continue;
          const float pr = pad_s[r];
#pragma unroll
          for (int t = 0; t < ND; ++t) {
            const int n = 8 * t + 2 * c4;
            float2* acc = reinterpret_cast<float2*>(ATT + (size_t)r * D + n);
            float2 v = make_float2(o[t][2 * u] * inv[u], o[t][2 * u + 1] * inv[u]);
            if (h > 0) v = make_float2(acc->x + v.x, acc->y + v.y);
            if (h + 1 < H) {
              *acc = v;
            } else if constexpr (sizeof(XT) == 2) {
              *reinterpret_cast<__nv_bfloat162*>(outk + (size_t)r * D + n) =
                  __floats2bfloat162_rn(v.x * pr, v.y * pr);
            } else {
              *reinterpret_cast<float2*>(outk + (size_t)r * D + n) =
                  make_float2(v.x * pr, v.y * pr);
            }
          }
        }
      }
      if (h + 1 < H) {
        __syncthreads();  // W0 and Y are no longer read
        stage_tile<D>(W0, tA + (h + 1) * D * D);
      }
    }
  }
}

template <int D, typename XT>
int run_tc_fwd(const MhaArgs& a, int grid, cudaStream_t s) {
  auto kernel = tc_mha_fwd_kernel<D, XT>;
  const size_t smem = tc_fwd_smem_bytes((a.b + 31) / 32 * 32, D);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int g = resident_grid(kernel, grid, smem);
  kernel<<<g, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename XT>
int run_tc_fwd_width(const MhaArgs& a, int grid, cudaStream_t s) {
  if (a.d == 128) return run_tc_fwd<128, XT>(a, grid, s);
  if (a.d == 64) return run_tc_fwd<64, XT>(a, grid, s);
  return run_tc_fwd<32, XT>(a, grid, s);
}

// ---- K5b on the tensor cores ----------------------------------------------
//
// Its float32-grade products are 3xTF32 (split_tf32, mma3_row, gated_tc.cuh).

// bf16 pair (low half first) as two tf32 (float32) bit patterns
__device__ __forceinline__ uint32_t bf_lo(uint32_t v) { return v << 16; }
__device__ __forceinline__ uint32_t bf_hi(uint32_t v) { return v & 0xffff0000u; }

__device__ __forceinline__ uint32_t bf_bits(const bf16* p) {
  return (uint32_t)(*reinterpret_cast<const unsigned short*>(p)) << 16;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// s = q Xn[j0:j0+32]^T for a strip whose q rows are read from Q16 in
// shared memory (score_chunk with the A fragments loaded k-step by k-step)
template <int D>
__device__ __forceinline__ void score_chunk_smem(float (&s)[4][4], const bf16* Q16, int r0,
                                                 const bf16* Xn, int j0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t q[4];
    ldsm_x4(q, Q16 + sw<D>(r0 + (lane & 15), kk * 16 + ((lane >> 4) << 3)));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t bb[4];
      ldsm_x4(bb, Xn + sw<D>(j0 + 16 * half + (lane & 7) + ((lane >> 4) << 3),
                             kk * 16 + (((lane >> 3) & 1) << 3)));
      mma16816(s[2 * half], q, bb[0], bb[1]);
      mma16816(s[2 * half + 1], q, bb[2], bb[3]);
    }
  }
}

// dp = gw Xn[j0:j0+32]^T (float32 grade) for a strip: gw its rows of
// the GW slice (float32, read k-step by k-step), Xn exact in tf32
template <int D, bool ONE>
__device__ __forceinline__ void dp_chunk(float (&dp)[4][4], const float* gws, const bf16* Xn,
                                         int j0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t) dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const float2 va = ld2(gws + g * D + 8 * t + 2 * c4);
    const float2 vb = ld2(gws + (g + 8) * D + 8 * t + 2 * c4);
    const Tf32A a = split_a(va.x, vb.x, va.y, vb.y);
    mma2b_row<4, ONE>(dp, a, [&](int nt) {
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(Xn + sw<D>(j0 + 8 * nt + g, 8 * t + 2 * c4));
      return make_uint2(bf_lo(v), bf_hi(v));
    });
  }
}

constexpr int kChunk = 32;  // rows of a staged float32 chunk

// Start copying rows r0 .. r0 + kChunk - 1 of src [*, D] (float32 or bf16)
// into dst as float32 with a row stride of D + 4 (so that the B-operand
// reads of m16n8k8, four rows apart by two and eight columns, fall in 32
// banks); rows at or past B become 0. float32 rows go by cp.async (one
// commit group per call), bf16 rows by plain loads and stores.
template <int D, typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* __restrict__ src, int r0,
                                            int B) {
  for (int i = threadIdx.x; i < kChunk * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float* d = dst + r * (D + 4) + c;
    const bool ok = r0 + r < B;
    if constexpr (sizeof(T) == 4) {
      const T* s = src + (size_t)(ok ? r0 + r : 0) * D + c;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(d)),
                   "l"(s), "r"(ok ? 16 : 0));
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        const float2 lo = ld2(src + (size_t)(r0 + r) * D + c);
        const float2 hi = ld2(src + (size_t)(r0 + r) * D + c + 2);
        v = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      *reinterpret_cast<float4*>(d) = v;
    }
  }
  cp_async_commit();
}

// body(c, chunk) for the n chunks of kChunk rows of src, staged in turn
// into the two halves of buf while the other half is read. Every thread
// of the block calls it (it holds barriers).
template <int D, typename T, typename F>
__device__ __forceinline__ void chunk_loop(float* buf, const T* src, int n, int B, F body) {
  constexpr int kBuf = kChunk * (D + 4);
  stage_chunk<D>(buf, src, 0, B);
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage_chunk<D>(buf + ((c + 1) & 1) * kBuf, src, (c + 1) * kChunk, B);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c visible
    body(c, static_cast<const float*>(buf + (c & 1) * kBuf));
    __syncthreads();  // its half is free for chunk c + 2
  }
}

// Shared-memory bytes of the backward's tensor-core body: Xn [Bp, D]; Q16
// [Bp, D] and Ac [D, D] (bf16) sharing their room with a float32 [D, D + 4]
// weight; Wc [D, D] (bf16) sharing its room with two float32 chunks
// [kChunk, D + 4]; the gate words [Bp/32, Bp]; pad, the row max, 1/row sum
// and Delta [Bp] (float32).
__host__ __device__ inline size_t tc_bwd_chunks_bytes(int d) {
  const size_t tile = (size_t)d * d * 2, chunks = (size_t)2 * kChunk * (d + 4) * 4;
  return tile > chunks ? tile : chunks;
}

__host__ __device__ inline size_t tc_bwd_qa_bytes(int bp, int d) {
  const size_t qa = (size_t)bp * d * 2 + (size_t)d * d * 2, w = (size_t)d * (d + 4) * 4;
  return qa > w ? qa : w;
}

inline size_t tc_bwd_smem_bytes(int bp, int d) {
  return (size_t)bp * d * 2 + tc_bwd_qa_bytes(bp, d) + tc_bwd_chunks_bytes(d) +
         (size_t)(bp / 32) * bp * 4 + (size_t)4 * bp * 4;
}

// K5b on the tensor cores. Per partition and head h, with Xc = bf16(X),
// Ac = bf16(A_h), Wc = bf16(Wvo_h) (the tiles), G = g pad:
//   Q16 = bf16(Xc Ac) and gw = G Wc^T for every row (so that dp = G y^T =
//     gw Xc^T: y is Xc Wc unrounded).
//   rows i (16-row strips, one a warp): pass 1 the row max m_i of the
//     masked s = bf16(q_i) Xc^T; pass 2 pu = exp(s - m_i), l_i = sum pu
//     and Delta_i = sum_j dp_ij p_ij; pass 3 ds = p (dp - Delta), dq_i =
//     ds X.
//   columns j (the same strips): s^T recomputed from Xc_j and Q16, p^T
//     from m and l; dy_j = sum_i p_ij G_i; then ds^T with dp^T = Xc_j
//     gw^T, u_j = sum_i ds_ij Xc_i, and dX_j += u_j Ac (= sum_i ds_ij q_i,
//     q = Xc Ac unrounded).
//   dA_h += X^T dq, dWvo_h += X^T dy (the block's partials), and dX +=
//     dq A_h^T + dy Wvo_h^T with the float32 weights.
// The [B, B] arrays never leave the SM: s, p, dp and ds live in registers
// 32 columns at a time. The float32 operand a product reads across its
// k loop (X, g, gw, dq, dy) is staged in chunks of 32 rows that every
// warp reads, the block's warps walking the chunks together; gw, dq and
// dy live in the block's slice of the scratch (3 Bp D floats), and dX
// sums over heads in the output (float32 x) or in a fourth slice (bf16
// x), each element read and written by the thread that owns it, so runs
// repeat bit for bit.
//
// V selects a test-only variant: a fault planted in the body, which the
// card tests and chip_smoke.py's controls must reject. kOneTf32 keeps only
// the hi*hi pass of every float32-grade product (single-pass TF32, 2^-11
// of each product); kNoDqA0 leaves head 0's dq A_0^T out of dX. Only
// <128, float> is built with them.
enum BwdVariant { kExact = 0, kOneTf32 = 1, kNoDqA0 = 2 };

template <int D, typename XT, int V = kExact>
__global__ void __launch_bounds__(kThreads, 1) tc_mha_bwd_kernel(const MhaArgs a) {
  constexpr int ND = D / 8, KD = D / 16, LD = D + 4;
  constexpr bool one = V == kOneTf32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t rows_s[kTcMaxB / 32];
  const int B = a.b, H = a.heads, HD = H * D;
  const int Bp = (B + 31) / 32 * 32;
  const int B16 = (B + 15) / 16 * 16;
  const int chunks = Bp / kChunk, rounds = (B16 / 16 + kWarps - 1) / kWarps;
  bf16* Xn = reinterpret_cast<bf16*>(smem_raw);
  bf16* Q16 = Xn + Bp * D;
  bf16* TA = Q16 + Bp * D;
  float* WS = reinterpret_cast<float*>(Q16);  // after the columns: A_h or Wvo_h, float32
  bf16* TW = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Q16) +
                                     tc_bwd_qa_bytes(Bp, D));
  float* CH = reinterpret_cast<float*>(TW);  // after gw: the staged chunks
  int32_t* keep_s =
      reinterpret_cast<int32_t*>(reinterpret_cast<unsigned char*>(TW) + tc_bwd_chunks_bytes(D));
  float* pad_s = reinterpret_cast<float*>(keep_s + (Bp / 32) * Bp);
  float* M_s = pad_s + Bp;    // row max of the kept scores
  float* IL_s = M_s + Bp;     // 1 / max(row sum, 1e-10)
  float* DL_s = IL_s + Bp;    // Delta = sum_j dp p
  const size_t bd = (size_t)B * D, pd = (size_t)Bp * D;
  float* GW = a.scratch + (size_t)blockIdx.x * scratch_floats(false, true, B, D, sizeof(XT) == 2);
  float* DQ = GW + pd;
  float* DY = DQ + pd;
  float* dA = a.dA + (size_t)blockIdx.x * D * HD;
  float* dW = a.dWvo + (size_t)blockIdx.x * D * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;

  for (int k = blockIdx.x; k < a.nb; k += gridDim.x) {
    const XT* xk = static_cast<const XT*>(a.x) + k * bd;
    const XT* gk = static_cast<const XT*>(a.g) + k * bd;
    float* DX = sizeof(XT) == 4 ? static_cast<float*>(a.out) + k * bd : DY + pd;
    __syncthreads();  // the previous partition's shared memory is no longer read
    stage_rows<D>(Xn, xk, B, Bp);
    stage_gate(keep_s, pad_s, rows_s, a.keep + (size_t)k * (Bp / 32) * B, a.pad + (size_t)k * B,
               B, Bp);

    for (int h = 0; h < H; ++h) {
      stage_tile<D>(TA, a.wt + h * D * D);
      stage_tile<D>(TW, a.wt + (H + h) * D * D);
      for (int i = threadIdx.x; i < Bp; i += kThreads) {
        M_s[i] = kNeg;
        IL_s[i] = 0.f;
        DL_s[i] = 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();  // Ac, Wc visible
      // Q16 = bf16(Xc Ac) for every row; gw = G Wc^T (Wc exact) for the rows < B16
      for (int r0 = warp * 16; r0 < Bp; r0 += kWarps * 16) {
        const int rA = r0 + g, rB = rA + 8;
        float c[ND][4];
        strip_gemm<D>(c, Xn, r0, TA);
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const int n = 8 * t + 2 * c4;
          *reinterpret_cast<uint32_t*>(Q16 + sw<D>(rA, n)) = pack_bf16(c[t][0], c[t][1]);
          *reinterpret_cast<uint32_t*>(Q16 + sw<D>(rB, n)) = pack_bf16(c[t][2], c[t][3]);
        }
        if (r0 >= B16) continue;
        zero<D>(c);
        const float pA = pad_s[rA], pB = pad_s[rB];
#pragma unroll 2
        for (int k0 = 0; k0 < D; k0 += 8) {
          const int d = k0 + 2 * c4;
          float2 ga = make_float2(0.f, 0.f), gb = ga;
          if (rA < B) ga = ld2(gk + (size_t)rA * D + d);
          if (rB < B) gb = ld2(gk + (size_t)rB * D + d);
          const Tf32A ap = split_a(ga.x * pA, gb.x * pB, ga.y * pA, gb.y * pB);
          mma2b_row<ND, one>(c, ap, [&](int nt) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(TW + sw<D>(8 * nt + g, d));
            return make_uint2(bf_lo(v), bf_hi(v));
          });
        }
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const int n = 8 * t + 2 * c4;
          *reinterpret_cast<float2*>(GW + (size_t)rA * D + n) = make_float2(c[t][0], c[t][1]);
          *reinterpret_cast<float2*>(GW + (size_t)rB * D + n) = make_float2(c[t][2], c[t][3]);
        }
      }
      __syncthreads();  // Q16 and GW complete; Wc's room is free for the chunks

      // --- rows: m, l, Delta, then dq with X staged chunk by chunk
      for (int round = 0; round < rounds; ++round) {
        const int r0 = (round * kWarps + warp) * 16;
        const bool active = r0 < B16;
        const int rA = r0 + g, rB = rA + 8;
        const int32_t* kw = keep_s + (r0 >> 5) * Bp;
        const int bitA = (r0 & 31) + g;
        const float* gws = GW + (size_t)r0 * D;  // the strip's gw (L1-resident)
        float mA = kNeg, mB = kNeg, ilA = 0.f, ilB = 0.f, dlA = 0.f, dlB = 0.f;
        if (active) {
          // pass 1: the row max of the kept scores
          for (int j0 = 0; j0 < Bp; j0 += 32) {
            float s[4][4];
            score_chunk_smem<D>(s, Q16, r0, Xn, j0);
            mask_chunk(s, kw, j0, bitA);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              mA = fmaxf(mA, fmaxf(s[t][0], s[t][1]));
              mB = fmaxf(mB, fmaxf(s[t][2], s[t][3]));
            }
          }
          mA = quad_max(mA);
          mB = quad_max(mB);
          // pass 2: pu = exp(s - m) on the kept scores (0 elsewhere), the
          // row sums of pu and of pu dp
          float lA = 0.f, lB = 0.f, eA = 0.f, eB = 0.f;
          for (int j0 = 0; j0 < Bp; j0 += 32) {
            float s[4][4], dp[4][4];
            score_chunk_smem<D>(s, Q16, r0, Xn, j0);
            mask_chunk(s, kw, j0, bitA);
            dp_chunk<D, one>(dp, gws, Xn, j0);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float pu = s[t][e] > -1e29f ? expf(s[t][e] - (e < 2 ? mA : mB)) : 0.f;
                if (e < 2) {
                  lA += pu;
                  eA += pu * dp[t][e];
                } else {
                  lB += pu;
                  eB += pu * dp[t][e];
                }
              }
            }
          }
          ilA = 1.f / fmaxf(quad_sum(lA), 1e-10f);
          ilB = 1.f / fmaxf(quad_sum(lB), 1e-10f);
          dlA = quad_sum(eA) * ilA;
          dlB = quad_sum(eB) * ilB;
          if (c4 == 0) {
            M_s[rA] = mA;
            IL_s[rA] = ilA;
            DL_s[rA] = dlA;
            M_s[rB] = mB;
            IL_s[rB] = ilB;
            DL_s[rB] = dlB;
          }
        }
        // pass 3: ds = p (dp - Delta), dq = ds X
        float dq[ND][4];
        zero<D>(dq);
        chunk_loop<D>(CH, xk, chunks, B, [&](int c, const float* Xs) {
          if (!active) return;
          const int j0 = c * kChunk;
          float s[4][4], dp[4][4];
          score_chunk_smem<D>(s, Q16, r0, Xn, j0);
          mask_chunk(s, kw, j0, bitA);
          dp_chunk<D, one>(dp, gws, Xn, j0);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool top = e < 2;
              const float p =
                  s[t][e] > -1e29f ? expf(s[t][e] - (top ? mA : mB)) * (top ? ilA : ilB) : 0.f;
              s[t][e] = p * (dp[t][e] - (top ? dlA : dlB));
            }
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) {  // k8 block t: rows 8t .. 8t + 7 of the chunk
            const Tf32A ap = acc_as_a(s[t]);
            const float* xr = Xs + (8 * t + 2 * c4) * LD + g;
            mma3_row<ND, one>(dq, ap,
                              [&](int nt) { return make_float2(xr[8 * nt], xr[LD + 8 * nt]); });
          }
        });
        if (active) {
#pragma unroll
          for (int t = 0; t < ND; ++t) {
            const int n = 8 * t + 2 * c4;
            *reinterpret_cast<float2*>(DQ + (size_t)rA * D + n) =
                make_float2(dq[t][0], dq[t][1]);
            *reinterpret_cast<float2*>(DQ + (size_t)rB * D + n) =
                make_float2(dq[t][2], dq[t][3]);
          }
        }
      }
      __syncthreads();  // m, 1/l and Delta of every row

      // --- columns: dy with g staged, then u with gw staged and dX += u Ac
      for (int pass = 0; pass < 2; ++pass) {
        for (int round = 0; round < rounds; ++round) {
          const int j0 = (round * kWarps + warp) * 16;
          const bool active = j0 < B16;
          const int jA = j0 + g, jB = jA + 8;
          uint32_t xf[KD][4];  // Xc_j as the A operand of s^T = Xc_j bf16(q)^T
          if (active) {
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
              ldsm_x4(xf[kk], Xn + sw<D>(j0 + (lane & 15), kk * 16 + ((lane >> 4) << 3)));
          }
          // p^T of the rows i0 .. i0 + 31: s^T masked by the gate bit of
          // (row i, column j), then exp(s - m_i) / l_i
          auto p_chunk = [&](float (&s)[4][4], int i0) {
            score_chunk<D>(s, xf, Q16, i0);
            const int32_t wA = keep_s[(i0 >> 5) * Bp + jA], wB = keep_s[(i0 >> 5) * Bp + jB];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int bit = 8 * t + 2 * c4 + e, i = i0 + bit;
                const float m = M_s[i], il = IL_s[i];
                s[t][e] = (wA >> bit) & 1 ? expf(s[t][e] - m) * il : 0.f;
                s[t][2 + e] = (wB >> bit) & 1 ? expf(s[t][2 + e] - m) * il : 0.f;
              }
            }
          };
          float acc[ND][4];  // dy_j, then u_j
          zero<D>(acc);
          if (pass == 0) {
            chunk_loop<D>(CH, gk, chunks, B, [&](int c, const float* Gs) {
              if (!active) return;
              const int i0 = c * kChunk;
              float p[4][4];
              p_chunk(p, i0);
#pragma unroll
              for (int t = 0; t < 4; ++t) {  // dy += (p^T pad) g, k8 block t: rows 8t ..
                const float p0 = pad_s[i0 + 8 * t + 2 * c4], p1 = pad_s[i0 + 8 * t + 2 * c4 + 1];
                const Tf32A ap = split_a(p[t][0] * p0, p[t][2] * p0, p[t][1] * p1, p[t][3] * p1);
                const float* gr = Gs + (8 * t + 2 * c4) * LD + g;
                mma3_row<ND, one>(acc, ap,
                             [&](int nt) { return make_float2(gr[8 * nt], gr[LD + 8 * nt]); });
              }
            });
            if (active) {
#pragma unroll
              for (int t = 0; t < ND; ++t) {
                const int n = 8 * t + 2 * c4;
                *reinterpret_cast<float2*>(DY + (size_t)jA * D + n) =
                    make_float2(acc[t][0], acc[t][1]);
                *reinterpret_cast<float2*>(DY + (size_t)jB * D + n) =
                    make_float2(acc[t][2], acc[t][3]);
              }
            }
            continue;
          }
          chunk_loop<D>(CH, static_cast<const float*>(GW), chunks, B, [&](int c,
                                                                          const float* Ws) {
            if (!active) return;
            const int i0 = c * kChunk;
            float p[4][4], dp[4][4];
            p_chunk(p, i0);
#pragma unroll
            for (int t = 0; t < 4; ++t) dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {  // dp^T = Xc_j gw^T, Xc exact
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const uint32_t xa[4] = {bf_lo(xf[kk][2 * hf]), bf_lo(xf[kk][2 * hf + 1]),
                                        bf_hi(xf[kk][2 * hf]), bf_hi(xf[kk][2 * hf + 1])};
                const int d = kk * 16 + hf * 8 + 2 * c4;
                mma2a_row<4, one>(dp, xa, [&](int nt) {
                  return *reinterpret_cast<const float2*>(Ws + (8 * nt + g) * LD + d);
                });
              }
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float dl = DL_s[i0 + 8 * t + 2 * c4 + e];
                p[t][e] *= dp[t][e] - dl;
                p[t][2 + e] *= dp[t][2 + e] - dl;
              }
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) {  // u += ds^T Xc, k8 block t: rows i0 + 8t ..
              const Tf32A ap = acc_as_a(p[t]);
              const int i = i0 + 8 * t + 2 * c4;
              mma2b_row<ND, one>(acc, ap, [&](int nt) {
                return make_uint2(bf_bits(Xn + sw<D>(i, 8 * nt + g)),
                                  bf_bits(Xn + sw<D>(i + 1, 8 * nt + g)));
              });
            }
          });
          if (!active) continue;
          float dx[ND][4];
          zero<D>(dx);
#pragma unroll
          for (int t = 0; t < ND; ++t) {  // dx = u Ac, k8 block t: rows 8t .. of Ac
            const Tf32A ap = acc_as_a(acc[t]);
            const int d = 8 * t + 2 * c4;
            mma2b_row<ND, one>(dx, ap, [&](int nt) {
              return make_uint2(bf_bits(TA + sw<D>(d, 8 * nt + g)),
                                bf_bits(TA + sw<D>(d + 1, 8 * nt + g)));
            });
          }
          const int rows[2] = {jA, jB};
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            if (rows[v] >= B) continue;
#pragma unroll
            for (int t = 0; t < ND; ++t) {
              float2* o = reinterpret_cast<float2*>(DX + (size_t)rows[v] * D + 8 * t + 2 * c4);
              float2 w = make_float2(dx[t][2 * v], dx[t][2 * v + 1]);
              if (h > 0) w = make_float2(o->x + w.x, o->y + w.y);
              *o = w;
            }
          }
        }
      }
      __syncthreads();  // DQ and DY of every row

      // --- dA_h += X^T dq, dWvo_h += X^T dy: warp w owns rows 16w .. of
      // one [D, D] block; X and dq (dy) staged chunk by chunk
      for (int which = 0; which < 2; ++which) {
        const float* M = which == 0 ? DQ : DY;
        const int m0 = warp * 16;
        const bool active = m0 < D;
        float c[ND][4];
        zero<D>(c);
        for (int c0 = 0; c0 < chunks; ++c0) {
          stage_chunk<D>(CH, xk, c0 * kChunk, B);
          stage_chunk<D>(CH + kChunk * LD, M, c0 * kChunk, B);
          cp_async_wait<0>();
          __syncthreads();
          if (active) {
            const float* Xs = CH;
            const float* Ms = CH + kChunk * LD;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int i = 8 * t + 2 * c4;
              const Tf32A ap = split_a(Xs[i * LD + m0 + g], Xs[i * LD + m0 + g + 8],
                                       Xs[(i + 1) * LD + m0 + g], Xs[(i + 1) * LD + m0 + g + 8]);
              const float* mr = Ms + i * LD + g;
              mma3_row<ND, one>(c, ap,
                                [&](int nt) { return make_float2(mr[8 * nt], mr[LD + 8 * nt]); });
            }
          }
          __syncthreads();
        }
        if (active) {
          float* part = (which == 0 ? dA : dW) + h * D;
#pragma unroll
          for (int t = 0; t < ND; ++t) {
            const int n = 8 * t + 2 * c4;
            float2* pa = reinterpret_cast<float2*>(part + (size_t)(m0 + g) * HD + n);
            float2* pb = reinterpret_cast<float2*>(part + (size_t)(m0 + g + 8) * HD + n);
            *pa = make_float2(pa->x + c[t][0], pa->y + c[t][1]);
            *pb = make_float2(pb->x + c[t][2], pb->y + c[t][3]);
          }
        }
      }
      // --- dX += dq A_h^T + dy Wvo_h^T (float32 weights, staged in turn
      // where Q16 and Ac were), the columns' rows; the last head writes dx
      for (int w = 0; w < 2; ++w) {
        const float* Wg = (w == 0 ? a.A_cat : a.Wvo_cat) + h * D;  // rows e, stride H D
        for (int i = threadIdx.x; i < D * (D / 4); i += kThreads) {
          const int r = i / (D / 4), c = (i % (D / 4)) * 4;
          cp_async16(WS + r * LD + c, Wg + (size_t)r * HD + c);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();  // the weight visible
        const float* M = w == 0 ? DQ : DY;
        const bool last = w == 1 && h + 1 == H;
        for (int j0 = warp * 16; j0 < B16; j0 += kWarps * 16) {
          const int jA = j0 + g, jB = jA + 8;
          float c[ND][4];
          zero<D>(c);
#pragma unroll 2
          for (int k0 = 0; k0 < D; k0 += 8) {
            const int d = k0 + 2 * c4;
            const float2 va = ld2(M + (size_t)jA * D + d), vb = ld2(M + (size_t)jB * D + d);
            const Tf32A ap = split_a(va.x, vb.x, va.y, vb.y);
            mma3_row<ND, one>(c, ap, [&](int nt) {
              return *reinterpret_cast<const float2*>(WS + (8 * nt + g) * LD + d);
            });
          }
          if constexpr (V == kNoDqA0) {
            if (w == 0 && h == 0) zero<D>(c);
          }
          const int rows[2] = {jA, jB};
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int r = rows[v];
            if (r >= B) continue;
#pragma unroll
            for (int t = 0; t < ND; ++t) {
              const int n = 8 * t + 2 * c4;
              float2* o = reinterpret_cast<float2*>(DX + (size_t)r * D + n);
              const float2 sum = make_float2(o->x + c[t][2 * v], o->y + c[t][2 * v + 1]);
              if constexpr (sizeof(XT) == 2) {
                if (last)
                  *reinterpret_cast<__nv_bfloat162*>(static_cast<XT*>(a.out) + k * bd +
                                                     (size_t)r * D + n) =
                      __floats2bfloat162_rn(sum.x, sum.y);
                else
                  *o = sum;
              } else {
                *o = sum;
              }
            }
          }
        }
        __syncthreads();  // the weight's room is free
      }
      __syncthreads();  // the head's slices and tiles are no longer read
    }
  }
}

template <int D, typename XT, int V = kExact>
int run_tc_bwd(const MhaArgs& a, int grid, cudaStream_t s) {
  auto kernel = tc_mha_bwd_kernel<D, XT, V>;
  const size_t smem = tc_bwd_smem_bytes((a.b + 31) / 32 * 32, D);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int g = resident_grid(kernel, grid, smem);
  kernel<<<g, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename XT>
int run_tc_bwd_width(const MhaArgs& a, int grid, cudaStream_t s) {
  if (a.d == 128) return run_tc_bwd<128, XT>(a, grid, s);
  if (a.d == 64) return run_tc_bwd<64, XT>(a, grid, s);
  return run_tc_bwd<32, XT>(a, grid, s);
}

__global__ void reduce_partials_kernel(const float* __restrict__ parts, int count, int n,
                                       float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < count; ++c) s += parts[(size_t)c * n + i];
    out[i] = s;
  }
}

template <bool FWD, typename XT, bool BF16>
int run(const MhaArgs& a, int grid, cudaStream_t s) {
  auto kernel = FWD ? mha_fwd_kernel<XT, BF16> : mha_bwd_kernel<XT, BF16>;
  const int g = resident_grid(kernel, grid, 0);
  kernel<<<g, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool FWD>
int run_types(const MhaArgs& a, int grid, int x_bf16, int compute_bf16, cudaStream_t s) {
  if (x_bf16)
    return compute_bf16 ? run<FWD, __nv_bfloat16, true>(a, grid, s)
                        : run<FWD, __nv_bfloat16, false>(a, grid, s);
  return compute_bf16 ? run<FWD, float, true>(a, grid, s) : run<FWD, float, false>(a, grid, s);
}

bool shape_ok(int b, int d, int heads) {
  return b >= 1 && b <= kMaxB && width_ok(d) && heads >= 1;
}

}  // namespace

// Floats of scratch that each block of the grid owns (the caller
// allocates grid times this), for the forward (fwd) or the backward and
// the tensor-core body (tc) or block_gemm's; -1 for a shape no body takes.
extern "C" int gated_block_mha_scratch_floats(int fwd, int tc, int b, int d, int x_bf16) {
  if (b < 1 || b > (tc ? kTcMaxB : kMaxB) || !width_ok(d)) return -1;
  return (int)scratch_floats(fwd != 0, tc != 0, b, d, x_bf16 != 0);
}

// tiles: null for the block_gemm body; else the tensor-core body (bf16
// compute, B <= 256) with the weights as bf16 [D, D] tiles A_0..A_{H-1},
// Wvo_0..Wvo_{H-1} ([in, out] each). scratch: grid x
// gated_block_mha_scratch_floats(1, tiles != null, ...) floats.
extern "C" int gated_block_mha_fwd(const void* x, const void* keep, const void* pad,
                                   const void* A_cat, const void* Wvo_cat, const void* tiles,
                                   void* out, void* scratch, int nb, int b, int d, int heads,
                                   int grid, int x_bf16, int compute_bf16, void* stream) {
  if (!shape_ok(b, d, heads)) return (int)cudaErrorInvalidValue;
  if (tiles != nullptr && (b > kTcMaxB || !compute_bf16)) return (int)cudaErrorInvalidValue;
  MhaArgs a{x, static_cast<const int32_t*>(keep), static_cast<const float*>(pad),
            static_cast<const float*>(A_cat), static_cast<const float*>(Wvo_cat),
            static_cast<const bf16*>(tiles), nullptr, out, nullptr, nullptr,
            static_cast<float*>(scratch), nb, b, d, heads};
  auto s = static_cast<cudaStream_t>(stream);
  if (tiles != nullptr)
    return x_bf16 ? run_tc_fwd_width<bf16>(a, grid, s) : run_tc_fwd_width<float>(a, grid, s);
  return run_types<true>(a, grid, x_bf16, compute_bf16, s);
}

// dA_parts, dWvo_parts: grid x [D, H D] float32, zeroed by the caller
// (blocks past the resident count leave theirs at 0). g and dx have x's
// type. tiles and scratch as for the forward (fwd = 0). variant: 0, or a
// test-only BwdVariant of the tensor-core body at D = 128 on float32 x.
extern "C" int gated_block_mha_bwd(const void* x, const void* keep, const void* pad,
                                   const void* A_cat, const void* Wvo_cat, const void* tiles,
                                   const void* g, void* dx, void* dA_parts, void* dWvo_parts,
                                   void* scratch, int nb, int b, int d, int heads, int grid,
                                   int x_bf16, int compute_bf16, int variant, void* stream) {
  if (!shape_ok(b, d, heads)) return (int)cudaErrorInvalidValue;
  if (tiles != nullptr && (b > kTcMaxB || !compute_bf16)) return (int)cudaErrorInvalidValue;
  if (variant != kExact && (tiles == nullptr || d != 128 || x_bf16 ||
                            (variant != kOneTf32 && variant != kNoDqA0)))
    return (int)cudaErrorInvalidValue;
  MhaArgs a{x, static_cast<const int32_t*>(keep), static_cast<const float*>(pad),
            static_cast<const float*>(A_cat), static_cast<const float*>(Wvo_cat),
            static_cast<const bf16*>(tiles), g, dx, static_cast<float*>(dA_parts),
            static_cast<float*>(dWvo_parts), static_cast<float*>(scratch), nb, b, d, heads};
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == kOneTf32) return run_tc_bwd<128, float, kOneTf32>(a, grid, s);
  if (variant == kNoDqA0) return run_tc_bwd<128, float, kNoDqA0>(a, grid, s);
  if (tiles != nullptr)
    return x_bf16 ? run_tc_bwd_width<bf16>(a, grid, s) : run_tc_bwd_width<float>(a, grid, s);
  return run_types<false>(a, grid, x_bf16, compute_bf16, s);
}

// out[i] = sum over c = 0..count-1, in that order, of parts[c][i]
extern "C" int reduce_partials(const void* parts, int count, int n, void* out, void* stream) {
  if (count < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks);
  reduce_partials_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(parts), count, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
