// The fused gated graph-transformer layer (K4a) and the same layer
// emitting the next layer's gate signature (K4b), one code path.
//
// Replaces ruvector_tpu/ops/pallas/gated_block_layer.py:195
// gated_block_layer and :251 gated_block_layer_with_sig (kernel :58-166).
// Per partition (a halo-free block-dense block, local table == block):
//   h  = LN1(x); per head: s = (h A_h) h^T, masked to -1e30 where the gate
//        bit and the pad pair are not both set, p = exp(s - max), and
//        attn += (p (h Wvo_h)) / sum(p) (0 for a row with nothing kept);
//        x += attn * pad
//   g  = LN_g(x); x += ((wd g) Wg + bg) * pad
//   h2 = LN2(x);  x += (gelu_tanh(h2 Wi + bi) Wo + bo) * pad
// then out = x in the IO type, and for K4b the gate signature of the next
// layer (gate_signature, gated_common.cuh) on out as written.
//
// What bounds it on an H100: the least work is 2 n (H (2D + 2B) D +
// (B + D) D + 2 F D^2) bf16 operations (1.15e12 at 1M nodes, B=256,
// D=128, H=4, F=4: 1.16 ms at 989 TFLOP/s) against 1.57 GB of bytes
// (0.47 ms), so it is bound by operations, on the tensor cores.
//
// Two bodies, chosen by the wrapper on shape and compute type (an
// explicit dispatch, not a fallback):
//
// * tc_layer_kernel (bf16 compute, B <= 256): every product on the tensor
//   cores, mma.sync m16n8k16 with bf16 operands and float32 sums, the
//   operands read from shared memory with ldmatrix. One block of 8 warps
//   owns one partition at a time (a persistent grid, one block per SM):
//   sublayer 2 mixes all B rows, so the block needs the whole partition.
//   Shared memory holds, as bf16, the normalised rows Hn [B, D], one
//   head's y_h = Hn Wvo_h [B, D] and two [D, D] weight tiles: 192 KB at
//   B=256, D=128, plus the gate words and pad. The weights come as a bf16
//   copy (the wrapper rounds them once, the bits of rounding at load),
//   staged with cp.async so that the next head's Wvo (and after the last
//   head W_gnn, then the first FFN tile) loads while the current product
//   runs. Each warp owns 16-row strips: q_h = Hn A_h stays in registers
//   as the A operand of s = q_h Hn^T, which is computed in 32-column
//   chunks, masked and exponentiated in registers and multiplied into
//   y_h in the same warp, so the [B, B] scores never leave the SM. The
//   softmax takes two passes over the chunks (the second recomputes s):
//   the first finds the row max, the second rounds p = exp(s - row max)
//   to bf16, as the TPU kernel does (an online softmax would round p
//   against a running max, the documented difference of K1/K2; at B=256
//   recomputing s costs a quarter more attention products and keeps the
//   TPU kernel's rounding). The neighbour mix reads wd straight from
//   global memory as the A operand (once per partition); the FFN runs in
//   D-wide chunks of its hidden layer with the tanh GELU applied to the
//   accumulators. The float32 residual stream and the per-row sums over
//   heads and FFN chunks live in the block's slice of a global scratch
//   buffer (2 B D floats, 256 KB; 34 MB over the grid, inside the 50 MB
//   L2), read and written a few times per layer. With 8 warps per SM a
//   pass that waits on memory one row at a time costs about as much as
//   the products, so those passes keep loads in flight: the LayerNorms
//   take four rows of a warp at once (the residual add of sublayer 1
//   fused into LN_g's pass), the output pass two columns a thread and
//   four pairs at once, the mix four k-steps of wd before their
//   products. The gate words are staged with the pad pair folded in, so
//   the mask of a score is one bit test.
// * layer_kernel (float32 compute, or B in (256, 512]): every product
//   through block_gemm (gated_common.cuh) on the CUDA cores in float32
//   FMA, operands from the global scratch (5 B D + B^2 + B floats per
//   block). TF32 tensor cores would break the float32 tolerance of
//   1e-4 / 1e-5, so float32 compute stays here.
//
// Rounding in both follows the TPU kernel: every product takes
// compute-type operands with float32 sums; q and y are rounded before
// s and p y; the softmax weights are rounded un-normalised and the row
// sums taken over the unrounded ones; the residual stream stays float32
// and is rounded once at the output.

#include "gated_tc.cuh"

namespace {

using namespace rvt;

struct LayerArgs {
  const void* x;        // [nB, B, D] float32 or bf16
  const int32_t* keep;  // [nB, ceil(B/32), B] gate bits
  const float* pad;     // [nB, B]
  const void* wd;       // [nB, B, B] float32 or bf16
  const float *A_cat, *Wvo_cat;                       // [D, H D]
  const float *ln1_g, *ln1_b, *lng_g, *lng_b, *ln2_g, *ln2_b;  // [D]
  const float *Wg, *bg, *Wi, *bi, *Wo, *bo;           // [D,D],[D],[D,F D],[F D],[F D,D],[D]
  const float *As, *sg, *sb;                          // next layer's signature, or null
  const bf16* wt;       // tensor-core body: bf16 [D, D] tiles A_h, Wvo_h, Wg, Wi_c, Wo_c
  void* out;            // [nB, B, D] like x
  float *rsum, *rcnt;   // [nB, B] (K4b)
  float* scratch;       // grid x (5 B D + B B + B)
  int nb, b, d, heads, fm, x_bf16, wd_bf16;
  float ln_eps, sig_eps;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

template <typename XT, typename WT, bool BF16, bool SIG>
__global__ void __launch_bounds__(kThreads) layer_kernel(const LayerArgs a) {
  __shared__ GemmSmem gs;
  __shared__ float pad[kMaxB];
  const int b = a.b, d = a.d, hd = a.heads * d;
  const int words = (b + 31) / 32;
  const size_t bd = (size_t)b * d;
  float* X = a.scratch + (size_t)blockIdx.x * (5 * bd + (size_t)b * b + b);
  float* Hn = X + bd;
  float* Q = Hn + bd;
  float* Y = Q + bd;
  float* ATT = Y + bd;
  float* S = ATT + bd;
  float* INV = S + (size_t)b * b;
  const int tid = threadIdx.x;

  for (int k = blockIdx.x; k < a.nb; k += gridDim.x) {
    const XT* xk = static_cast<const XT*>(a.x) + (size_t)k * bd;
    const int32_t* keepk = a.keep + (size_t)k * words * b;
    __syncthreads();  // the previous partition's pad is no longer read
    for (int i = tid; i < b; i += kThreads) pad[i] = a.pad[(size_t)k * b + i];
    for (size_t i = tid; i < bd; i += kThreads) {
      X[i] = ldf(xk + i);
      ATT[i] = 0.f;
    }
    __syncthreads();

    // --- sublayer 1: gated MHA over h = LN1(x) ---
    layer_norm_rows<false>(X, Hn, a.ln1_g, a.ln1_b, b, d, a.ln_eps);
    for (int h = 0; h < a.heads; ++h) {
      block_gemm<BF16, false>(Hn, d, a.A_cat + h * d, hd, b, d, d, gs,
                              [&](int m, int n, float v) { Q[(size_t)m * d + n] = v; });
      block_gemm<BF16, false>(Hn, d, a.Wvo_cat + h * d, hd, b, d, d, gs,
                              [&](int m, int n, float v) { Y[(size_t)m * d + n] = v; });
      block_gemm<BF16, true>(Q, d, Hn, d, b, b, d, gs,
                             [&](int m, int n, float v) { S[(size_t)m * b + n] = v; });
      // masked exp against the row max (un-normalised), 1/sum per row
      masked_exp_rows(S, keepk, pad, b, INV);
      block_gemm<BF16, false>(S, b, Y, d, b, d, b, gs, [&](int m, int n, float v) {
        ATT[(size_t)m * d + n] += v * INV[m];
      });
    }
    for (size_t i = tid; i < bd; i += kThreads) X[i] += ATT[i] * pad[i / d];
    __syncthreads();

    // --- sublayer 2: neighbour mix within the partition ---
    layer_norm_rows<false>(X, Hn, a.lng_g, a.lng_b, b, d, a.ln_eps);
    block_gemm<BF16, false>(static_cast<const WT*>(a.wd) + (size_t)k * b * b, b, Hn, d, b, d,
                            b, gs, [&](int m, int n, float v) { Q[(size_t)m * d + n] = v; });
    block_gemm<BF16, false>(Q, d, a.Wg, d, b, d, d, gs, [&](int m, int n, float v) {
      X[(size_t)m * d + n] += (v + a.bg[n]) * pad[m];
    });

    // --- sublayer 3: pre-norm FFN, the hidden in D-wide chunks ---
    layer_norm_rows<false>(X, Hn, a.ln2_g, a.ln2_b, b, d, a.ln_eps);
    for (int c = 0; c < a.fm; ++c) {
      block_gemm<BF16, false>(Hn, d, a.Wi + c * d, a.fm * d, b, d, d, gs,
                              [&](int m, int n, float v) {
                                Q[(size_t)m * d + n] = gelu_tanh(v + a.bi[c * d + n]);
                              });
      block_gemm<BF16, false>(Q, d, a.Wo + (size_t)c * d * d, d, b, d, d, gs,
                              [&](int m, int n, float v) {
                                float& f = ATT[(size_t)m * d + n];
                                f = c == 0 ? v : f + v;
                              });
    }
    XT* outk = static_cast<XT*>(a.out) + (size_t)k * bd;
    for (size_t i = tid; i < bd; i += kThreads) {
      const int m = (int)(i / d), n = (int)(i % d);
      const float v = X[i] + (ATT[i] + a.bo[n]) * pad[m];
      if constexpr (sizeof(XT) == 2) {
        const __nv_bfloat16 o = __float2bfloat16(v);
        outk[i] = o;
        X[i] = __bfloat162float(o);
      } else {
        outk[i] = v;
        X[i] = v;
      }
    }
    __syncthreads();

    // --- K4b: the next layer's gate signature from the written stream ---
    if constexpr (SIG) {
      gate_signature<BF16>(static_cast<const float*>(X), pad, a.As, a.sg, a.sb, a.sig_eps, b,
                           d, Hn, Q, S, gs, a.rsum + (size_t)k * b, a.rcnt + (size_t)k * b);
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core body
// ---------------------------------------------------------------------------

// One pass over rows r < Bp, a warp per row and kRows rows of a warp in
// flight (their loads issued together: with one block of 8 warps per SM
// a row at a time waits on memory): x = src[r], plus att[r] * pad[r]
// stored to X[r] with RESID (the residual add of sublayer 1), then
// LN(x) into the bf16 row r of Hn in shared memory (the steps of
// layer_norm_rows, rounded to bf16 at the end); rows [B, Bp) become 0.
template <int D, bool RESID, typename T>
__device__ void ln_pass(const T* __restrict__ src, const float* __restrict__ att, float* X,
                        const float* pad_s, bf16* Hn, const float* __restrict__ g,
                        const float* __restrict__ bb, int B, int Bp, float eps) {
  constexpr int kRows = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float fd = (float)D;
  for (int r0 = warp; r0 < Bp; r0 += kWarps * kRows) {
    float v[kRows][4];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + kWarps * u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        float x = 0.f;
        if (c < D && r < B) {
          x = ldf(src + (size_t)r * D + c);
          if constexpr (RESID) x += att[(size_t)r * D + c] * pad_s[r];
        }
        v[u][j] = x;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + kWarps * u;
      if (r >= Bp) break;
      if (r >= B) {
        for (int c = lane; c < D; c += 32) Hn[sw<D>(r, c)] = __float2bfloat16(0.f);
        continue;
      }
      float t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (RESID) {
          if (lane + 32 * j < D) X[(size_t)r * D + lane + 32 * j] = v[u][j];
        }
        t[j] = v[u][j];
      }
      const float mean = __fdiv_rn(tree_sum(t), fd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[u][j] = lane + 32 * j < D ? __fsub_rn(v[u][j], mean) : 0.f;
        t[j] = __fmul_rn(v[u][j], v[u][j]);
      }
      const float sd = __fsqrt_rn(__fadd_rn(__fdiv_rn(tree_sum(t), fd), eps));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (c < D)
          Hn[sw<D>(r, c)] =
              __float2bfloat16(__fadd_rn(__fmul_rn(__fdiv_rn(v[u][j], sd), g[c]), bb[c]));
      }
    }
  }
}

// Shared-memory bytes of the tensor-core body for a partition padded to
// Bp rows (a multiple of 32): Hn and Y [Bp, D], two [D, D] tiles (bf16),
// the gate words [Bp/32, Bp] and pad [Bp].
inline size_t tc_smem_bytes(int bp, int d) {
  return (size_t)2 * bp * d * 2 + (size_t)2 * d * d * 2 + (size_t)(bp / 32) * bp * 4 +
         (size_t)bp * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) tc_layer_kernel(const LayerArgs a) {
  constexpr int ND = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ GemmSmem gs;  // K4b's signature epilogue (block_gemm)
  __shared__ uint32_t rows_s[kTcMaxB / 32];  // pad-valid rows of each gate word
  const int B = a.b, H = a.heads, F = a.fm;
  const int Bp = (B + 31) / 32 * 32;   // rows and score columns, zero-filled past B
  const int B16 = (B + 15) / 16 * 16;  // rows that hold a valid row
  bf16* Hn = reinterpret_cast<bf16*>(smem_raw);
  bf16* Y = Hn + Bp * D;
  bf16* W0 = Y + Bp * D;
  bf16* W1 = W0 + D * D;
  int32_t* keep_s = reinterpret_cast<int32_t*>(W1 + D * D);
  float* pad_s = reinterpret_cast<float*>(keep_s + (Bp / 32) * Bp);
  const size_t bd = (size_t)B * D;
  float* X = a.scratch + (size_t)blockIdx.x * (5 * bd + (size_t)B * B + B);
  float* Hs = X + bd;   // K4b's epilogue: LN rows, q and logits
  float* Qs = Hs + bd;
  float* ATT = Qs + 2 * bd;
  float* Ss = ATT + bd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const bf16* tA = a.wt;                // A_h: tile h
  const bf16* tV = a.wt + H * D * D;    // Wvo_h
  const bf16* tG = tV + H * D * D;      // Wg
  const bf16* tI = tG + D * D;          // Wi_c
  const bf16* tO = tI + F * D * D;      // Wo_c

  for (int k = blockIdx.x; k < a.nb; k += gridDim.x) {
    const size_t xoff = (size_t)k * bd;
    const int32_t* keepk = a.keep + (size_t)k * (Bp / 32) * B;
    __syncthreads();  // the previous partition's shared memory is no longer read
    stage_tile<D>(W1, tV);  // Wvo_0, then A_0: the order the heads wait for them
    stage_tile<D>(W0, tA);
    for (int i = tid; i < Bp; i += kThreads) pad_s[i] = i < B ? a.pad[(size_t)k * B + i] : 0.f;
    __syncthreads();
    if (warp < Bp / 32) rows_s[warp] = __ballot_sync(0xffffffffu, pad_s[warp * 32 + lane] > 0.f);
    __syncthreads();
    // the gate words with the pad pair folded in: bit r of word j is kept
    // only where rows r and j are both pad-valid
    for (int i = tid; i < (Bp / 32) * Bp; i += kThreads) {
      const int w = i / Bp, j = i % Bp;
      keep_s[i] = pad_s[j] > 0.f ? keepk[(size_t)w * B + j] & (int32_t)rows_s[w] : 0;
    }
    if (a.x_bf16)
      ln_pass<D, false>(static_cast<const bf16*>(a.x) + xoff, ATT, X, pad_s, Hn, a.ln1_g,
                        a.ln1_b, B, Bp, a.ln_eps);
    else
      ln_pass<D, false>(static_cast<const float*>(a.x) + xoff, ATT, X, pad_s, Hn, a.ln1_g,
                        a.ln1_b, B, Bp, a.ln_eps);

    // --- sublayer 1: gated MHA; in flight on entry to head h: Wvo_h, A_h
    for (int h = 0; h < H; ++h) {
      cp_async_wait<1>();
      __syncthreads();  // Wvo_h (and Hn) visible
      for (int r0 = warp * 16; r0 < Bp; r0 += kWarps * 16) {  // y_h = Hn Wvo_h, every row
        float c[ND][4];
        strip_gemm<D>(c, Hn, r0, W1);
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
      } else {
        stage_tile<D>(W1, tG);
      }
      cp_async_wait<1>();
      __syncthreads();  // A_h visible
      for (int r0 = warp * 16; r0 < B16; r0 += kWarps * 16) {
        uint32_t q[KD][4];
        {
          float c[ND][4];
          strip_gemm<D>(c, Hn, r0, W0);
          to_frags<D>(q, c);
        }
        const int rA = r0 + g, rB = rA + 8;
        const int32_t* kw = keep_s + (r0 >> 5) * Bp;
        const int bitA = (r0 & 31) + g;
        // pass 1: the row max of the kept scores
        float mA = kNeg, mB = kNeg;
        for (int j0 = 0; j0 < Bp; j0 += 32) {
          float s[4][4];
          score_chunk<D>(s, q, Hn, j0);
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
          score_chunk<D>(s, q, Hn, j0);
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
        const float invA = mA > -1e29f ? 1.f / fmaxf(sumA, 1e-10f) : 0.f;
        const float invB = mB > -1e29f ? 1.f / fmaxf(sumB, 1e-10f) : 0.f;
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const int n = 8 * t + 2 * c4;
          if (rA < B) {
            float2* dst = reinterpret_cast<float2*>(ATT + (size_t)rA * D + n);
            float2 v = make_float2(o[t][0] * invA, o[t][1] * invA);
            if (h > 0) v = make_float2(dst->x + v.x, dst->y + v.y);
            *dst = v;
          }
          if (rB < B) {
            float2* dst = reinterpret_cast<float2*>(ATT + (size_t)rB * D + n);
            float2 v = make_float2(o[t][2] * invB, o[t][3] * invB);
            if (h > 0) v = make_float2(dst->x + v.x, dst->y + v.y);
            *dst = v;
          }
        }
      }
      __syncthreads();  // W0 and Y are no longer read
      stage_tile<D>(W0, h + 1 < H ? tA + (h + 1) * D * D : tI);  // A_{h+1}, or Wi_0
    }

    // --- sublayer 2: neighbour mix; in flight: Wg (W1), Wi_0 (W0)
    // x += attn * pad, then g = LN_g(x)
    if (a.x_bf16)
      ln_pass<D, true>(static_cast<const bf16*>(a.x) + xoff, ATT, X, pad_s, Hn, a.lng_g,
                       a.lng_b, B, Bp, a.ln_eps);
    else
      ln_pass<D, true>(static_cast<const float*>(a.x) + xoff, ATT, X, pad_s, Hn, a.lng_g,
                       a.lng_b, B, Bp, a.ln_eps);
    cp_async_wait<1>();
    __syncthreads();  // g and Wg visible
    {
      const size_t woff = (size_t)k * B * B;
      auto wd_at = [&](int r, int col) -> float {
        if (r >= B || col >= B) return 0.f;
        const size_t i = woff + (size_t)r * B + col;
        return a.wd_bf16 ? __bfloat162float(static_cast<const bf16*>(a.wd)[i])
                         : static_cast<const float*>(a.wd)[i];
      };
      for (int r0 = warp * 16; r0 < B16; r0 += kWarps * 16) {
        const int rA = r0 + g, rB = rA + 8;
        float c[ND][4];
        zero<D>(c);
        for (int k0 = 0; k0 < B16; k0 += 64) {  // agg = wd g, wd from global memory
          uint32_t af[4][4];  // four k-steps of wd loaded before their products
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = k0 + 16 * u + 2 * c4;
            af[u][0] = pack_bf16(wd_at(rA, j), wd_at(rA, j + 1));
            af[u][1] = pack_bf16(wd_at(rB, j), wd_at(rB, j + 1));
            af[u][2] = pack_bf16(wd_at(rA, j + 8), wd_at(rA, j + 9));
            af[u][3] = pack_bf16(wd_at(rB, j + 8), wd_at(rB, j + 9));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (k0 + 16 * u < B16) mma_row_k16<D>(c, af[u], Hn, k0 + 16 * u);
        }
        uint32_t f[KD][4];
        to_frags<D>(f, c);
        frag_gemm<D>(c, f, W1);  // mix = agg Wg
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const int n = 8 * t + 2 * c4;
          const float b0 = a.bg[n], b1 = a.bg[n + 1];
          if (rA < B) {
            float2* dst = reinterpret_cast<float2*>(X + (size_t)rA * D + n);
            const float p = pad_s[rA];
            *dst = make_float2(dst->x + (c[t][0] + b0) * p, dst->y + (c[t][1] + b1) * p);
          }
          if (rB < B) {
            float2* dst = reinterpret_cast<float2*>(X + (size_t)rB * D + n);
            const float p = pad_s[rB];
            *dst = make_float2(dst->x + (c[t][2] + b0) * p, dst->y + (c[t][3] + b1) * p);
          }
        }
      }
    }
    __syncthreads();  // X complete; Hn and W1 free
    stage_tile<D>(W1, tO);  // Wo_0

    // --- sublayer 3: pre-norm FFN in D-wide chunks of the hidden layer
    ln_pass<D, false>(X, ATT, X, pad_s, Hn, a.ln2_g, a.ln2_b, B, Bp, a.ln_eps);
    for (int c = 0; c < F; ++c) {
      cp_async_wait<0>();
      __syncthreads();  // Wi_c, Wo_c (and h2) visible
      for (int r0 = warp * 16; r0 < B16; r0 += kWarps * 16) {
        const int rA = r0 + g, rB = rA + 8;
        uint32_t f[KD][4];
        {
          float m[ND][4];
          strip_gemm<D>(m, Hn, r0, W0);
#pragma unroll
          for (int t = 0; t < ND; ++t) {
            const int n = c * D + 8 * t + 2 * c4;
            const float b0 = a.bi[n], b1 = a.bi[n + 1];
            m[t][0] = gelu_tanh(m[t][0] + b0);
            m[t][1] = gelu_tanh(m[t][1] + b1);
            m[t][2] = gelu_tanh(m[t][2] + b0);
            m[t][3] = gelu_tanh(m[t][3] + b1);
          }
          to_frags<D>(f, m);
        }
        float o[ND][4];
        frag_gemm<D>(o, f, W1);
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const int n = 8 * t + 2 * c4;
          if (rA < B) {
            float2* dst = reinterpret_cast<float2*>(ATT + (size_t)rA * D + n);
            float2 v = make_float2(o[t][0], o[t][1]);
            if (c > 0) v = make_float2(dst->x + v.x, dst->y + v.y);
            *dst = v;
          }
          if (rB < B) {
            float2* dst = reinterpret_cast<float2*>(ATT + (size_t)rB * D + n);
            float2 v = make_float2(o[t][2], o[t][3]);
            if (c > 0) v = make_float2(dst->x + v.x, dst->y + v.y);
            *dst = v;
          }
        }
      }
      __syncthreads();  // W0 and W1 are no longer read
      if (c + 1 < F) {
        stage_tile<D>(W0, tI + (c + 1) * D * D);
        stage_tile<D>(W1, tO + (c + 1) * D * D);
      }
    }
    // out = x + ffn * pad, two columns a thread and four pairs in flight;
    // X keeps the written stream for K4b's epilogue
    const size_t ooff = (size_t)k * bd;
    constexpr int kPairs = 4;
    for (size_t i0 = 2 * tid; i0 < bd; i0 += 2 * kThreads * kPairs) {
      float2 xv[kPairs], av[kPairs];
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const size_t i = i0 + (size_t)u * 2 * kThreads;
        if (i < bd) {
          xv[u] = *reinterpret_cast<const float2*>(X + i);
          av[u] = *reinterpret_cast<const float2*>(ATT + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const size_t i = i0 + (size_t)u * 2 * kThreads;
        if (i >= bd) break;
        const int m = (int)(i / D), n = (int)(i % D);
        float v0 = xv[u].x + (av[u].x + a.bo[n]) * pad_s[m];
        float v1 = xv[u].y + (av[u].y + a.bo[n + 1]) * pad_s[m];
        if (a.x_bf16) {
          const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + ooff + i) = o;
          v0 = __low2float(o);
          v1 = __high2float(o);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + ooff + i) =
              make_float2(v0, v1);
        }
        *reinterpret_cast<float2*>(X + i) = make_float2(v0, v1);
      }
    }

    // --- K4b: the next layer's gate signature from the written stream ---
    if (a.As != nullptr) {
      __syncthreads();
      gate_signature<true>(static_cast<const float*>(X), pad_s, a.As, a.sg, a.sb, a.sig_eps, B,
                           D, Hs, Qs, Ss, gs, a.rsum + (size_t)k * B, a.rcnt + (size_t)k * B);
    }
  }
}

template <int D>
int run_tc(const LayerArgs& a, int grid, cudaStream_t s) {
  auto kernel = tc_layer_kernel<D>;
  const size_t smem = tc_smem_bytes((a.b + 31) / 32 * 32, D);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int g = resident_grid(kernel, grid, smem);
  kernel<<<g, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT, bool BF16, bool SIG>
int run(const LayerArgs& a, int grid, cudaStream_t s) {
  auto kernel = layer_kernel<XT, WT, BF16, SIG>;
  const int g = resident_grid(kernel, grid, 0);
  kernel<<<g, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT>
int run_cdt(const LayerArgs& a, int grid, int compute_bf16, int sig, cudaStream_t s) {
  if (compute_bf16)
    return sig ? run<XT, WT, true, true>(a, grid, s) : run<XT, WT, true, false>(a, grid, s);
  return sig ? run<XT, WT, false, true>(a, grid, s) : run<XT, WT, false, false>(a, grid, s);
}

}  // namespace

// folded: the 14 pointers of fold_gated_layer_params in FOLDED_KEYS order
// (A_cat, Wvo_cat, ln1_g, ln1_b, lng_g, lng_b, ln2_g, ln2_b, Wg, bg, Wi,
// bi, Wo, bo). A_sig null: K4a; else K4b with its LN1 gamma/beta.
// tiles: null for the block_gemm body; else the tensor-core body (bf16
// compute, B <= 256) with the weights as bf16 [D, D] tiles A_0..A_{H-1},
// Wvo_0..Wvo_{H-1}, Wg, Wi_0..Wi_{F-1}, Wo_0..Wo_{F-1} ([in, out] each).
extern "C" int gated_block_layer(const void* x, const void* keep, const void* pad,
                                 const void* wd, const void* const* folded, const void* tiles,
                                 const void* A_sig, const void* sig_gamma,
                                 const void* sig_beta, void* out, void* rsum, void* rcnt,
                                 void* scratch, int nb, int b, int d, int heads, int fm, int grid,
                                 int x_bf16, int wd_bf16, int compute_bf16, float ln_eps,
                                 float sig_eps, void* stream) {
  if (b > kMaxB || b < 1 || !width_ok(d) || heads < 1 || fm < 1)
    return (int)cudaErrorInvalidValue;
  if (tiles != nullptr && (b > kTcMaxB || !compute_bf16)) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(folded);
  LayerArgs a{x, static_cast<const int32_t*>(keep), static_cast<const float*>(pad), wd,
              f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11],
              f[12], f[13], static_cast<const float*>(A_sig),
              static_cast<const float*>(sig_gamma), static_cast<const float*>(sig_beta),
              static_cast<const bf16*>(tiles), out, static_cast<float*>(rsum),
              static_cast<float*>(rcnt), static_cast<float*>(scratch), nb, b, d, heads, fm,
              x_bf16, wd_bf16, ln_eps, sig_eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (tiles != nullptr) {
    if (d == 128) return run_tc<128>(a, grid, s);
    if (d == 64) return run_tc<64>(a, grid, s);
    return run_tc<32>(a, grid, s);
  }
  const int sig = A_sig != nullptr;
  if (x_bf16)
    return wd_bf16 ? run_cdt<__nv_bfloat16, __nv_bfloat16>(a, grid, compute_bf16, sig, s)
                   : run_cdt<__nv_bfloat16, float>(a, grid, compute_bf16, sig, s);
  return wd_bf16 ? run_cdt<float, __nv_bfloat16>(a, grid, compute_bf16, sig, s)
                 : run_cdt<float, float>(a, grid, compute_bf16, sig, s);
}
