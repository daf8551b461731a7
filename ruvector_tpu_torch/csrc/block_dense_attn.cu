// Block-dense neighbor attention (K2) and the whole fused RuvectorLayer (K1).
//
// Replaces two TPU kernels of ruvector_tpu/ops/pallas/block_dense_attn.py:
//   K2  :81  block_dense_attention    (kernel :38-77)
//   K1  :246 block_dense_layer_fused  (kernel :150-241)
// Both work on the block-dense layout: per block k a local table
// L [T, D] (compute type: float32 or bfloat16) and dense edge weights
// wd [B, T] (float32; the edge mask is wd > 0, real zero-weight edges carry
// 1e-7) with an optional additive log-multiplicity lm [B, T].
//
// K2, per block k and row r, head h:
//   s      = u_h(r) . L^T * scale + sb_h(r) (+ lm)   masked to -1e30
//   out[h] = sum_t softmax_eps(s)[t] * L[t]        (masked p = 0, sum>=1e-10)
//   out[H] = sum_t wd[r,t] * L[t]
// K1 computes u_h = M A_h + c_h in-kernel (A, c pre-scaled, no score bias:
// it cancels in the softmax), then the out-projection (Wvo), the aggregate
// (Wagg), the GRU with hidden state M, the (1 - dropout) scale and the
// LayerNorm; rows with no edge output LayerNorm(M).
//
// What bounds it on an H100. The TPU kernel held the whole table L in VMEM.
// Here L does not fit: T = bsz + halo rounded to 128 may reach 1024 rows,
// 256 KB in bf16 at D=128, more than the 227 KB a block may use. Per row
// the dense tile costs (2H+1)*T*D multiply-adds but only ~16 of the T
// columns are edges, and the kernel runs on the CUDA cores (no tensor
// cores yet), so this version is bound by f32 FMA issue rate, then by
// shared-memory loads; HBM traffic (L, wd, msg read once, output written
// once) is small beside it.
//
// Design (the same core serves K1 and K2):
// * A block owns a 16-row tile of one block-dense block (grid = row tiles x
//   blocks: thousands of blocks in flight on 132 SMs) and masks the ragged
//   end of B itself — the TPU wrapper asserted B % tile == 0 instead.
// * L streams through shared memory in 32-column chunks (any T works) with
//   an online softmax: a running max and sum per (head, row), the
//   accumulators rescaled by exp(m_old - m_new) when the max moves.
// * Scores: warp w owns (head,row) pairs w, w+8, ...; lane = table column,
//   so the chunk max and sum are warp shuffles and the running max/sum
//   live in registers of the owning warp.
// * Aggregation: each thread owns 4 feature columns of a few (head,row)
//   pairs, for the H heads plus the wd "head" in one loop over the chunk.
// * Masking keeps -1e30 as the fill and selects p = 0 on masked columns,
//   so a row without edges ends with sum 0 and never NaN.
// * bf16 compute rounds where the JAX reference rounds: L and u (K2 input,
//   K1 after M A_h + c_h) are bf16 values, p is rounded to bf16 before the
//   p.L product and wd is rounded to bf16 before wd.L; sums stay f32, and so
//   does all GRU/LayerNorm math. One difference is inherent to streaming:
//   p is rounded relative to the running max rather than the final max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;   // row tile
constexpr int kChunk = 32;  // local-table columns per streamed chunk (= warp width)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an f32 value to the compute type T (round to nearest even) and back
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Shared-memory plan of the attention core, in floats.
template <int D, int H>
struct Core {
  static constexpr int LD = D + 4;                  // padded L row: conflict-free float4
  static constexpr int NP = (H + 1) * kRows;        // weight rows: H heads, then wd
  static constexpr int QW = H * kRows / kWarps;     // score pairs per warp
  static constexpr int NCQ = D / 4;                 // float4 columns of a row
  static constexpr int NG = kThreads / NCQ;         // aggregation row groups
  static constexpr int PPT = (NP + NG - 1) / NG;    // aggregation pairs per thread
  static constexpr int kL = 0;
  static constexpr int kU = kL + kChunk * LD;       // queries [H][kRows][D], f32
  static constexpr int kP = kU + H * kRows * D;     // weights [NP][kChunk]
  static constexpr int kWd = kP + NP * kChunk;      // wd chunk [kRows][kChunk]
  static constexpr int kLm = kWd + kRows * kChunk;  // lm chunk [kRows][kChunk]
  static constexpr int kCorr = kLm + kRows * kChunk;  // rescale per weight row [NP]
  static constexpr int kSb = kCorr + NP;            // score bias [H][kRows]
  static constexpr int kLsum = kSb + H * kRows;     // final softmax sums [H][kRows]
  static constexpr int kFloats = kLsum + H * kRows;
  static_assert(D % 32 == 0 && kThreads % NCQ == 0, "unsupported width");
  static_assert((H * kRows) % kWarps == 0, "unsupported head count");
};

// Streams block k's local table through shared memory and leaves, per
// thread, the un-normalised aggregates acc[i][0..3] of weight rows
// p = g + NG*i (g = tid / NCQ, columns 4*(tid % NCQ)...+3), and the
// softmax sums of every (head,row) pair in sm[kLsum]. The caller has
// filled sm[kU] (queries, already rounded to T) and sm[kSb].
template <typename T, int D, int H>
__device__ __forceinline__ void attend(const T* __restrict__ Lk, int tlen,
                                       const float* __restrict__ wdk,
                                       const float* __restrict__ lmk, int nr,
                                       float scale, float* sm,
                                       float (&acc)[Core<D, H>::PPT][4]) {
  using C = Core<D, H>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cq = tid % C::NCQ, g = tid / C::NCQ;
  float* Ls = sm + C::kL;
  const float* U = sm + C::kU;
  float* P = sm + C::kP;
  float* WDc = sm + C::kWd;
  float* LMc = sm + C::kLm;
  float* CORR = sm + C::kCorr;
  const float* SB = sm + C::kSb;

  float mrun[C::QW], lrun[C::QW];
#pragma unroll
  for (int i = 0; i < C::QW; ++i) { mrun[i] = kNeg; lrun[i] = 0.f; }
#pragma unroll
  for (int i = 0; i < C::PPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (tid < kRows) CORR[H * kRows + tid] = 1.f;  // the wd rows never rescale

  for (int t0 = 0; t0 < tlen; t0 += kChunk) {
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int t = i / D, c = i % D;
      Ls[t * C::LD + c] = (t0 + t < tlen) ? to_f32(Lk[(size_t)(t0 + t) * D + c]) : 0.f;
    }
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, t = i % kChunk;
      const bool ok = r < nr && t0 + t < tlen;
      const size_t at = (size_t)r * tlen + t0 + t;
      const float w = ok ? wdk[at] : 0.f;
      WDc[i] = w;
      P[H * kRows * kChunk + i] = round_to<T>(w);
      if (lmk != nullptr) LMc[i] = ok ? lmk[at] : 0.f;
    }
    __syncthreads();

    // scores for this chunk: lane = column, warp owns pairs q = warp + kWarps*i
    float s[C::QW];
#pragma unroll
    for (int i = 0; i < C::QW; ++i) s[i] = 0.f;
    const float* lrow = Ls + lane * C::LD;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 b = *reinterpret_cast<const float4*>(lrow + c);
#pragma unroll
      for (int i = 0; i < C::QW; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(U + (warp + kWarps * i) * D + c);
        s[i] = fmaf(a.x, b.x, s[i]);
        s[i] = fmaf(a.y, b.y, s[i]);
        s[i] = fmaf(a.z, b.z, s[i]);
        s[i] = fmaf(a.w, b.w, s[i]);
      }
    }
    // online eps-guarded masked softmax
#pragma unroll
    for (int i = 0; i < C::QW; ++i) {
      const int q = warp + kWarps * i;
      const int r = q % kRows;
      const bool edge = WDc[r * kChunk + lane] > 0.f;
      float sc = s[i] * scale + SB[q];
      if (lmk != nullptr) sc += LMc[r * kChunk + lane];
      sc = edge ? sc : kNeg;
      const float mnew = fmaxf(mrun[i], warp_max(sc));
      const float corr = expf(mrun[i] - mnew);
      const float p = edge ? expf(sc - mnew) : 0.f;
      lrun[i] = lrun[i] * corr + warp_sum(p);
      mrun[i] = mnew;
      P[q * kChunk + lane] = round_to<T>(p);
      if (lane == 0) CORR[q] = corr;
    }
    __syncthreads();

    // aggregate: acc = acc * corr + sum_t P[p][t] * L[t]
#pragma unroll
    for (int i = 0; i < C::PPT; ++i) {
      const int p = g + C::NG * i;
      if (p < C::NP) {
        const float cr = CORR[p];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= cr;
      }
    }
#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) {
      const float4 lv = *reinterpret_cast<const float4*>(Ls + t * C::LD + cq * 4);
#pragma unroll
      for (int i = 0; i < C::PPT; ++i) {
        const int p = g + C::NG * i;
        if (p < C::NP) {
          const float pv = P[p * kChunk + t];
          acc[i][0] = fmaf(pv, lv.x, acc[i][0]);
          acc[i][1] = fmaf(pv, lv.y, acc[i][1]);
          acc[i][2] = fmaf(pv, lv.z, acc[i][2]);
          acc[i][3] = fmaf(pv, lv.w, acc[i][3]);
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < C::QW; ++i) sm[C::kLsum + warp + kWarps * i] = lrun[i];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K2: block_dense_attention
// ---------------------------------------------------------------------------

struct AttnArgs {
  const void* L;     // [nB, T, D] T-type
  const void* u;     // [H, nB, B, D] T-type
  const float* sb;   // [H, nB, B]
  const float* wd;   // [nB, B, T]
  const float* lm;   // [nB, B, T] or null
  float* out;        // [H+1, nB, B, D]
  int nb, b, t;
  float scale;
};

template <typename T, int D, int H>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const AttnArgs a) {
  using C = Core<D, H>;
  extern __shared__ __align__(16) float sm[];
  const int k = blockIdx.y, r0 = blockIdx.x * kRows;
  const int nr = min(kRows, a.b - r0);
  const int tid = threadIdx.x;
  const T* u = static_cast<const T*>(a.u);
  float* U = sm + C::kU;
  for (int i = tid; i < H * kRows * D; i += kThreads) {
    const int h = i / (kRows * D), r = (i / D) % kRows, c = i % D;
    U[i] = r < nr ? to_f32(u[(((size_t)h * a.nb + k) * a.b + r0 + r) * D + c]) : 0.f;
  }
  for (int i = tid; i < H * kRows; i += kThreads) {
    const int h = i / kRows, r = i % kRows;
    sm[C::kSb + i] = r < nr ? a.sb[((size_t)h * a.nb + k) * a.b + r0 + r] : 0.f;
  }
  float acc[C::PPT][4];
  const size_t rows0 = (size_t)k * a.b + r0;
  attend<T, D, H>(static_cast<const T*>(a.L) + (size_t)k * a.t * D, a.t,
                  a.wd + rows0 * a.t, a.lm ? a.lm + rows0 * a.t : nullptr, nr,
                  a.scale, sm, acc);
  const int cq = tid % C::NCQ, g = tid / C::NCQ;
#pragma unroll
  for (int i = 0; i < C::PPT; ++i) {
    const int p = g + C::NG * i;
    if (p >= C::NP) continue;
    const int h = p / kRows, r = p % kRows;
    if (r >= nr) continue;
    const float den = h < H ? fmaxf(sm[C::kLsum + p], 1e-10f) : 1.f;
    const float4 v = make_float4(acc[i][0] / den, acc[i][1] / den, acc[i][2] / den,
                                 acc[i][3] / den);
    float* dst = a.out + (((size_t)h * a.nb + k) * a.b + r0 + r) * D + cq * 4;
    *reinterpret_cast<float4*>(dst) = v;
  }
}

// ---------------------------------------------------------------------------
// K1: block_dense_layer_fused
// ---------------------------------------------------------------------------

struct FusedArgs {
  const void* L;     // [nB, T, D] T-type
  const void* msg;   // [nB, B, D] float32 or bf16 (msg_bf16)
  const float* wd;   // [nB, B, T]
  const float* lm;   // [nB, B, T] or null
  const float *A, *c, *Wvo, *bvo, *bout, *Wagg, *bagg;  // folded, float32
  const float *w3, *b3, *u2, *ub2, *uhk, *uhb, *gamma, *beta;
  void* out;         // [nB, B, D], dtype of msg
  int nb, b, t, msg_bf16;
  float dropout, eps;
};

// Y[r][n] = sum_k X[r][k] * W[k][n] (+ bias[n]) for all kRows rows.
// Columns spread over threads (coalesced W reads), 8 rows per task (X reads
// are warp broadcasts from shared memory).
__device__ __forceinline__ void tile_gemm(const float* X, int ldx,
                                          const float* __restrict__ W, int K, int N,
                                          const float* __restrict__ bias, float* Y,
                                          int ldy) {
  constexpr int RPT = 8;
  for (int task = threadIdx.x; task < N * (kRows / RPT); task += kThreads) {
    const int n = task % N, r0 = (task / N) * RPT;
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + (size_t)k * N + n);
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(X[(r0 + i) * ldx + k], w, acc[i]);
    }
    const float bv = bias != nullptr ? __ldg(bias + n) : 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) Y[(r0 + i) * ldy + n] = acc[i] + bv;
  }
}

template <int D, int H>
struct Fused {
  using C = Core<D, H>;
  static constexpr int RD = kRows * D;
  // persistent: M tile [kRows][D], has_any [kRows]; then a region shared by
  // the attention core and the epilogue
  static constexpr int kM = 0;
  static constexpr int kHas = kM + RD;
  static constexpr int kArena = kHas + kRows;
  // epilogue plan inside the arena: TV [kRows][H*D] + WM [kRows][D], later
  // overwritten by WX [kRows][3D] + UH [kRows][2D]; then X1/HT, AGG, RM
  static constexpr int kFront = (H + 1 > 5 ? H + 1 : 5) * RD;
  static constexpr int kTV = 0, kWM = H * RD, kWX = 0, kUH = 3 * RD;
  static constexpr int kX1 = kFront, kAGG = kFront + RD, kRM = kFront + 2 * RD;
  static constexpr int kEpi = kFront + 3 * RD;
  static constexpr int kFloats = kArena + (C::kFloats > kEpi ? C::kFloats : kEpi);
};

template <typename T, int D, int H>
__global__ void __launch_bounds__(kThreads)
fused_layer_kernel(const FusedArgs a) {
  using C = Core<D, H>;
  using F = Fused<D, H>;
  constexpr int RD = F::RD;
  extern __shared__ __align__(16) float smem[];
  const int k = blockIdx.y, r0 = blockIdx.x * kRows;
  const int nr = min(kRows, a.b - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ms = smem + F::kM;
  float* HAS = smem + F::kHas;
  float* sm = smem + F::kArena;
  const size_t rows0 = (size_t)k * a.b + r0;

  // message rows (GRU/LN math is f32 whatever the IO type)
  for (int i = tid; i < RD; i += kThreads) {
    const int r = i / D;
    float v = 0.f;
    if (r < nr) {
      const size_t at = rows0 * D + i;
      v = a.msg_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.msg)[at])
                     : static_cast<const float*>(a.msg)[at];
    }
    Ms[i] = v;
  }
  __syncthreads();
  // folded queries u_h = M A_h + c_h, rounded to the compute type
  float* U = sm + C::kU;
  for (int h = 0; h < H; ++h)
    tile_gemm(Ms, D, a.A + (size_t)h * D * D, D, D, a.c + h * D, U + h * RD, D);
  for (int i = tid; i < H * kRows; i += kThreads) sm[C::kSb + i] = 0.f;
  __syncthreads();
  for (int i = tid; i < H * RD; i += kThreads) U[i] = round_to<T>(U[i]);

  float acc[C::PPT][4];
  attend<T, D, H>(static_cast<const T*>(a.L) + (size_t)k * a.t * D, a.t,
                  a.wd + rows0 * a.t, a.lm ? a.lm + rows0 * a.t : nullptr, nr,
                  1.f, sm, acc);

  // softmax-normalised head values -> TV, weighted mean -> WM
  const int cq = tid % C::NCQ, g = tid / C::NCQ;
  float den[C::PPT];
#pragma unroll
  for (int i = 0; i < C::PPT; ++i) {
    const int p = g + C::NG * i;
    den[i] = p < H * kRows ? fmaxf(sm[C::kLsum + p], 1e-10f) : 1.f;
  }
  // a row has an edge iff its softmax sum is positive (the max column
  // contributes exp(0) = 1)
  if (tid < kRows) HAS[tid] = sm[C::kLsum + tid] > 0.f ? 1.f : 0.f;
  __syncthreads();
  float* TV = sm + F::kTV;
  float* WM = sm + F::kWM;
#pragma unroll
  for (int i = 0; i < C::PPT; ++i) {
    const int p = g + C::NG * i;
    if (p >= C::NP) continue;
    const int h = p / kRows, r = p % kRows;
    float* dst = h < H ? TV + r * (H * D) + h * D + cq * 4 : WM + r * D + cq * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = acc[i][j] / den[i];
  }
  __syncthreads();

  // aggregate input: sum_h tv_h Wvo_h + bout + has_any * bvo + wm
  float* X1 = sm + F::kX1;
  tile_gemm(TV, H * D, a.Wvo, H * D, D, nullptr, X1, D);
  __syncthreads();
  for (int i = tid; i < RD; i += kThreads) {
    const int r = i / D, c = i % D;
    X1[i] = X1[i] + __ldg(a.bout + c) + HAS[r] * __ldg(a.bvo + c) + WM[i];
  }
  __syncthreads();
  float* AGG = sm + F::kAGG;
  tile_gemm(X1, D, a.Wagg, D, D, a.bagg, AGG, D);
  __syncthreads();

  // GRU with hidden state M
  float* WX = sm + F::kWX;
  float* UH = sm + F::kUH;
  tile_gemm(AGG, D, a.w3, D, 3 * D, a.b3, WX, 3 * D);
  tile_gemm(Ms, D, a.u2, D, 2 * D, a.ub2, UH, 2 * D);
  __syncthreads();
  float* RM = sm + F::kRM;
  for (int i = tid; i < RD; i += kThreads) {
    const int r = i / D, c = i % D;
    RM[i] = sigmoidf(WX[r * 3 * D + D + c] + UH[r * 2 * D + D + c]) * Ms[i];
  }
  __syncthreads();
  float* HT = X1;  // X1 is dead
  tile_gemm(RM, D, a.uhk, D, D, a.uhb, HT, D);
  __syncthreads();

  // update, dropout scale, LayerNorm; rows without edges: LayerNorm(M)
  constexpr int V = D / 32;
  for (int r = warp; r < nr; r += kWarps) {
    const bool has = HAS[r] > 0.f;
    float v[V];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      const float m = Ms[r * D + c];
      if (has) {
        const float z = sigmoidf(WX[r * 3 * D + c] + UH[r * 2 * D + c]);
        const float ht = tanhf(WX[r * 3 * D + 2 * D + c] + HT[r * D + c]);
        v[j] = ((1.f - z) * m + z * ht) * (1.f - a.dropout);
      } else {
        v[j] = m;
      }
      sum += v[j];
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) sq += (v[j] - mean) * (v[j] - mean);
    const float inv = rsqrtf(warp_sum(sq) / D + a.eps);
    const size_t base = (rows0 + r) * D;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      const float o = (v[j] - mean) * inv * __ldg(a.gamma + c) + __ldg(a.beta + c);
      if (a.msg_bf16)
        static_cast<__nv_bfloat16*>(a.out)[base + c] = __float2bfloat16(o);
      else
        static_cast<float*>(a.out)[base + c] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// launch and dispatch over (compute type, D, H)
// ---------------------------------------------------------------------------

template <typename Kernel, typename Args>
int launch(Kernel kernel, size_t floats, const Args& args, int nb, int b,
           cudaStream_t stream) {
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + kRows - 1) / kRows, nb);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T, int D, int H>
int run_attention(const AttnArgs& a, cudaStream_t s) {
  return launch(attention_kernel<T, D, H>, Core<D, H>::kFloats, a, a.nb, a.b, s);
}

template <typename T, int D, int H>
int run_fused(const FusedArgs& a, cudaStream_t s) {
  return launch(fused_layer_kernel<T, D, H>, Fused<D, H>::kFloats, a, a.nb, a.b, s);
}

#define RVT_DISPATCH(NAME, ARGS)                                               \
  template <typename T>                                                        \
  int NAME##_d(const ARGS& a, int d, int h, cudaStream_t s) {                  \
    switch (d * 100 + h) {                                                     \
      case 3201: return run_##NAME<T, 32, 1>(a, s);                            \
      case 3202: return run_##NAME<T, 32, 2>(a, s);                            \
      case 3204: return run_##NAME<T, 32, 4>(a, s);                            \
      case 3208: return run_##NAME<T, 32, 8>(a, s);                            \
      case 6401: return run_##NAME<T, 64, 1>(a, s);                            \
      case 6402: return run_##NAME<T, 64, 2>(a, s);                            \
      case 6404: return run_##NAME<T, 64, 4>(a, s);                            \
      case 6408: return run_##NAME<T, 64, 8>(a, s);                            \
      case 12801: return run_##NAME<T, 128, 1>(a, s);                          \
      case 12802: return run_##NAME<T, 128, 2>(a, s);                          \
      case 12804: return run_##NAME<T, 128, 4>(a, s);                          \
      case 12808: return run_##NAME<T, 128, 8>(a, s);                          \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

RVT_DISPATCH(attention, AttnArgs)
RVT_DISPATCH(fused, FusedArgs)

}  // namespace

extern "C" int block_dense_attention(const void* L, const void* u, const void* sb,
                                     const void* wd, const void* lm, void* out,
                                     int nb, int b, int t, int d, int h,
                                     int bf16, float scale, void* stream) {
  AttnArgs a{L, u, static_cast<const float*>(sb), static_cast<const float*>(wd),
             static_cast<const float*>(lm), static_cast<float*>(out), nb, b, t, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? attention_d<__nv_bfloat16>(a, d, h, s) : attention_d<float>(a, d, h, s);
}

// folded: the 15 folded parameter pointers in fold_layer_params order
// (A, c, Wvo, bvo, bout, Wagg, bagg, w3, b3, u2, ub2, uhk, uhb, gamma, beta)
extern "C" int block_dense_layer_fused(const void* L, const void* msg, const void* wd,
                                       const void* lm, const void* const* folded,
                                       void* out, int nb, int b, int t, int d, int h,
                                       int bf16, int msg_bf16, float dropout,
                                       float eps, void* stream) {
  const float* const* f = reinterpret_cast<const float* const*>(folded);
  FusedArgs a{L, msg, static_cast<const float*>(wd), static_cast<const float*>(lm),
              f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
              f[11], f[12], f[13], f[14], out, nb, b, t, msg_bf16, dropout, eps};
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? fused_d<__nv_bfloat16>(a, d, h, s) : fused_d<float>(a, d, h, s);
}

extern "C" const char* rvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
