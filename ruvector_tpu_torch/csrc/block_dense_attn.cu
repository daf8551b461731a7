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
// What bounds K1 on an H100, at the main path's shape (nB = 214 blocks of
// B = 512 rows, T = 512, D = 128, H = 4): per row (2H+1) T D bf16
// multiply-adds over the dense tile (129 GFLOP a call) and (2H+7) D^2
// float32 ones in the epilogue (54 GFLOP), against ~0.36 GB of bytes (wd,
// 224 MB, the largest). At float32 grade on the tensor cores (3xTF32, 165
// TFLOP/s) the epilogue's operations bound it.
//
// Two bodies of K1 and of K2, one for each compute type (an explicit
// dispatch, not a fallback; ops/kernels/block_dense_attn.k1_body, k2_body):
//
// * tc_fused_kernel (K1, bf16 compute): every product on the tensor cores
//   with mma.sync (gated_tc.cuh). A CTA of 8 warps owns 128 rows of one
//   block, a warp a 16-row strip. The dense tile's products (u_h L^T, p L,
//   wd L) take bf16 operands with float32 sums on m16n8k16: L streams
//   through shared memory in 64-row chunks (cp.async, two buffers) shared
//   by the warps, the scores stay in registers and become the A operand of
//   p L (FlashAttention-2's online softmax, one pass per head: head_pass),
//   and wd is read once, coalesced, in a first pass (wd_pass) that also
//   keeps each chunk's edge bits (one word a lane) in a small global
//   scratch for the head passes. The epilogue's float32 products (M A_h,
//   tv_h Wvo_h, Wagg, w3, u2, uhk) run as 3xTF32 on m16n8k8 with float32
//   sums, the float32 grade the TPU kernel's f32 products have: the
//   weights go through shared memory in 32-row slabs shared by the warps,
//   the left operands are the warp's float32 strips in shared memory (M;
//   attn_out, then X1 and AGG; tv_h, then r M). Biases, sigmoid, tanh,
//   dropout and LayerNorm stay float32 on the CUDA cores.
// * tc_attention_kernel (K2, bf16 compute): K1's tile without its
//   epilogue, in K1's pass order: wd_pass writes out[H] = bf16(wd) L from
//   its accumulators, then one head_pass a head, on u_h loaded from global
//   memory straight into A fragments, writes out[h]. What bounds it: bytes
//   (wd 224 MB, out 280 MB float32, u 112 MB at the main path's shape:
//   0.19 ms), against 0.13 ms of bf16 tensor-core operations over the
//   whole dense tile. Its design, against the other one considered (a
//   CTA's warps split over the heads of the same strips): with 8 warps and
//   H = 4 a CTA would then own 32 rows, so the table would cross shared
//   memory once per 32 rows, about as often as here (H + 1 passes per 128
//   rows), and every head's warp would need the strip's edge bits a chunk
//   ahead; K1's passes serve as they are. Edge bits in K1's global scratch,
//   not in shared memory, so that any T runs (each lane reads back only the
//   words it wrote, L2-resident: wd's bytes / 32). Unlike K1 (whose code
//   generation stays as measured), a warp skips the products of a chunk
//   where its strip has no edge: on a graph-grown layout most strips reach
//   a few of the table's chunks. 32 KB of shared memory (two table
//   chunks) but 248 registers at D = 128 (ptxas), so one CTA of 8 warps an
//   SM. Outputs are stored from the m16n8 accumulators: a quad writes 8
//   contiguous floats of a row per tile, whole 32-byte sectors.
// * fused_layer_kernel (K1) and attention_kernel (K2), float32 compute:
//   the attention core below and, for K1, tile_gemm on the CUDA cores.
//   Single-pass TF32 would break the float32 tolerance of 1e-4.
//
// The float32 bodies (what bounds them, and the CUDA-core design).
// The TPU kernel held the whole table L in VMEM. Here L does not fit:
// T = bsz + halo rounded to 128 may reach 1024 rows, 256 KB in bf16 at
// D=128, more than the 227 KB a block may use. Per row the dense tile
// costs (2H+1)*T*D multiply-adds but only ~16 of the T columns are edges,
// and this core runs on the CUDA cores, so it is bound by f32 FMA issue
// rate, then by shared-memory loads; HBM traffic (L, wd, msg read once,
// output written once) is small beside it.
//
// Design of that core (it serves both float32 kernels):
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
//
// bf16 compute rounds where the JAX reference rounds: L and u (K2 input,
// K1 after M A_h + c_h) are bf16 values, p is rounded to bf16 before the
// p.L product and wd is rounded to bf16 before wd.L; sums stay f32, and so
// does all GRU/LayerNorm math. One difference is inherent to streaming: p
// is rounded relative to the running max rather than the final max.

#include "gated_tc.cuh"

namespace {

using namespace rvt;  // kThreads (256), kWarps, kNeg, warp_sum, warp_max, the tensor-core helpers

constexpr int kRows = 16;   // row tile
constexpr int kChunk = 32;  // local-table columns per streamed chunk (= warp width)

// The CUDA-core bodies run at float32 compute only (T = float): bf16
// compute takes the tensor-core bodies.
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

// round an f32 value to the compute type T and back
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// K1 on the tensor cores (bf16 compute): tc_fused_kernel
// ---------------------------------------------------------------------------

namespace k1tc {

constexpr int kStrip = 16;                 // rows of a warp's strip
constexpr int kCtaRows = kStrip * kWarps;  // rows of a block per CTA (128)
constexpr int kTab = 64;                   // table rows per streamed chunk
constexpr int kSlab = 32;                  // weight rows per staged slab

// Test-only faults, built at D = 128 only: kOneTf32 keeps only the hi*hi
// pass of every float32-grade product; kNoHead0 leaves head 0's tv_0 Wvo_0
// out of attn_out.
enum Variant { kExact = 0, kOneTf32 = 1, kNoHead0 = 2 };

// Shared memory, in floats: per warp three float32 strips [kStrip, D]
// (M; attn_out -> X1 -> AGG; tv_h -> r M), then a region that holds either
// two bf16 table chunks [kTab, D] or two float32 weight slabs [kSlab, D + 4].
template <int D>
struct Plan {
  static constexpr int kStripF = kStrip * D;
  static constexpr int kM = 0;
  static constexpr int kS = kM + kWarps * kStripF;
  static constexpr int kT = kS + kWarps * kStripF;
  static constexpr int kBuf = kT + kWarps * kStripF;
  static constexpr int kSlabF = kSlab * (D + 4);
  static constexpr int kBufF = 2 * kSlabF > kTab * D ? 2 * kSlabF : kTab * D;
  static constexpr size_t kBytes = (size_t)(kBuf + kBufF) * sizeof(float);
};

// Index of element (r, col) of a float32 strip [kStrip, D]: the 8-column
// groups of a row XOR-swizzled with the row, so that a warp's float2
// reads of an m16n8k8 A operand (rows g and g + 8, columns 2c, 2c + 1 of
// one k8 block) fall in 32 different banks.
template <int D>
__device__ __forceinline__ int fsw(int r, int col) {
  constexpr int kMask = (D / 8 < 8 ? D / 8 : 8) - 1;
  return r * D + ((((col >> 3) ^ (r & kMask))) << 3) + (col & 7);
}

// The accumulators of a strip (the m16n8 layout: tile n, lane 4g + c holds
// rows g and g + 8, columns 8n + 2c and 8n + 2c + 1) from or to a strip.
template <int D>
__device__ __forceinline__ void load_acc(float (&acc)[D / 8][4], const float* S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float2 v0 = *reinterpret_cast<const float2*>(S + fsw<D>(g, 8 * n + 2 * c));
    const float2 v1 = *reinterpret_cast<const float2*>(S + fsw<D>(g + 8, 8 * n + 2 * c));
    acc[n][0] = v0.x; acc[n][1] = v0.y; acc[n][2] = v1.x; acc[n][3] = v1.y;
  }
}

template <int D>
__device__ __forceinline__ void store_acc(float* S, const float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(S + fsw<D>(g, 8 * n + 2 * c)) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(S + fsw<D>(g + 8, 8 * n + 2 * c)) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// acc += bias at each accumulator's column
template <int D>
__device__ __forceinline__ void add_bias(float (&acc)[D / 8][4], const float* __restrict__ b) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(b + 8 * n + 2 * c));
    acc[n][0] += v.x; acc[n][1] += v.y; acc[n][2] += v.x; acc[n][3] += v.y;
  }
}

// The warp's message rows [nr of kStrip] as float32 into its strip (rows
// at or past nr become 0).
template <int D>
__device__ __forceinline__ void load_strip(float* S, const void* msg, int msg_bf16,
                                           size_t row0, int nr) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < kStrip * D / 4; i += 32) {
    const int r = i / (D / 4), col = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr) {
      const size_t at = (row0 + r) * D + col;
      if (msg_bf16) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(msg) + at);
        const float2 lo = __bfloat1622float2(p[0]), hi = __bfloat1622float2(p[1]);
        v = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        v = *reinterpret_cast<const float4*>(static_cast<const float*>(msg) + at);
      }
    }
    *reinterpret_cast<float4*>(S + fsw<D>(r, col)) = v;
  }
}

// Start copying rows [k0, k0 + kSlab) of W (row stride ldw floats, D
// columns) into a slab of row stride D + 4 (so that the B-operand reads
// of m16n8k8, rows 2c and 2c + 1 and columns g, fall in 32 banks).
template <int D>
__device__ __forceinline__ void stage_slab(float* dst, const float* __restrict__ W, int ldw,
                                           int k0) {
  for (int i = threadIdx.x; i < kSlab * (D / 4); i += kThreads) {
    const int r = i / (D / 4), col = (i % (D / 4)) * 4;
    cp_async16(dst + r * (D + 4) + col, W + (size_t)(k0 + r) * ldw + col);
  }
  cp_async_commit();
}

// acc += X W at float32 grade for the warp's strip X [kStrip, D] (float32,
// fsw layout) and W [D, D] (row stride ldw, global memory): 3xTF32 on
// mma.sync m16n8k8 (mma3_row; ONE keeps only the hi*hi pass, a fault). W
// goes through the two slabs of buf in turn, shared by the CTA's warps, so
// every thread calls it; it ends with a barrier.
template <int D, bool ONE>
__device__ void strip_product(float (&acc)[D / 8][4], const float* X,
                              const float* __restrict__ W, int ldw, float* buf) {
  constexpr int kLd = D + 4, kN = D / kSlab;
  static_assert(D % kSlab == 0, "the slabs tile K = D");
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  stage_slab<D>(buf, W, ldw, 0);
  for (int s = 0; s < kN; ++s) {
    if (s + 1 < kN) {
      stage_slab<D>(buf + ((s + 1) & 1) * Plan<D>::kSlabF, W, ldw, (s + 1) * kSlab);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab s visible
    const float* sl = buf + (s & 1) * Plan<D>::kSlabF;
#pragma unroll
    for (int j = 0; j < kSlab / 8; ++j) {
      const int k = s * kSlab + 8 * j + 2 * c;
      const float2 va = *reinterpret_cast<const float2*>(X + fsw<D>(g, k));
      const float2 vb = *reinterpret_cast<const float2*>(X + fsw<D>(g + 8, k));
      const Tf32A a = split_a(va.x, vb.x, va.y, vb.y);
      const float* b0 = sl + (8 * j + 2 * c) * kLd + g;
      mma3_row<D / 8, ONE>(acc, a,
                           [&](int nt) { return make_float2(b0[8 * nt], b0[kLd + 8 * nt]); });
    }
    __syncthreads();  // slab s is free for s + 2
  }
}

// Start copying table rows [t0, t0 + kTab) of Lk [T, D] (bf16) into dst
// (sw rows); rows at or past T become 0.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ Lk, int t0,
                                           int T) {
  for (int i = threadIdx.x; i < kTab * (D / 8); i += kThreads) {
    const int r = i / (D / 8), col = (i % (D / 8)) * 8;
    bf16* d = dst + sw<D>(r, col);
    if (t0 + r < T)
      cp_async16(d, Lk + (size_t)(t0 + r) * D + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

// body(ch, chunk) for the table's chunks of kTab rows, staged in turn into
// the two halves of buf while the other half is read. Every thread calls
// it (it holds barriers); it ends with a barrier.
template <int D, typename F>
__device__ __forceinline__ void table_loop(bf16* buf, const bf16* Lk, int T, F body) {
  const int n = (T + kTab - 1) / kTab;
  stage_rows<D>(buf, Lk, 0, T);
  for (int ch = 0; ch < n; ++ch) {
    if (ch + 1 < n) {
      stage_rows<D>(buf + ((ch + 1) & 1) * kTab * D, Lk, (ch + 1) * kTab, T);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch visible
    body(ch, static_cast<const bf16*>(buf + (ch & 1) * kTab * D));
    __syncthreads();  // its half is free for chunk ch + 2
  }
}

// Loads of wd or lm: STREAM marks the lines first to leave L2 (wd is read
// once), else they go through the read-only cache.
template <bool STREAM>
__device__ __forceinline__ float ld1(const float* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return __ldg(p);
}

template <bool STREAM>
__device__ __forceinline__ float2 ld2(const float* p) {
  if constexpr (STREAM) return __ldcs(reinterpret_cast<const float2*>(p));
  else return __ldg(reinterpret_cast<const float2*>(p));
}

// v[n][e] = the thread's values of a [B, T] float32 array (wd or lm) at
// its score positions of the table chunk at t0: tile n, rows g (e = 0, 1)
// and g + 8 (e = 2, 3) of the strip, columns t0 + 8n + 2c + (e & 1). p0,
// p1: the two rows (null past B); columns past T read as 0. STREAM reads
// around L1 and marks the lines first to leave L2 (wd is read once).
template <bool STREAM>
__device__ __forceinline__ void load_at_scores(float (&v)[8][4], const float* p0, const float* p1,
                                               int t0, int T) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = t0 + 8 * n + 2 * c;
    float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
    if ((T & 1) == 0) {  // rows start 8-byte aligned
      if (col < T) {
        if (p0 != nullptr) a = ld2<STREAM>(p0 + col);
        if (p1 != nullptr) b = ld2<STREAM>(p1 + col);
      }
    } else {
      if (p0 != nullptr) {
        if (col < T) a.x = ld1<STREAM>(p0 + col);
        if (col + 1 < T) a.y = ld1<STREAM>(p0 + col + 1);
      }
      if (p1 != nullptr) {
        if (col < T) b.x = ld1<STREAM>(p1 + col);
        if (col + 1 < T) b.y = ld1<STREAM>(p1 + col + 1);
      }
    }
    v[n][0] = a.x; v[n][1] = a.y; v[n][2] = b.x; v[n][3] = b.y;
  }
}

// s = u L[0:64]^T for a strip and a table chunk in shared memory: eight
// 16x8 tiles of scores (score_chunk, gated_tc.cuh, over 64 columns)
template <int D>
__device__ __forceinline__ void scores64(float (&s)[8][4], const uint32_t (&u)[D / 16][4],
                                         const bf16* Lc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t bb[4];
      ldsm_x4(bb, Lc + sw<D>(16 * q + (lane & 7) + ((lane >> 4) << 3),
                             kk * 16 + (((lane >> 3) & 1) << 3)));
      mma16816(s[2 * q], u[kk], bb[0], bb[1]);
      mma16816(s[2 * q + 1], u[kk], bb[2], bb[3]);
    }
  }
}

// Scores of 8 tiles (64 columns) as the A operand of their product with
// the chunk (4 k16 fragments), rounded to bf16.
__device__ __forceinline__ void chunk_frags(uint32_t (&f)[4][4], const float (&v)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(v[2 * kk][0], v[2 * kk][1]);
    f[kk][1] = pack_bf16(v[2 * kk][2], v[2 * kk][3]);
    f[kk][2] = pack_bf16(v[2 * kk + 1][0], v[2 * kk + 1][1]);
    f[kk][3] = pack_bf16(v[2 * kk + 1][2], v[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ bool quad_any(bool v) {
  int x = v;
  x |= __shfl_xor_sync(0xffffffffu, x, 1);
  x |= __shfl_xor_sync(0xffffffffu, x, 2);
  return x != 0;
}

// The wd pass of a warp's strip (rows g and g + 8 of the thread: w0, w1,
// null past B): acc = bf16(wd) L over the whole table, each chunk's edge
// bits stored at bits[ch * 32] (one word a lane: bit 4n + e of the
// thread's score positions, load_at_scores), has0 and has1 whether the
// thread's columns of rows g and g + 8 hold an edge. wd is read once,
// streamed, a chunk ahead. SKIP: a warp leaves out the products of a chunk
// where its strip has no edge (they add 0). Every thread calls it
// (table_loop).
template <int D, bool SKIP = false>
__device__ __forceinline__ void wd_pass(float (&acc)[D / 8][4], bool& has0, bool& has1,
                                        const float* w0, const float* w1, bf16* tbuf,
                                        const bf16* Lk, int T, uint32_t* bits) {
  const int nch = (T + kTab - 1) / kTab;
  zero<D>(acc);
  has0 = false;
  has1 = false;
  float w[8][4];
  load_at_scores<true>(w, w0, w1, 0, T);
  table_loop<D>(tbuf, Lk, T, [&](int ch, const bf16* Lc) {
    uint32_t f[4][4], word = 0u;
    chunk_frags(f, w);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) word |= (w[n][e] > 0.f ? 1u : 0u) << (4 * n + e);
    bits[ch * 32] = word;
    has0 |= (word & 0x33333333u) != 0u;  // e = 0, 1: row g
    has1 |= (word & 0xccccccccu) != 0u;  // e = 2, 3: row g + 8
    if (ch + 1 < nch) load_at_scores<true>(w, w0, w1, (ch + 1) * kTab, T);
    if (SKIP && !__any_sync(0xffffffffu, word != 0u)) return;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_row_k16<D>(acc, f[kk], Lc, 16 * kk);
  });
}

// One head's pass over the table for a warp's strip (FlashAttention-2's
// online softmax): the scores s = prep(u L^T) (+ lm where with_lm; lm0,
// lm1 the thread's rows of lm, null past B), masked to -1e30 by the edge
// bits of wd_pass, and acc = sum_t p_t L_t / max(sum_t p_t, 1e-10), with
// p = exp(s - running max) rounded to bf16 as the A operand of p L; a row
// without an edge gives 0. RESCALE = false leaves the correction exp(m_old
// - m_new) out of acc and the sums (a test-only fault). SKIP: a warp
// leaves out a chunk where its strip has no edge (its scores are all
// masked: the running max, the sums and acc stay as they are). Every
// thread calls it (table_loop).
template <int D, bool RESCALE, bool SKIP, typename Prep>
__device__ __forceinline__ void head_pass(float (&acc)[D / 8][4], const uint32_t (&uf)[D / 16][4],
                                          const float* lm0, const float* lm1, bool with_lm,
                                          bf16* tbuf, const bf16* Lk, int T,
                                          const uint32_t* bits, Prep prep) {
  constexpr int NT = D / 8;
  zero<D>(acc);
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  table_loop<D>(tbuf, Lk, T, [&](int ch, const bf16* Lc) {
    const uint32_t word = bits[ch * 32];
    if (SKIP && !__any_sync(0xffffffffu, word != 0u)) return;
    float s[8][4];
    scores64<D>(s, uf, Lc);
    prep(s);
    if (with_lm) {
      float lv[8][4];
      load_at_scores<false>(lv, lm0, lm1, ch * kTab, T);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += lv[n][e];
    }
    float x0 = kNeg, x1 = kNeg;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((word >> (4 * n + e)) & 1u)) s[n][e] = kNeg;
        if (e < 2) x0 = fmaxf(x0, s[n][e]);
        else x1 = fmaxf(x1, s[n][e]);
      }
    const float mn0 = fmaxf(m0, quad_max(x0)), mn1 = fmaxf(m1, quad_max(x1));
    const float cr0 = RESCALE ? __expf(m0 - mn0) : 1.f;
    const float cr1 = RESCALE ? __expf(m1 - mn1) : 1.f;
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool edge = (word >> (4 * n + e)) & 1u;
        const float p = edge ? __expf(s[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        s[n][e] = p;
        if (e < 2) ps0 += p;
        else ps1 += p;
      }
    l0 = l0 * cr0 + ps0;  // per-lane partial sums: the quad's corrections agree
    l1 = l1 * cr1 + ps1;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[t][0] *= cr0; acc[t][1] *= cr0; acc[t][2] *= cr1; acc[t][3] *= cr1;
    }
    uint32_t f[4][4];
    chunk_frags(f, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_row_k16<D>(acc, f[kk], Lc, 16 * kk);
  });
  const float d0 = fmaxf(quad_sum(l0), 1e-10f), d1 = fmaxf(quad_sum(l1), 1e-10f);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    acc[t][0] /= d0; acc[t][1] /= d0; acc[t][2] /= d1; acc[t][3] /= d1;
  }
}

// bits: the edge-bit scratch [nB, row CTAs, kWarps, T chunks, 32 lanes]
// (one word a lane and chunk: bit 4n + e of the thread's score positions,
// load_at_scores), written by the wd pass and read by the head passes.
template <int D, int V>
__global__ void __launch_bounds__(kThreads, 1)
tc_fused_kernel(const FusedArgs a, uint32_t* __restrict__ bits_all, int heads) {
  using P = Plan<D>;
  constexpr int NT = D / 8;
  constexpr bool ONE = V == kOneTf32;
  extern __shared__ __align__(16) float smem[];
  const int k = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int B = a.b, T = a.t;
  const int r0 = blockIdx.x * kCtaRows + warp * kStrip;  // the strip's first row in block k
  const size_t row0 = (size_t)k * B + r0;
  const bool ok0 = r0 + g < B, ok1 = r0 + g + 8 < B;
  float* MS = smem + P::kM + warp * P::kStripF;
  float* SS = smem + P::kS + warp * P::kStripF;
  float* TS = smem + P::kT + warp * P::kStripF;
  float* wbuf = smem + P::kBuf;
  bf16* tbuf = reinterpret_cast<bf16*>(smem + P::kBuf);
  const bf16* Lk = static_cast<const bf16*>(a.L) + (size_t)k * T * D;
  const int nch = (T + kTab - 1) / kTab;
  uint32_t* bits = bits_all + (((size_t)k * gridDim.x + blockIdx.x) * kWarps + warp) * nch * 32 +
                   lane;

  load_strip<D>(MS, a.msg, a.msg_bf16, row0, B - r0);

  // pass over the table with wd: wm = bf16(wd) L, the edge bits, has_any
  float acc[NT][4];
  bool has0, has1;
  wd_pass<D>(acc, has0, has1, ok0 ? a.wd + (row0 + g) * T : nullptr,
             ok1 ? a.wd + (row0 + g + 8) * T : nullptr, tbuf, Lk, T, bits);
  has0 = quad_any(has0);
  has1 = quad_any(has1);
  // attn_out starts as wm + bout + has_any bvo
  {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 bo = __ldg(reinterpret_cast<const float2*>(a.bout + 8 * n + 2 * c));
      const float2 bv = __ldg(reinterpret_cast<const float2*>(a.bvo + 8 * n + 2 * c));
      acc[n][0] += bo.x + (has0 ? bv.x : 0.f);
      acc[n][1] += bo.y + (has0 ? bv.y : 0.f);
      acc[n][2] += bo.x + (has1 ? bv.x : 0.f);
      acc[n][3] += bo.y + (has1 ? bv.y : 0.f);
    }
    store_acc<D>(SS, acc);
  }

  const float* lm0 = a.lm != nullptr && ok0 ? a.lm + (row0 + g) * T : nullptr;
  const float* lm1 = a.lm != nullptr && ok1 ? a.lm + (row0 + g + 8) * T : nullptr;
  for (int h = 0; h < heads; ++h) {
    // u_h = M A_h + c_h, rounded to bf16 as the scores' A operand
    zero<D>(acc);
    strip_product<D, ONE>(acc, MS, a.A + (size_t)h * D * D, D, wbuf);
    add_bias<D>(acc, a.c + h * D);
    uint32_t uf[D / 16][4];
    to_frags<D>(uf, acc);
    // one pass over the table: online softmax, acc = sum p L / sum p
    head_pass<D, true, false>(acc, uf, lm0, lm1, a.lm != nullptr, tbuf, Lk, T, bits,
                              [](float (&)[8][4]) {});
    // attn_out += tv_h Wvo_h
    if (V == kNoHead0 && h == 0) continue;
    store_acc<D>(TS, acc);
    load_acc<D>(acc, SS);
    strip_product<D, ONE>(acc, TS, a.Wvo + (size_t)h * D * D, D, wbuf);
    store_acc<D>(SS, acc);
  }

  // aggregate, then the GRU with hidden state M
  zero<D>(acc);
  strip_product<D, ONE>(acc, SS, a.Wagg, D, wbuf);
  add_bias<D>(acc, a.bagg);
  store_acc<D>(SS, acc);  // AGG (every lane's reads of X1 ended at the product's barrier)
  float hh[NT][4];        // AGG w3_h + b3_h + uhb, later + (r M) uhk
  zero<D>(hh);
  strip_product<D, ONE>(hh, SS, a.w3 + 2 * D, 3 * D, wbuf);
  add_bias<D>(hh, a.b3 + 2 * D);
  add_bias<D>(hh, a.uhb);
  zero<D>(acc);
  strip_product<D, ONE>(acc, SS, a.w3 + D, 3 * D, wbuf);
  strip_product<D, ONE>(acc, MS, a.u2 + D, 2 * D, wbuf);
  add_bias<D>(acc, a.b3 + D);
  add_bias<D>(acc, a.ub2 + D);
#pragma unroll
  for (int n = 0; n < NT; ++n) {  // r M into TS
    const float2 ma = *reinterpret_cast<const float2*>(MS + fsw<D>(g, 8 * n + 2 * c));
    const float2 mb = *reinterpret_cast<const float2*>(MS + fsw<D>(g + 8, 8 * n + 2 * c));
    acc[n][0] = sigmoidf(acc[n][0]) * ma.x;
    acc[n][1] = sigmoidf(acc[n][1]) * ma.y;
    acc[n][2] = sigmoidf(acc[n][2]) * mb.x;
    acc[n][3] = sigmoidf(acc[n][3]) * mb.y;
  }
  store_acc<D>(TS, acc);
  strip_product<D, ONE>(hh, TS, a.uhk, D, wbuf);
  zero<D>(acc);
  strip_product<D, ONE>(acc, SS, a.w3, 3 * D, wbuf);
  strip_product<D, ONE>(acc, MS, a.u2, 2 * D, wbuf);
  add_bias<D>(acc, a.b3);
  add_bias<D>(acc, a.ub2);

  // update, dropout scale, LayerNorm; rows without edges: LayerNorm(M)
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 ma = *reinterpret_cast<const float2*>(MS + fsw<D>(g, 8 * n + 2 * c));
    const float2 mb = *reinterpret_cast<const float2*>(MS + fsw<D>(g + 8, 8 * n + 2 * c));
    const float m[4] = {ma.x, ma.y, mb.x, mb.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float z = sigmoidf(acc[n][e]);
      const float ht = tanhf(hh[n][e]);
      const bool has = e < 2 ? has0 : has1;
      acc[n][e] = has ? ((1.f - z) * m[e] + z * ht) * (1.f - a.dropout) : m[e];
    }
    sum0 += acc[n][0] + acc[n][1];
    sum1 += acc[n][2] + acc[n][3];
  }
  const float mean0 = quad_sum(sum0) / D, mean1 = quad_sum(sum1) / D;
  float sq0 = 0.f, sq1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    sq0 += (acc[n][0] - mean0) * (acc[n][0] - mean0) + (acc[n][1] - mean0) * (acc[n][1] - mean0);
    sq1 += (acc[n][2] - mean1) * (acc[n][2] - mean1) + (acc[n][3] - mean1) * (acc[n][3] - mean1);
  }
  const float inv0 = rsqrtf(quad_sum(sq0) / D + a.eps), inv1 = rsqrtf(quad_sum(sq1) / D + a.eps);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * c;
    const float2 gm = __ldg(reinterpret_cast<const float2*>(a.gamma + col));
    const float2 bt = __ldg(reinterpret_cast<const float2*>(a.beta + col));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!(hf == 0 ? ok0 : ok1)) continue;
      const float mean = hf == 0 ? mean0 : mean1, inv = hf == 0 ? inv0 : inv1;
      const float o0 = (acc[n][2 * hf] - mean) * inv * gm.x + bt.x;
      const float o1 = (acc[n][2 * hf + 1] - mean) * inv * gm.y + bt.y;
      const size_t at = (row0 + g + 8 * hf) * D + col;
      if (a.msg_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + at) =
            __floats2bfloat162_rn(o0, o1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) = make_float2(o0, o1);
    }
  }
}

template <int D, int V>
int run_tc(const FusedArgs& a, uint32_t* bits, int heads, cudaStream_t s) {
  auto kernel = tc_fused_kernel<D, V>;
  const size_t smem = Plan<D>::kBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.b + kCtaRows - 1) / kCtaRows, a.nb);
  kernel<<<grid, kThreads, smem, s>>>(a, bits, heads);
  return (int)cudaGetLastError();
}

int run_tc_dispatch(const FusedArgs& a, uint32_t* bits, int d, int heads, int variant,
                    cudaStream_t s) {
  if (variant == kOneTf32) return run_tc<128, kOneTf32>(a, bits, heads, s);
  if (variant == kNoHead0) return run_tc<128, kNoHead0>(a, bits, heads, s);
  if (d == 128) return run_tc<128, kExact>(a, bits, heads, s);
  if (d == 64) return run_tc<64, kExact>(a, bits, heads, s);
  return run_tc<32, kExact>(a, bits, heads, s);
}


// ---------------------------------------------------------------------------
// K2 on the tensor cores (bf16 compute): tc_attention_kernel
// ---------------------------------------------------------------------------

// Test-only fault, built at D = 128 only: the online softmax's correction
// exp(m_old - m_new) left out of acc and the sums.
enum AttnVariant { kAttnExact = 0, kNoRescale = 1 };

// The thread's A fragments (D/16 of m16k16) of rows g and g + 8 of a bf16
// strip [kStrip, D] in global memory (row stride D), straight from 32-bit
// loads; rows past B (ok0, ok1 false) are 0.
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&f)[D / 16][4], const bf16* __restrict__ S,
                                           bool ok0, bool ok1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(S + g * D + 2 * c);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(S + (g + 8) * D + 2 * c);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = ok0 ? __ldg(r0 + 8 * kk) : 0u;
    f[kk][1] = ok1 ? __ldg(r1 + 8 * kk) : 0u;
    f[kk][2] = ok0 ? __ldg(r0 + 8 * kk + 4) : 0u;
    f[kk][3] = ok1 ? __ldg(r1 + 8 * kk + 4) : 0u;
  }
}

// The strip's accumulators (the m16n8 layout) to rows g and g + 8 of a
// float32 [kStrip, D] strip in global memory (rows past B skipped): a
// quad writes the 8 contiguous floats of a row per tile, whole sectors.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ S, const float (&acc)[D / 8][4],
                                           bool ok0, bool ok1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * c;
    if (ok0) __stcs(reinterpret_cast<float2*>(S + g * D + col), make_float2(acc[n][0], acc[n][1]));
    if (ok1)
      __stcs(reinterpret_cast<float2*>(S + (g + 8) * D + col), make_float2(acc[n][2], acc[n][3]));
  }
}

// bits: the edge-bit scratch, as tc_fused_kernel's. K1's pass order: the
// wd pass writes out[H] and the edge bits, then one pass a head over the
// table writes out[h].
template <int D, int V>
__global__ void __launch_bounds__(kThreads, 1)
tc_attention_kernel(const AttnArgs a, uint32_t* __restrict__ bits_all, int heads) {
  const int k = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int B = a.b, T = a.t;
  const int r0 = blockIdx.x * kCtaRows + warp * kStrip;  // the strip's first row in block k
  const size_t row0 = (size_t)k * B + r0;
  const size_t plane = (size_t)a.nb * B;  // rows of one head's plane of u, sb and out
  const bool ok0 = r0 + g < B, ok1 = r0 + g + 8 < B;
  extern __shared__ __align__(16) float smem[];
  bf16* tbuf = reinterpret_cast<bf16*>(smem);
  const bf16* Lk = static_cast<const bf16*>(a.L) + (size_t)k * T * D;
  const int nch = (T + kTab - 1) / kTab;
  uint32_t* bits = bits_all + (((size_t)k * gridDim.x + blockIdx.x) * kWarps + warp) * nch * 32 +
                   lane;

  float acc[D / 8][4];
  bool has0, has1;  // unused here
  wd_pass<D, true>(acc, has0, has1, ok0 ? a.wd + (row0 + g) * T : nullptr,
                   ok1 ? a.wd + (row0 + g + 8) * T : nullptr, tbuf, Lk, T, bits);
  store_rows<D>(a.out + ((size_t)heads * plane + row0) * D, acc, ok0, ok1);

  const float* lm0 = a.lm != nullptr && ok0 ? a.lm + (row0 + g) * T : nullptr;
  const float* lm1 = a.lm != nullptr && ok1 ? a.lm + (row0 + g + 8) * T : nullptr;
  const float scale = a.scale;
  for (int h = 0; h < heads; ++h) {
    const size_t hrow = h * plane + row0;
    uint32_t uf[D / 16][4];
    load_frags<D>(uf, static_cast<const bf16*>(a.u) + hrow * D, ok0, ok1);
    const float sb0 = ok0 ? __ldg(a.sb + hrow + g) : 0.f;
    const float sb1 = ok1 ? __ldg(a.sb + hrow + g + 8) : 0.f;
    const auto prep = [&](float (&s)[8][4]) {  // s * scale + sb_h(row)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = s[n][0] * scale + sb0;
        s[n][1] = s[n][1] * scale + sb0;
        s[n][2] = s[n][2] * scale + sb1;
        s[n][3] = s[n][3] * scale + sb1;
      }
    };
    head_pass<D, V != kNoRescale, true>(acc, uf, lm0, lm1, a.lm != nullptr, tbuf, Lk, T, bits,
                                        prep);
    store_rows<D>(a.out + hrow * D, acc, ok0, ok1);
  }
}

template <int D, int V>
int run_tc_attention(const AttnArgs& a, uint32_t* bits, int heads, cudaStream_t s) {
  auto kernel = tc_attention_kernel<D, V>;
  const size_t smem = (size_t)2 * kTab * D * sizeof(bf16);  // the two table chunks
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.b + kCtaRows - 1) / kCtaRows, a.nb);
  kernel<<<grid, kThreads, smem, s>>>(a, bits, heads);
  return (int)cudaGetLastError();
}

int run_tc_attention_dispatch(const AttnArgs& a, uint32_t* bits, int d, int heads, int variant,
                              cudaStream_t s) {
  if (variant == kNoRescale) return run_tc_attention<128, kNoRescale>(a, bits, heads, s);
  if (d == 128) return run_tc_attention<128, kAttnExact>(a, bits, heads, s);
  if (d == 64) return run_tc_attention<64, kAttnExact>(a, bits, heads, s);
  return run_tc_attention<32, kAttnExact>(a, bits, heads, s);
}

}  // namespace k1tc

}  // namespace

// bf16 compute runs tc_attention_kernel with `bits` its edge-bit scratch
// (block_dense_edge_bits_words); variant 1 (D = 128 and h = 4 only) is its
// test-only fault. float32 compute runs attention_kernel.
extern "C" int block_dense_attention(const void* L, const void* u, const void* sb,
                                     const void* wd, const void* lm, void* out, void* bits,
                                     int nb, int b, int t, int d, int h, int bf16,
                                     int variant, float scale, void* stream) {
  AttnArgs a{L, u, static_cast<const float*>(sb), static_cast<const float*>(wd),
             static_cast<const float*>(lm), static_cast<float*>(out), nb, b, t, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!rvt::width_ok(d) || h < 1 || h > 8 || bits == nullptr)
      return (int)cudaErrorInvalidValue;
    if (variant != 0 && !(variant == 1 && d == 128 && h == 4)) return (int)cudaErrorInvalidValue;
    return k1tc::run_tc_attention_dispatch(a, static_cast<uint32_t*>(bits), d, h, variant, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return attention_d<float>(a, d, h, s);
}

// folded: the 15 folded parameter pointers in fold_layer_params order
// (A, c, Wvo, bvo, bout, Wagg, bagg, w3, b3, u2, ub2, uhk, uhb, gamma, beta).
// bf16 compute runs tc_fused_kernel with `bits` its edge-bit scratch
// (block_dense_edge_bits_words); variant 1 or 2 (D = 128 and h = 4
// only) are its test-only faults. float32 compute runs fused_layer_kernel.
extern "C" int block_dense_layer_fused(const void* L, const void* msg, const void* wd,
                                       const void* lm, const void* const* folded,
                                       void* out, void* bits, int nb, int b, int t, int d,
                                       int h, int bf16, int msg_bf16, int variant,
                                       float dropout, float eps, void* stream) {
  const float* const* f = reinterpret_cast<const float* const*>(folded);
  FusedArgs a{L, msg, static_cast<const float*>(wd), static_cast<const float*>(lm),
              f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
              f[11], f[12], f[13], f[14], out, nb, b, t, msg_bf16, dropout, eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!rvt::width_ok(d) || h < 1 || h > 8 || bits == nullptr)
      return (int)cudaErrorInvalidValue;
    if (variant != 0 && !(variant <= 2 && d == 128 && h == 4)) return (int)cudaErrorInvalidValue;
    return k1tc::run_tc_dispatch(a, static_cast<uint32_t*>(bits), d, h, variant, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return fused_d<float>(a, d, h, s);
}

// Words of the edge-bit scratch of tc_fused_kernel and tc_attention_kernel:
// one per lane, warp, row CTA and table chunk of every block (-1 past the
// range of an int).
extern "C" int block_dense_edge_bits_words(int nb, int b, int t) {
  const long long ctas = (b + k1tc::kCtaRows - 1) / k1tc::kCtaRows;
  const long long chunks = (t + k1tc::kTab - 1) / k1tc::kTab;
  const long long words = (long long)nb * ctas * rvt::kWarps * chunks * 32;
  return words <= 0x7fffffffLL ? (int)words : -1;
}
