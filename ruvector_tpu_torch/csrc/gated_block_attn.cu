// The gate-signature reductions, one kernel body with three variants:
//   K6c (LN_X): h = LN1(x) (eps 1e-5), s = (h A_sig) h^T;
//   K6b (X):    s = (x A_sig) x^T, no LayerNorm;
//   K6a (QK):   s = q k^T * scale from projected q and k;
// and per row the sum and count of s > eps over valid pairs.
//
// Replaces ruvector_tpu/ops/pallas/gated_block_attn.py:487
// block_gate_signature_ln_x (kernel :459-483), :423 block_gate_signature_x
// (kernel :399-419) and :362 block_gate_signature (kernel :340-358). The
// gated graph transformer reduces (rsum, rcnt) to the per-partition
// signature sum(rsum) / max(sum(rcnt), 1) that drives temporal gate reuse:
// K6c on the halo-free kernel route, K6b where B % 32 != 0, K6a nowhere
// (the JAX package defines its caller but never calls it).
//
// What bounds it on an H100: reading x once (0.51 GB at 1M nodes, 128-d
// float32, 0.16 ms) and 2 B D (B + D) products per partition (0.1 TFLOP
// at 1M nodes; K6a 2 B B D). The products must be exact and their sums
// float64, so that the counts match the plain versions' bit for bit;
// bf16 tensor cores with float32 sums cannot give those bits, so the
// operations bound it at the float64 tensor cores' 67 TFLOP/s (1.47 ms
// at config 5's shape).
//
// Design: a persistent grid, one block of 256 threads per partition at a
// time. At bf16 compute and B <= 256 (tc_signature_kernel) the partition
// stays on chip: LN(x) (K6c) or x (K6b) as bf16 rows beside A_sig^T and Q
// in shared memory, or, for K6a, bf16 q and k rows (q is Q already, so the
// Q pass is skipped); the products on the float64 tensor cores
// (gated_f64tc.cuh), the row sums taken from the registers. K6a's bf16
// products are exact in float64 and its sums of D <= 128 terms exact, so
// its counts equal the plain version's as K6c's do. The other cases (float32
// compute, B > 256) run block_gemm with float64 FMA on the CUDA cores
// and keep the block's [B, D] normalized rows, [B, D] projected rows and
// [B, B] logits in its slice of a global scratch buffer. Each row's
// reduction has a fixed order, so runs repeat bit for bit. block_gemm's
// gate_signature is also the epilogue of the fused layer with signature
// (gated_block_layer.cu): its float64 sums are exact, so it and the
// tensor-core body give the same bits.

#include "gated_f64tc.cuh"

namespace {

using namespace rvt;

enum SigMode { kLnX = 0, kX = 1, kQK = 2 };

struct SigArgs {
  const void* x;       // [nB, B, D] float32 or bf16 (q for K6a)
  const void* k;       // [nB, B, D] like x (K6a), else null
  const float* pad;    // [nB, B]
  const float* A_sig;  // [D, D] (K6c, K6b)
  const float* gamma;  // [D] (K6c)
  const float* beta;   // [D] (K6c)
  float* rsum;         // [nB, B]
  float* rcnt;         // [nB, B]
  float* scratch;      // grid x (2 B D + B B)
  int nb, b, d;
  float eps, scale;
};

template <int MODE, typename XT, bool BF16>
__global__ void __launch_bounds__(kThreads) signature_kernel(const SigArgs a) {
  __shared__ GemmSmem gs;
  __shared__ float pad[kMaxB];
  const int b = a.b, d = a.d;
  float* Hn = a.scratch + (size_t)blockIdx.x * (2 * b * d + b * b);
  float* Q = Hn + (size_t)b * d;
  float* S = Q + (size_t)b * d;
  for (int k = blockIdx.x; k < a.nb; k += gridDim.x) {
    __syncthreads();  // the previous partition's pad is no longer read
    for (int i = threadIdx.x; i < b; i += kThreads) pad[i] = a.pad[(size_t)k * b + i];
    __syncthreads();
    const XT* xk = static_cast<const XT*>(a.x) + (size_t)k * b * d;
    float* rsum = a.rsum + (size_t)k * b;
    float* rcnt = a.rcnt + (size_t)k * b;
    if constexpr (MODE == kLnX) {
      gate_signature<BF16>(xk, pad, a.A_sig, a.gamma, a.beta, a.eps, b, d, Hn, Q, S, gs, rsum,
                           rcnt);
    } else {
      if constexpr (MODE == kX) {
        logits_of_rows<BF16>(xk, a.A_sig, b, d, Q, S, gs);
      } else {
        // q and k are used as given (no compute-type rounding), as the
        // TPU kernel takes them; the float64 sum is rounded, then scaled
        const float scale = a.scale;
        block_gemm<false, true, double>(xk, d, static_cast<const XT*>(a.k) + (size_t)k * b * d,
                                        d, b, b, d, gs, [&](int m, int n, float v) {
                                          S[(size_t)m * b + n] = v * scale;
                                        });
      }
      positive_row_sums(S, pad, a.eps, b, rsum, rcnt);
    }
  }
}

// x rounded once to bf16 (round to nearest even) into the bf16 rows of H
// [Bp, D] in shared memory, rows [B, Bp) zero: K6b's rows, as block_gemm
// rounds its operands. Ends with a barrier.
template <int D, typename XT>
__device__ void x_rows_bf16(const XT* __restrict__ x, bf16* H, int B, int Bp) {
  for (int i = threadIdx.x; i < Bp * D; i += kThreads)
    H[i] = __float2bfloat16(i < B * D ? ldf(x + i) : 0.f);
  __syncthreads();
}

// bf16 rows as given into the bf16 rows of H [Bp, D] in shared memory,
// rows [B, Bp) zero: K6a's q and k. 16 bytes a thread at a time where the
// rows are 16-byte aligned. Ends with a barrier.
template <int D>
__device__ void copy_rows_bf16(const bf16* __restrict__ x, bf16* H, int B, int Bp) {
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int n = B * D / 8, np = Bp * D / 8;
    const uint4* src = reinterpret_cast<const uint4*>(x);
    uint4* dst = reinterpret_cast<uint4*>(H);
    for (int i = threadIdx.x; i < np; i += kThreads)
      dst[i] = i < n ? src[i] : make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int i = threadIdx.x; i < Bp * D; i += kThreads)
      H[i] = i < B * D ? x[i] : __float2bfloat16(0.f);
  }
  __syncthreads();
}

// The float64 tensor-core body (bf16 compute, B <= 256) of K6c (LN_X),
// K6b (X) and K6a (QK). K6c and K6b: per partition the block reads x once
// and writes LN(x) (K6c) or x (K6b), rounded to bf16, into H in shared
// memory beside A_sig^T (bf16, staged once per block); warp w owns the
// 32-row strip [32 w, 32 w + 32): Q = H A_sig on the DMMAs (2x4 tiles of
// 16x8 per pass), each value rounded once to float32, then to bf16, into
// the warp's strip of Q in shared memory. K6a reads its bf16 q into Q and
// k into H, and has no A_sig. Then S = Q H^T, 32 columns a pass (K6a: each
// float64 sum rounded once to float32, then times scale in float32, as the
// plain version), whose positive valid entries the lanes sum (float64) and
// count while they are still in registers. Nothing but the row sums and
// counts goes to global memory. F32ACC (a test-only fault) rounds every
// sum to float32 as it goes.
template <int D, int MODE>
constexpr size_t tc_sig_smem(int bp) {
  return (size_t)(2 * bp * D + (MODE == kQK ? 0 : D * D)) * sizeof(bf16) +
         (size_t)bp * sizeof(float);
}

template <int D, typename XT, bool F32ACC, int MODE>
__global__ void __launch_bounds__(kThreads) tc_signature_kernel(const SigArgs a) {
  static_assert(MODE != kQK || sizeof(XT) == sizeof(bf16), "K6a's tensor-core body takes bf16");
  extern __shared__ uint4 smem_raw[];
  const int b = a.b, bp = (b + 31) & ~31;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* H = reinterpret_cast<bf16*>(smem_raw);
  bf16* Q = H + (size_t)bp * D;
  bf16* At = Q + (size_t)bp * D;
  float* pad = reinterpret_cast<float*>(At + (MODE == kQK ? 0 : D * D));
  if constexpr (MODE != kQK) {
    for (int i = threadIdx.x; i < D * D; i += kThreads) {
      const int n = i / D, k = i % D;
      At[i] = __float2bfloat16(a.A_sig[(size_t)k * D + n]);
    }
  }
  for (int k = blockIdx.x; k < a.nb; k += gridDim.x) {
    __syncthreads();  // the previous partition's H, Q and pad are no longer read
    for (int i = threadIdx.x; i < bp; i += kThreads)
      pad[i] = i < b ? a.pad[(size_t)k * b + i] : 0.f;
    const XT* xk = static_cast<const XT*>(a.x) + (size_t)k * b * D;
    if constexpr (MODE == kLnX) {
      ln_rows_bf16<D>(xk, H, a.gamma, a.beta, b, bp, 1e-5f);
    } else if constexpr (MODE == kX) {
      x_rows_bf16<D>(xk, H, b, bp);
    } else {
      copy_rows_bf16<D>(static_cast<const bf16*>(a.k) + (size_t)k * b * D, H, b, bp);
      copy_rows_bf16<D>(reinterpret_cast<const bf16*>(xk), Q, b, bp);
    }
    const int r0 = 32 * warp;
    if (r0 >= b) continue;
    double acc[2][4][4];  // 2 x 4 tiles of 16x8: rows r0 + 16 i + 8 h + g
    if constexpr (MODE != kQK) {
      for (int n0 = 0; n0 < D; n0 += 32) {
        zero_tiles(acc);
        f64_mma_tiles<2, 4, F32ACC>(acc, H + (size_t)r0 * D, D, At + (size_t)n0 * D, D, D);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<__nv_bfloat162*>(Q + (size_t)(r0 + 16 * i + 8 * h + g) * D +
                                                 n0 + 8 * j + 2 * t) =
                  __floats2bfloat162_rn((float)acc[i][j][2 * h], (float)acc[i][j][2 * h + 1]);
      }
      __syncwarp();
    }
    double rs[4] = {0.0, 0.0, 0.0, 0.0};  // rows r0 + 8 ri + g, ri = 2 i + h
    float rc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < bp; c0 += 32) {
      zero_tiles(acc);
      f64_mma_tiles<2, 4, F32ACC>(acc, Q + (size_t)r0 * D, D, H + (size_t)c0 * D, D, D);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + 2 * t + e;
          if (!(pad[c] > 0.f)) continue;
#pragma unroll
          for (int ri = 0; ri < 4; ++ri) {
            float v = (float)acc[ri / 2][j][2 * (ri % 2) + e];
            if constexpr (MODE == kQK) v = __fmul_rn(v, a.scale);
            if (v > a.eps) {
              rs[ri] += v;
              rc[ri] += 1.f;
            }
          }
        }
    }
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      double s = rs[ri];
      float c = rc[ri];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      const int r = r0 + 8 * ri + g;
      if (t == 0 && r < b) {
        const bool ok = pad[r] > 0.f;
        a.rsum[(size_t)k * b + r] = ok ? (float)s : 0.f;
        a.rcnt[(size_t)k * b + r] = ok ? c : 0.f;
      }
    }
  }
}

template <int MODE, int D, typename XT, bool F32ACC = false>
int run_tc(const SigArgs& a, int grid, cudaStream_t s) {
  auto kernel = tc_signature_kernel<D, XT, F32ACC, MODE>;
  const size_t smem = tc_sig_smem<D, MODE>((a.b + 31) & ~31);
  if (const int rc = allow_smem(kernel, smem)) return rc;
  const int g = resident_grid(kernel, grid, smem);
  kernel<<<g, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, typename XT>
int run_tc_width(const SigArgs& a, int grid, cudaStream_t s) {
  if (a.d == 32) return run_tc<MODE, 32, XT>(a, grid, s);
  if (a.d == 64) return run_tc<MODE, 64, XT>(a, grid, s);
  return run_tc<MODE, 128, XT>(a, grid, s);
}

template <int MODE, typename XT, bool BF16>
int run(const SigArgs& a, int grid, cudaStream_t s) {
  auto kernel = signature_kernel<MODE, XT, BF16>;
  const int g = resident_grid(kernel, grid, 0);
  kernel<<<g, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int run_types(const SigArgs& a, int grid, int x_bf16, int compute_bf16, cudaStream_t s) {
  if (x_bf16)
    return compute_bf16 ? run<MODE, __nv_bfloat16, true>(a, grid, s)
                        : run<MODE, __nv_bfloat16, false>(a, grid, s);
  return compute_bf16 ? run<MODE, float, true>(a, grid, s) : run<MODE, float, false>(a, grid, s);
}

// The tensor-core body (tensor_core: bf16 compute, b <= 256, no scratch)
// or block_gemm's; variant 1 (the tensor-core body at D = 128, on float32
// x for K6c and K6b, on bf16 q and k for K6a) is the test-only fault
// F32ACC. K6a's compute type is its inputs' (q and k used as given).
template <int MODE>
int run_sig(const SigArgs& a, int grid, int x_bf16, int compute_bf16, int tensor_core,
            int variant, cudaStream_t s) {
  constexpr bool kQKMode = MODE == kQK;
  if (tensor_core && (!compute_bf16 || a.b > kDmmaMaxB)) return (int)cudaErrorInvalidValue;
  if (variant != 0 && !(variant == 1 && tensor_core && a.d == 128 && (x_bf16 != 0) == kQKMode))
    return (int)cudaErrorInvalidValue;
  if constexpr (kQKMode) {
    if (variant == 1) return run_tc<MODE, 128, __nv_bfloat16, true>(a, grid, s);
    if (tensor_core) return run_tc_width<MODE, __nv_bfloat16>(a, grid, s);
    return x_bf16 ? run<MODE, __nv_bfloat16, false>(a, grid, s)
                  : run<MODE, float, false>(a, grid, s);
  } else {
    if (variant == 1) return run_tc<MODE, 128, float, true>(a, grid, s);
    if (tensor_core)
      return x_bf16 ? run_tc_width<MODE, __nv_bfloat16>(a, grid, s)
                    : run_tc_width<MODE, float>(a, grid, s);
    return run_types<MODE>(a, grid, x_bf16, compute_bf16, s);
  }
}

bool shape_ok(int b, int d) { return b >= 1 && b <= kMaxB && width_ok(d); }

}  // namespace

// K6c and K6b: tensor_core and variant as run_sig says.
extern "C" int block_gate_signature_ln_x(const void* x, const void* pad, const void* A_sig,
                                         const void* gamma, const void* beta, void* rsum,
                                         void* rcnt, void* scratch, int nb, int b, int d,
                                         int grid, int x_bf16, int compute_bf16,
                                         int tensor_core, int variant, float eps,
                                         void* stream) {
  if (!shape_ok(b, d)) return (int)cudaErrorInvalidValue;
  SigArgs a{x, nullptr, static_cast<const float*>(pad), static_cast<const float*>(A_sig),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<float*>(rsum), static_cast<float*>(rcnt),
            static_cast<float*>(scratch), nb, b, d, eps, 1.f};
  return run_sig<kLnX>(a, grid, x_bf16, compute_bf16, tensor_core, variant,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int block_gate_signature_x(const void* x, const void* pad, const void* A_sig,
                                      void* rsum, void* rcnt, void* scratch, int nb, int b,
                                      int d, int grid, int x_bf16, int compute_bf16,
                                      int tensor_core, int variant, float eps, void* stream) {
  if (!shape_ok(b, d)) return (int)cudaErrorInvalidValue;
  SigArgs a{x, nullptr, static_cast<const float*>(pad), static_cast<const float*>(A_sig),
            nullptr, nullptr, static_cast<float*>(rsum), static_cast<float*>(rcnt),
            static_cast<float*>(scratch), nb, b, d, eps, 1.f};
  return run_sig<kX>(a, grid, x_bf16, compute_bf16, tensor_core, variant,
                     static_cast<cudaStream_t>(stream));
}

// K6a: q and k share one type (float32 or bf16), which is its compute
// type; tensor_core and variant as run_sig says.
extern "C" int block_gate_signature(const void* q, const void* pad, const void* k, void* rsum,
                                    void* rcnt, void* scratch, int nb, int b, int d, int grid,
                                    int qk_bf16, int tensor_core, int variant, float eps,
                                    float scale, void* stream) {
  if (!shape_ok(b, d)) return (int)cudaErrorInvalidValue;
  SigArgs a{q, k, static_cast<const float*>(pad), nullptr, nullptr, nullptr,
            static_cast<float*>(rsum), static_cast<float*>(rcnt),
            static_cast<float*>(scratch), nb, b, d, eps, scale};
  return run_sig<kQK>(a, grid, qk_bf16, qk_bf16, tensor_core, variant,
                      static_cast<cudaStream_t>(stream));
}
