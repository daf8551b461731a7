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
// What bounds it on an H100: the least work is reading x once (0.51 GB at
// 1M nodes, 128-d float32) and 2 B D (B + D) bf16 products per partition
// (0.1 TFLOP at 1M nodes; K6a 2 B B D), so by the numbers it is bound by
// bytes (0.16 ms). This first version runs the products on the CUDA cores
// with float64 sums (block_gemm; a sum of bf16 products is then exact, so
// the counts match the plain versions' bit for bit), so it is bound by FMA
// issue instead; tensor cores are later work.
//
// Design: a persistent grid, one block of 256 threads per partition at a
// time, the block's [B, D] normalized rows, [B, D] projected rows and
// [B, B] logits in its slice of a global scratch buffer;
// the reduction is one warp per row in a fixed order, so runs repeat bit
// for bit. The same gate_signature code is the epilogue of the fused
// layer with signature (gated_block_layer.cu), so both give the same bits.

#include "gated_common.cuh"

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

bool shape_ok(int b, int d) { return b >= 1 && b <= kMaxB && width_ok(d); }

}  // namespace

extern "C" int block_gate_signature_ln_x(const void* x, const void* pad, const void* A_sig,
                                         const void* gamma, const void* beta, void* rsum,
                                         void* rcnt, void* scratch, int nb, int b, int d,
                                         int grid, int x_bf16, int compute_bf16, float eps,
                                         void* stream) {
  if (!shape_ok(b, d)) return (int)cudaErrorInvalidValue;
  SigArgs a{x, nullptr, static_cast<const float*>(pad), static_cast<const float*>(A_sig),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<float*>(rsum), static_cast<float*>(rcnt),
            static_cast<float*>(scratch), nb, b, d, eps, 1.f};
  return run_types<kLnX>(a, grid, x_bf16, compute_bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int block_gate_signature_x(const void* x, const void* pad, const void* A_sig,
                                      void* rsum, void* rcnt, void* scratch, int nb, int b,
                                      int d, int grid, int x_bf16, int compute_bf16, float eps,
                                      void* stream) {
  if (!shape_ok(b, d)) return (int)cudaErrorInvalidValue;
  SigArgs a{x, nullptr, static_cast<const float*>(pad), static_cast<const float*>(A_sig),
            nullptr, nullptr, static_cast<float*>(rsum), static_cast<float*>(rcnt),
            static_cast<float*>(scratch), nb, b, d, eps, 1.f};
  return run_types<kX>(a, grid, x_bf16, compute_bf16, static_cast<cudaStream_t>(stream));
}

// q and k share one type (float32 or bf16)
extern "C" int block_gate_signature(const void* q, const void* pad, const void* k, void* rsum,
                                    void* rcnt, void* scratch, int nb, int b, int d, int grid,
                                    int qk_bf16, float eps, float scale, void* stream) {
  if (!shape_ok(b, d)) return (int)cudaErrorInvalidValue;
  SigArgs a{q, k, static_cast<const float*>(pad), nullptr, nullptr, nullptr,
            static_cast<float*>(rsum), static_cast<float*>(rcnt),
            static_cast<float*>(scratch), nb, b, d, eps, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return qk_bf16 ? run<kQK, __nv_bfloat16, false>(a, grid, s)
                 : run<kQK, float, false>(a, grid, s);
}
