// LN-folded gate signature (K6c): per partition, h = LN1(x) (eps 1e-5),
// s = (h A_sig) h^T, and per row the sum and count of s > eps over valid
// pairs.
//
// Replaces ruvector_tpu/ops/pallas/gated_block_attn.py:487
// block_gate_signature_ln_x (kernel :459-483). The gated graph
// transformer reduces (rsum, rcnt) to the per-partition signature
// sum(rsum) / max(sum(rcnt), 1) that drives temporal gate reuse.
//
// What bounds it on an H100: the least work is reading x once (0.51 GB at
// 1M nodes, 128-d float32) and 2 B D (B + D) bf16 products per partition
// (0.1 TFLOP at 1M nodes), so by the numbers it is bound by bytes
// (0.16 ms). This first version runs the products on the CUDA cores with
// float64 sums (block_gemm; a sum of bf16 products is then exact, so the
// counts match the plain version's bit for bit), so it is bound by FMA
// issue instead; tensor cores are later work.
//
// Design: a persistent grid, one block of 256 threads per partition at a
// time, the block's [B, D] normalized rows, [B, D] projected rows and
// [B, B] logits in its slice of a global scratch buffer (L2-resident);
// the reduction is one warp per row in a fixed order, so runs repeat bit
// for bit. The same gate_signature code is the epilogue of the fused
// layer with signature (gated_block_layer.cu), so both give the same bits.

#include "gated_common.cuh"

namespace {

using namespace rvt;

struct SigArgs {
  const void* x;       // [nB, B, D] float32 or bf16
  const float* pad;    // [nB, B]
  const float* A_sig;  // [D, D]
  const float* gamma;  // [D]
  const float* beta;   // [D]
  float* rsum;         // [nB, B]
  float* rcnt;         // [nB, B]
  float* scratch;      // grid x (2 B D + B B)
  int nb, b, d;
  float eps;
};

template <typename XT, bool BF16>
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
    gate_signature<BF16>(static_cast<const XT*>(a.x) + (size_t)k * b * d, pad, a.A_sig,
                         a.gamma, a.beta, a.eps, b, d, Hn, Q, S, gs,
                         a.rsum + (size_t)k * b, a.rcnt + (size_t)k * b);
  }
}

template <typename XT, bool BF16>
int run(const SigArgs& a, int grid, cudaStream_t s) {
  auto kernel = signature_kernel<XT, BF16>;
  const int g = resident_grid(kernel, grid, 0);
  kernel<<<g, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int block_gate_signature_ln_x(const void* x, const void* pad, const void* A_sig,
                                         const void* gamma, const void* beta, void* rsum,
                                         void* rcnt, void* scratch, int nb, int b, int d,
                                         int grid, int x_bf16, int compute_bf16, float eps,
                                         void* stream) {
  if (b > kMaxB || b < 1 || !width_ok(d)) return (int)cudaErrorInvalidValue;
  SigArgs a{x, static_cast<const float*>(pad), static_cast<const float*>(A_sig),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<float*>(rsum), static_cast<float*>(rcnt),
            static_cast<float*>(scratch), nb, b, d, eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return compute_bf16 ? run<__nv_bfloat16, true>(a, grid, s)
                        : run<__nv_bfloat16, false>(a, grid, s);
  return compute_bf16 ? run<float, true>(a, grid, s) : run<float, false>(a, grid, s);
}
