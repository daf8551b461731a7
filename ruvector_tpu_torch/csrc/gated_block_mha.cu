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
// H=4 is 2 n H (2D + 2B) D operations forward (7.9e11, bf16: 0.8 ms) and
// 2 n H (6D + 5B) D backward (2.1e12, of which 1.4e12 float32: 21 ms at
// 67 TFLOP/s), against 0.5-1.5 GB of bytes (0.2-0.5 ms), so both are bound
// by operations. This first version runs every product on the CUDA cores
// in float32 FMA (block_gemm), so it is bound by FMA issue and L2 latency;
// tensor cores are later work.
//
// Design: as the fused layer (gated_block_layer.cu): a persistent grid,
// one block of 256 threads owns one partition at a time and runs the
// stages one after the other with barriers; the partition's rows, one
// head's projections and its [B, B] scores live in the block's slice of a
// global scratch buffer. The TPU kernel sums dA and dWvo over its
// sequential grid into one output block; here blocks run in parallel, so
// each block adds its partitions' dA and dWvo into its own [D, H D] slice
// of a partial buffer (zeroed by the caller), and reduce_partials sums the
// slices in block order. No float atomics: runs repeat bit for bit.

#include "gated_common.cuh"

namespace {

using namespace rvt;

struct MhaArgs {
  const void* x;        // [nB, B, D] float32 or bf16
  const int32_t* keep;  // [nB, ceil(B/32), B] gate bits
  const float* pad;     // [nB, B]
  const float* A_cat;   // [D, H D]
  const float* Wvo_cat; // [D, H D]
  const void* g;        // [nB, B, D] like x (backward)
  void* out;            // [nB, B, D] like x: the output (forward) or dx (backward)
  float* dA;            // grid x [D, H D] partials (backward)
  float* dWvo;          // grid x [D, H D] partials (backward)
  float* scratch;       // grid x (4 B D + B B + B) forward, (7 B D + 2 B B + B) backward
  int nb, b, d, heads;
};

__host__ __device__ size_t fwd_scratch(int b, int d) {
  return 4 * (size_t)b * d + (size_t)b * b + b;
}
__host__ __device__ size_t bwd_scratch(int b, int d) {
  return 7 * (size_t)b * d + 2 * (size_t)b * b + b;
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
  float* X = a.scratch + (size_t)blockIdx.x * fwd_scratch(b, d);
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
  float* X = a.scratch + (size_t)blockIdx.x * bwd_scratch(b, d);
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

// scratch: grid x (4 B D + B B + B) floats
extern "C" int gated_block_mha_fwd(const void* x, const void* keep, const void* pad,
                                   const void* A_cat, const void* Wvo_cat, void* out,
                                   void* scratch, int nb, int b, int d, int heads, int grid,
                                   int x_bf16, int compute_bf16, void* stream) {
  if (!shape_ok(b, d, heads)) return (int)cudaErrorInvalidValue;
  MhaArgs a{x, static_cast<const int32_t*>(keep), static_cast<const float*>(pad),
            static_cast<const float*>(A_cat), static_cast<const float*>(Wvo_cat), nullptr, out,
            nullptr, nullptr, static_cast<float*>(scratch), nb, b, d, heads};
  return run_types<true>(a, grid, x_bf16, compute_bf16, static_cast<cudaStream_t>(stream));
}

// dA_parts, dWvo_parts: grid x [D, H D] float32, zeroed by the caller
// (blocks past the resident count leave theirs at 0); scratch: grid x
// (7 B D + 2 B B + B) floats. g and dx have x's type.
extern "C" int gated_block_mha_bwd(const void* x, const void* keep, const void* pad,
                                   const void* A_cat, const void* Wvo_cat, const void* g,
                                   void* dx, void* dA_parts, void* dWvo_parts, void* scratch,
                                   int nb, int b, int d, int heads, int grid, int x_bf16,
                                   int compute_bf16, void* stream) {
  if (!shape_ok(b, d, heads)) return (int)cudaErrorInvalidValue;
  MhaArgs a{x, static_cast<const int32_t*>(keep), static_cast<const float*>(pad),
            static_cast<const float*>(A_cat), static_cast<const float*>(Wvo_cat), g, dx,
            static_cast<float*>(dA_parts), static_cast<float*>(dWvo_parts),
            static_cast<float*>(scratch), nb, b, d, heads};
  return run_types<false>(a, grid, x_bf16, compute_bf16, static_cast<cudaStream_t>(stream));
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
