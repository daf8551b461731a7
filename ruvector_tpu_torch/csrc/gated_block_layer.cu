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
// (0.47 ms), so it is bound by operations. This first version runs every
// product on the CUDA cores in float32 FMA, so it is bound by FMA issue
// (about 5.7e11 FMA at 1M nodes); tensor cores are later work.
//
// Design. Sublayer 2 mixes all B rows of a partition (wd g), so one block
// must have the whole partition's attention output first: one block of
// 256 threads owns one partition at a time (a persistent grid of as many
// blocks as stay resident), and the stages run one after the other with
// a barrier between them. x (f32), the normalized rows, one head's
// q_h = h A_h and y_h = h Wvo_h, the attention sum and one head's [B, B]
// logits do not fit in 227 KB of shared memory at B=256, D=128, so they
// live in the block's slice of a global scratch buffer (5 B D + B^2 + B
// floats, about 0.9 MB; over the grid more than the 50 MB L2); the
// weights stream from L2 through block_gemm's shared-memory tiles. The
// FFN runs in D-wide chunks of its hidden layer, so the hidden never
// exceeds [B, D]. Rounding follows the TPU kernel: every product takes
// compute-type operands (rounded as block_gemm loads them) with float32
// sums; the residual stream stays float32 and is rounded once at the
// output; the softmax weights are rounded un-normalised.

#include "gated_common.cuh"

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
  void* out;            // [nB, B, D] like x
  float *rsum, *rcnt;   // [nB, B] (K4b)
  float* scratch;       // grid x (5 B D + B B + B)
  int nb, b, d, heads, fm;
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
extern "C" int gated_block_layer(const void* x, const void* keep, const void* pad,
                                 const void* wd, const void* const* folded, const void* A_sig,
                                 const void* sig_gamma, const void* sig_beta, void* out,
                                 void* rsum, void* rcnt, void* scratch, int nb, int b, int d,
                                 int heads, int fm, int grid, int x_bf16, int wd_bf16,
                                 int compute_bf16, float ln_eps, float sig_eps,
                                 void* stream) {
  if (b > kMaxB || b < 1 || !width_ok(d) || heads < 1 || fm < 1)
    return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(folded);
  LayerArgs a{x, static_cast<const int32_t*>(keep), static_cast<const float*>(pad), wd,
              f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11],
              f[12], f[13], static_cast<const float*>(A_sig),
              static_cast<const float*>(sig_gamma), static_cast<const float*>(sig_beta),
              out, static_cast<float*>(rsum), static_cast<float*>(rcnt),
              static_cast<float*>(scratch), nb, b, d, heads, fm, ln_eps, sig_eps};
  const int sig = A_sig != nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return wd_bf16 ? run_cdt<__nv_bfloat16, __nv_bfloat16>(a, grid, compute_bf16, sig, s)
                   : run_cdt<__nv_bfloat16, float>(a, grid, compute_bf16, sig, s);
  return wd_bf16 ? run_cdt<float, __nv_bfloat16>(a, grid, compute_bf16, sig, s)
                 : run_cdt<float, float>(a, grid, compute_bf16, sig, s);
}
