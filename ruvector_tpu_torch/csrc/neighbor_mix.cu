// Fused neighbor attention + aggregation over pre-gathered neighbor rows.
//
// Replaces the TPU kernel ruvector_tpu/ops/pallas/neighbor_mix.py:68
// fused_neighbor_mix (kernel body :32-62). For every node n:
//   scores[h, m] = (sum_d u[n,h,d] * nbr[n,m,d] + bias[n,h]) * scale
//   attn[h, :]   = eps-guarded masked softmax over m (mask > 0; masked -> 0)
//   out[n, h, :] = sum_m attn[h, m] * nbr[n, m, :]     for h < H
//   out[n, H, :] = sum_m wnorm[n, m] * nbr[n, m, :]
// All float32. Layouts: u [N,H,D], bias [N,H], nbr [N,M,D], mask and wnorm
// [N,M], out [N,H+1,D].
//
// What bounds it on an H100: bytes. The [N,M,D] neighbor tensor is read
// once per node row (2*(2H+1)*D flops per neighbor row of 4*D bytes is
// about 2 flops/byte, far below the card's ~20 f32 flops/byte), so the
// kernel is a streaming pass over nbr.
//
// Design: one warp per node and no block-wide barrier (so the ragged tail
// of N is masked by retiring whole warps — the TPU wrapper padded N to its
// tile instead). The warp stages u[n] and the (H+1) x M weight table in
// shared memory; lanes stride the feature axis so every neighbor-row load
// is coalesced. Pass 1 reduces one score per (slot, head) with warp
// shuffles; pass 2 re-reads the node's M rows (8 KB at M=16, D=128, so
// they are still in L1) and accumulates all H+1 outputs per feature
// column in registers. Masking uses -1e30 and selects, never -inf, so an
// all-masked row gives zeros and no NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
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

template <int H>
__global__ void __launch_bounds__(kWarps * 32)
neighbor_mix_kernel(const float* __restrict__ u, const float* __restrict__ bias,
                    const float* __restrict__ nbr, const float* __restrict__ mask,
                    const float* __restrict__ wnorm, float* __restrict__ out,
                    int n, int m, int d, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarps + warp;
  if (node >= n) return;  // warps are independent: no block barrier below

  float* us = smem + (size_t)warp * (H * d + (H + 1) * m);  // [H][D]
  float* ws = us + H * d;                                    // [H+1][M]
  const float* un = u + (size_t)node * H * d;
  const float* nb = nbr + (size_t)node * m * d;
  const float* mk = mask + (size_t)node * m;
  for (int i = lane; i < H * d; i += 32) us[i] = un[i];
  __syncwarp();

  // pass 1: one score per (slot, head)
  for (int j = 0; j < m; ++j) {
    float acc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = 0.f;
    const float* g = nb + (size_t)j * d;
    for (int c = lane; c < d; c += 32) {
      const float x = g[c];
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = fmaf(us[h * d + c], x, acc[h]);
    }
    const bool valid = mk[j] > 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float s = warp_sum(acc[h]);
      if (lane == 0)
        ws[h * m + j] = valid ? (s + bias[(size_t)node * H + h]) * scale : kNeg;
    }
  }
  __syncwarp();

  // eps-guarded masked softmax per head; row H holds wnorm
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float mx = kNeg;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, ws[h * m + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float e = mk[j] > 0.f ? expf(ws[h * m + j] - mx) : 0.f;
      ws[h * m + j] = e;
      sum += e;
    }
    const float denom = fmaxf(warp_sum(sum), 1e-10f);
    for (int j = lane; j < m; j += 32) ws[h * m + j] = ws[h * m + j] / denom;
  }
  for (int j = lane; j < m; j += 32) ws[H * m + j] = wnorm[(size_t)node * m + j];
  __syncwarp();

  // pass 2: the H attention aggregates and the weighted mean
  float* on = out + (size_t)node * (H + 1) * d;
  for (int c = lane; c < d; c += 32) {
    float acc[H + 1];
#pragma unroll
    for (int h = 0; h <= H; ++h) acc[h] = 0.f;
    for (int j = 0; j < m; ++j) {
      const float x = nb[(size_t)j * d + c];
#pragma unroll
      for (int h = 0; h <= H; ++h) acc[h] = fmaf(ws[h * m + j], x, acc[h]);
    }
#pragma unroll
    for (int h = 0; h <= H; ++h) on[(size_t)h * d + c] = acc[h];
  }
}

template <int H>
int launch(const float* u, const float* bias, const float* nbr, const float* mask,
           const float* wnorm, float* out, int n, int m, int d, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * (H * d + (H + 1) * m) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      neighbor_mix_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kWarps - 1) / kWarps);
  neighbor_mix_kernel<H><<<grid, kWarps * 32, smem, stream>>>(
      u, bias, nbr, mask, wnorm, out, n, m, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int neighbor_mix_f32(const void* u, const void* bias, const void* nbr,
                                const void* mask, const void* wnorm, void* out,
                                int n, int h, int m, int d, float scale, void* stream) {
  const auto* U = static_cast<const float*>(u);
  const auto* B = static_cast<const float*>(bias);
  const auto* X = static_cast<const float*>(nbr);
  const auto* K = static_cast<const float*>(mask);
  const auto* W = static_cast<const float*>(wnorm);
  auto* O = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 1: return launch<1>(U, B, X, K, W, O, n, m, d, scale, s);
    case 2: return launch<2>(U, B, X, K, W, O, n, m, d, scale, s);
    case 4: return launch<4>(U, B, X, K, W, O, n, m, d, scale, s);
    case 8: return launch<8>(U, B, X, K, W, O, n, m, d, scale, s);
    case 16: return launch<16>(U, B, X, K, W, O, n, m, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
