// Gather-fused padded SpMM: out[i, :] = sum_m w[i, m] * feat[nbr[i, m], :].
//
// Replaces the TPU kernel ruvector_tpu/ops/pallas/spmm.py:34 spmm_pallas
// (kernel body :58-89). The weights already carry the mask (0 on padding).
// Layouts: feat [N, D] f32, nbr [B, M] int32, w [B, M] f32, out [B, D] f32;
// B (the rows of nbr) may differ from N.
//
// What bounds it on an H100: bytes. 2 flops per gathered float. Counting
// each input once (feat, nbr, w) and the output once, the regular graph
// (N = B = 99,840, M = 16, D = 128) moves 115 MB: 0.034 ms at 3.35 TB/s.
// The gather itself reads one 512-byte feature row per edge, 1.6M rows or
// 818 MB (0.24 ms from device memory); rows of a clustered graph's
// neighbours mostly come from L2.
//
// Design: the TPU kernel had to prefetch every index into scalar memory
// and copy rows in DMA waves of <= 256 (its semaphore and SMEM limits cap
// a call at ~250k edges). Here a warp owns one output row and loads its
// own indices and weights, 32 at a time, one per lane, then broadcasts
// them with shuffles; no limit on the edges of a call. Lanes stride the
// feature axis in float4s, so every gathered row is one coalesced 16-byte-
// per-lane read (D = 128: one float4 per lane). Edges are taken four at a
// time with the four row loads issued before their multiply-adds, so
// several rows are in flight per warp; the sum runs over m in order. An
// index outside [0, N) is never read: its edge adds nothing (the wrapper
// needs no host-side check, and so no sync).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

template <int C>  // float4 chunks per lane: D <= 128 * C
__global__ void __launch_bounds__(kWarps * 32)
spmm_gather_kernel(const float* __restrict__ feat, const int* __restrict__ nbr,
                   const float* __restrict__ w, float* __restrict__ out,
                   int n, int b, int m, int d4) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= b) return;  // warps are independent: no block barrier
  const float4* f4 = reinterpret_cast<const float4*>(feat);
  const int* nr = nbr + (size_t)row * m;
  const float* wr = w + (size_t)row * m;

  float4 acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int base = 0; base < m; base += 32) {
    const int cnt = min(32, m - base);
    int my_idx = -1;
    float my_w = 0.f;
    if (lane < cnt) {
      my_idx = nr[base + lane];
      my_w = wr[base + lane];
    }
    for (int t = 0; t < cnt; t += 4) {
      int idx[4];
      float wt[4];
      float4 x[4][C];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        idx[u] = __shfl_sync(0xffffffffu, my_idx, (t + u) & 31);
        wt[u] = __shfl_sync(0xffffffffu, my_w, (t + u) & 31);
        const bool ok = t + u < cnt && idx[u] >= 0 && idx[u] < n;
        const float4* src = f4 + (size_t)(ok ? idx[u] : 0) * d4;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = c * 32 + lane;
          x[u][c] = (ok && col < d4) ? __ldg(src + col) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        if (!ok) wt[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[c].x = fmaf(wt[u], x[u][c].x, acc[c].x);
          acc[c].y = fmaf(wt[u], x[u][c].y, acc[c].y);
          acc[c].z = fmaf(wt[u], x[u][c].z, acc[c].z);
          acc[c].w = fmaf(wt[u], x[u][c].w, acc[c].w);
        }
      }
    }
  }
  float4* o4 = reinterpret_cast<float4*>(out + (size_t)row * d4 * 4);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = c * 32 + lane;
    if (col < d4) o4[col] = acc[c];
  }
}

template <int C>
int launch(const float* feat, const int* nbr, const float* w, float* out, int n, int b,
           int m, int d, cudaStream_t stream) {
  const dim3 grid((b + kWarps - 1) / kWarps);
  spmm_gather_kernel<C><<<grid, kWarps * 32, 0, stream>>>(feat, nbr, w, out, n, b, m, d / 4);
  return (int)cudaGetLastError();
}

}  // namespace

// d must be a multiple of 4 and at most 512; every pointer 16-byte aligned
// (the wrapper checks both).
extern "C" int spmm_gather_f32(const void* feat, const void* nbr, const void* w, void* out,
                               int n, int b, int m, int d, void* stream) {
  const auto* F = static_cast<const float*>(feat);
  const auto* I = static_cast<const int*>(nbr);
  const auto* W = static_cast<const float*>(w);
  auto* O = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (d % 4 != 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int chunks = (d / 4 + 31) / 32;
  switch (chunks) {
    case 1: return launch<1>(F, I, W, O, n, b, m, d, s);
    case 2: return launch<2>(F, I, W, O, n, b, m, d, s);
    case 3: case 4: return launch<4>(F, I, W, O, n, b, m, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
