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
// kernel is a streaming pass over nbr. At the main path's shape (N =
// 100,000, M = 16, D = 128, H = 4) it moves 1.28 GB: 0.386 ms at 3.35 TB/s.
//
// Two bodies, chosen by shape before the launch (an explicit dispatch, not
// a fallback; ops/kernels/neighbor_mix.k3_body):
//
// * stream_mix_kernel ("streaming": H in {1, 2, 4, 8}, M <= kSlots = 16,
//   D % 4 == 0 and D <= 128). One warp per node; lane l owns columns
//   4l..4l+3 as a float4. All of the node's M rows are loaded before any
//   is used (16 float4, 64 registers), so HBM sees the node's whole 8 KB
//   request at once and the aggregation reads registers. The partial dot
//   products of two heads (2 x 16 values a lane) are reduced together by a
//   transposing (reduce-scatter) butterfly, 31 shuffles, after which lane
//   l holds the score of head l / 16, slot l % 16 (H = 1: slot l / 2). The
//   softmax runs on those registers (max and sum over the head's 16
//   lanes), and the aggregation broadcasts each weight by shuffle. Rows
//   past M are zeros and never loaded. Outputs are float4 stores. Two CTAs
//   of 8 warps an SM (<= 128 registers): 16 nodes' rows in flight an SM.
// * neighbor_mix_kernel ("warp": every other shape, e.g. 16 heads, M >
//   16, D % 4 != 0). One warp per node; the warp stages u[n] and the
//   (H+1) x M weight table in shared memory; lanes stride the feature axis
//   so every neighbor-row load is coalesced. Pass 1 reduces one score per
//   (slot, head) with warp shuffles; pass 2 re-reads the node's M rows
//   (through L1) and accumulates all H+1 outputs per feature column.
//
// Both have no block-wide barrier (so the ragged tail of N is masked by
// retiring whole warps; the TPU wrapper padded N to its tile instead).
// Masking uses -1e30 and selects, never -inf, so an all-masked row gives
// zeros and no NaN.

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


// ---------------------------------------------------------------------------
// the streaming body
// ---------------------------------------------------------------------------

constexpr int kSlots = 16;  // neighbor rows the streaming body holds in registers

// Reduce-scatter over the warp of N values a lane (N = 16 or 32), offsets
// O, O/2, ..., 1: at each offset a lane keeps one half of its values, adds
// its partner's copy of that half and hands over the other. After it, v[0]
// of lane l is the warp's sum of value (l * N) / 32 (once a lane holds one
// value, the remaining offsets add the partner's copy).
template <int P, int N, int O>
__device__ __forceinline__ void reduce_scatter(float (&v)[P], int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float keep = up ? v[i + N / 2] : v[i];
        const float give = up ? v[i] : v[i + N / 2];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, O);
      }
      reduce_scatter<P, N / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<P, 1, O / 2>(v, lane);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// DROP (a test-only fault) leaves slot m - 1 out of every sum.
template <int H, bool DROP>
__global__ void __launch_bounds__(kWarps * 32, 2)
stream_mix_kernel(const float* __restrict__ u, const float* __restrict__ bias,
                  const float* __restrict__ nbr, const float* __restrict__ mask,
                  const float* __restrict__ wnorm, float* __restrict__ out,
                  int n, int m, int d, float scale) {
  constexpr int HG = H < 2 ? H : 2;        // heads one butterfly reduces
  constexpr int P = HG * kSlots;           // values a lane reduces: 16 or 32
  constexpr int kSpan = 32 * kSlots / P;   // lanes of one head's slots
  constexpr int kDup = P < 32 ? 32 / P : 1;  // lanes holding the same slot
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (node >= n) return;  // warps are independent: no block barrier below
  const int mm = DROP ? m - 1 : m;  // slots summed
  const bool cols = 4 * lane < d;   // this lane's four columns exist

  float4 x[kSlots];
  const float* nb = nbr + (size_t)node * m * d + 4 * lane;
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    x[j] = cols && j < mm ? __ldcs(reinterpret_cast<const float4*>(nb + (size_t)j * d))
                          : make_float4(0.f, 0.f, 0.f, 0.f);

  // the slot and head (within a pair) of this lane's reduced score
  const int my = lane * P / 32, my_j = my % kSlots, my_h = my / kSlots;
  const bool valid = my_j < mm && __ldg(mask + (size_t)node * m + my_j) > 0.f;
  float* on = out + (size_t)node * (H + 1) * d + 4 * lane;
#pragma unroll
  for (int h0 = 0; h0 < H; h0 += HG) {
    float v[P];
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float4 q = cols ? __ldg(reinterpret_cast<const float4*>(
                                  u + ((size_t)node * H + h0 + hh) * d + 4 * lane))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kSlots; ++j) v[hh * kSlots + j] = dot4(q, x[j]);
    }
    reduce_scatter<P, P, 16>(v, lane);
    float sc = valid ? (v[0] + __ldg(bias + (size_t)node * H + h0 + my_h)) * scale : kNeg;
    float mx = sc;
#pragma unroll
    for (int o = kDup; o < kSpan; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e = valid ? expf(sc - mx) : 0.f;
    float sum = e;
#pragma unroll
    for (int o = kDup; o < kSpan; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float w = e / fmaxf(sum, 1e-10f);
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        fma4(acc, __shfl_sync(0xffffffffu, w, (hh * kSlots + j) * 32 / P), x[j]);
      if (cols) __stcs(reinterpret_cast<float4*>(on + (size_t)(h0 + hh) * d), acc);
    }
  }
  // the weighted mean: slot j's weight from lane j
  const float wn = lane < mm ? __ldg(wnorm + (size_t)node * m + lane) : 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) fma4(acc, __shfl_sync(0xffffffffu, wn, j), x[j]);
  if (cols) __stcs(reinterpret_cast<float4*>(on + (size_t)H * d), acc);
}

template <int H, bool DROP>
int launch_stream(const float* u, const float* bias, const float* nbr, const float* mask,
                  const float* wnorm, float* out, int n, int m, int d, float scale,
                  cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps);
  stream_mix_kernel<H, DROP><<<grid, kWarps * 32, 0, stream>>>(u, bias, nbr, mask, wnorm, out,
                                                                  n, m, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// body 1 runs stream_mix_kernel (h in {1, 2, 4, 8}, m <= 16, d % 4 == 0,
// d <= 128, 16-byte aligned rows), body 0 neighbor_mix_kernel; variant 1
// (the streaming body at h = 4 only) is its test-only fault.
extern "C" int neighbor_mix_f32(const void* u, const void* bias, const void* nbr,
                                const void* mask, const void* wnorm, void* out,
                                int n, int h, int m, int d, int body, int variant,
                                float scale, void* stream) {
  const auto* U = static_cast<const float*>(u);
  const auto* B = static_cast<const float*>(bias);
  const auto* X = static_cast<const float*>(nbr);
  const auto* K = static_cast<const float*>(mask);
  const auto* W = static_cast<const float*>(wnorm);
  auto* O = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (m > kSlots || d % 4 != 0 || d > 32 * 4) return (int)cudaErrorInvalidValue;
    if (variant != 0) {
      if (variant != 1 || h != 4 || m < 1) return (int)cudaErrorInvalidValue;
      return launch_stream<4, true>(U, B, X, K, W, O, n, m, d, scale, s);
    }
    switch (h) {
      case 1: return launch_stream<1, false>(U, B, X, K, W, O, n, m, d, scale, s);
      case 2: return launch_stream<2, false>(U, B, X, K, W, O, n, m, d, scale, s);
      case 4: return launch_stream<4, false>(U, B, X, K, W, O, n, m, d, scale, s);
      case 8: return launch_stream<8, false>(U, B, X, K, W, O, n, m, d, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (body != 0 || variant != 0) return (int)cudaErrorInvalidValue;
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
