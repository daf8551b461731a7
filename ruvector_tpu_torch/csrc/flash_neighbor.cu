// Online-softmax attention of each query over its own keys and values.
//
// Replaces the TPU kernel ruvector_tpu/ops/pallas/flash_neighbor.py:69
// flash_neighbor_attention (kernel body :26-63). For every row b:
//   s[m]   = <q[b], k[b, m]> / sqrt(D)          (keys with mask <= 0 left out)
//   p[m]   = exp(s[m] - max_valid s)
//   out[b] = sum_m p[m] v[b, m] / l,  l = sum_m p[m];  l <= 1e-8 -> divide by 1
// so a fully masked row gives 0. Layouts: q [B, D], k and v [B, M, D], mask
// [B, M] or none, out [B, D], all float32; D in {32, 64, 128, 256}.
//
// What bounds it on an H100: bytes. One multiply-add per key element for
// the score and one for the output, 0.5 flop per byte of k and v. At the
// serving re-rank's shape (B = 1024, M = ef = 256, D = 128, no mask) the
// arguments as passed are q 0.52 MB, k 134.2 MB, v 134.2 MB and out 0.52 MB:
// 269.5 MB, 0.080 ms at 3.35 TB/s. The re-rank passes the same candidate
// pool as k and v (serve/rerank.py), so the function needs the pool once:
// q, pool and out make 135 MB, 0.040 ms, the bound chip_smoke.py reports.
// This kernel loads k and v as given; where they are one tensor the v row
// is the k row just loaded, so its second load should come from L2.
//
// Design: the TPU kernel tiles B x M on a sequential grid and carries the
// running (max, sum, acc) in VMEM across the M axis. Here one block of four
// warps owns one query row and splits M between its warps in interleaved
// chunks of KC keys; each warp keeps its own running (max, sum, acc) in
// registers, each lane holding D/32 of q and of acc, so every k and v row is
// one coalesced read (16 bytes a lane at D >= 128). A chunk's KC key rows and
// value rows are all loaded before their scores are reduced (with warp
// shuffles, KC sums interleaved), so 2 KC rows per warp are in flight. Keys
// past M or masked out are never loaded: the ragged edges need no padded
// copies. At the end the four warps' partial (max, sum, acc) are merged in
// warp order through shared memory: no float atomics, so runs repeat bit for
// bit. Accumulation is float32 throughout.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// lane's VPL floats of a D = 32 * VPL row: element e sits at column
// (e / 4) * 128 + lane * 4 + e % 4 for VPL >= 4, lane * VPL + e below.
template <int VPL>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int lane,
                                         float (&r)[VPL]) {
  if constexpr (VPL == 1) {
    r[0] = __ldg(row + lane);
  } else if constexpr (VPL == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(row) + lane);
    r[0] = t.x;
    r[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < VPL / 4; ++c) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row) + c * 32 + lane);
      r[4 * c] = t.x;
      r[4 * c + 1] = t.y;
      r[4 * c + 2] = t.z;
      r[4 * c + 3] = t.w;
    }
  }
}

template <int VPL>
__device__ __forceinline__ void store_row(float* __restrict__ row, int lane,
                                          const float (&r)[VPL]) {
  if constexpr (VPL == 1) {
    row[lane] = r[0];
  } else if constexpr (VPL == 2) {
    reinterpret_cast<float2*>(row)[lane] = make_float2(r[0], r[1]);
  } else {
#pragma unroll
    for (int c = 0; c < VPL / 4; ++c)
      reinterpret_cast<float4*>(row)[c * 32 + lane] =
          make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
  }
}

template <int VPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_neighbor_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ mask,
                      float* __restrict__ out, int m, float scale) {
  constexpr int D = 32 * VPL;
  constexpr int KC = 32 / VPL;  // keys per chunk: 32 floats of k and of v per lane
  __shared__ float s_max[kWarps], s_sum[kWarps];
  __shared__ float s_acc[kWarps][D];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row = blockIdx.x;
  const float* kr = k + row * m * D;
  const float* vr = v + row * m * D;
  const float* mr = mask == nullptr ? nullptr : mask + row * m;

  float qv[VPL], acc[VPL];
  load_row<VPL>(q + row * D, lane, qv);
#pragma unroll
  for (int e = 0; e < VPL; ++e) acc[e] = 0.f;
  float m_run = kNeg, l_run = 0.f;

  for (int c0 = warp * KC; c0 < m; c0 += kWarps * KC) {
    // lane j < KC tests key c0 + j; bit j of `valid` says it takes part
    bool mine = false;
    if (lane < KC) {
      const int key = c0 + lane;
      mine = key < m && (mr == nullptr || mr[key] > 0.f);
    }
    const unsigned valid = __ballot_sync(kFull, mine);
    if (valid == 0u) continue;

    float kx[KC][VPL], vx[KC][VPL];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if ((valid >> j) & 1u) {
        load_row<VPL>(kr + (size_t)(c0 + j) * D, lane, kx[j]);
        load_row<VPL>(vr + (size_t)(c0 + j) * D, lane, vx[j]);
      } else {
#pragma unroll
        for (int e = 0; e < VPL; ++e) kx[j][e] = vx[j][e] = 0.f;
      }
    }
    float s[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) t = fmaf(qv[e], kx[j][e], t);
      s[j] = t;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < KC; ++j) s[j] += __shfl_xor_sync(kFull, s[j], o);
    }
    float c_max = m_run;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      s[j] *= scale;
      if ((valid >> j) & 1u) c_max = fmaxf(c_max, s[j]);
    }
    const float rescale = expf(m_run - c_max);
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[e] *= rescale;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if ((valid >> j) & 1u) {
        const float p = expf(s[j] - c_max);
        p_sum += p;
#pragma unroll
        for (int e = 0; e < VPL; ++e) acc[e] = fmaf(p, vx[j][e], acc[e]);
      }
    }
    l_run = l_run * rescale + p_sum;
    m_run = c_max;
  }

  // merge the warps' partial states in warp order
  if (lane == 0) {
    s_max[warp] = m_run;
    s_sum[warp] = l_run;
  }
#pragma unroll
  for (int e = 0; e < VPL; ++e) s_acc[warp][e * 32 + lane] = acc[e];
  __syncthreads();
  if (warp != 0) return;
  float mx = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_max[w]);
  float l = 0.f, o[VPL];
#pragma unroll
  for (int e = 0; e < VPL; ++e) o[e] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float f = expf(s_max[w] - mx);
    l = fmaf(s_sum[w], f, l);
#pragma unroll
    for (int e = 0; e < VPL; ++e) o[e] = fmaf(s_acc[w][e * 32 + lane], f, o[e]);
  }
  const float denom = l > 1e-8f ? l : 1.f;
#pragma unroll
  for (int e = 0; e < VPL; ++e) o[e] = o[e] / denom;
  store_row<VPL>(out + row * D, lane, o);
}

template <int VPL>
int launch(const float* q, const float* k, const float* v, const float* mask, float* out,
           int b, int m, float scale, cudaStream_t stream) {
  flash_neighbor_kernel<VPL><<<b, kWarps * 32, 0, stream>>>(q, k, v, mask, out, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// mask may be null (every key valid). Pointers 16-byte aligned (the wrapper
// checks them).
extern "C" int flash_neighbor_f32(const void* q, const void* k, const void* v,
                                  const void* mask, void* out, int b, int m, int d,
                                  float scale, void* stream) {
  const auto* Q = static_cast<const float*>(q);
  const auto* K = static_cast<const float*>(k);
  const auto* V = static_cast<const float*>(v);
  const auto* M = static_cast<const float*>(mask);
  auto* O = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<1>(Q, K, V, M, O, b, m, scale, s);
    case 64: return launch<2>(Q, K, V, M, O, b, m, scale, s);
    case 128: return launch<4>(Q, K, V, M, O, b, m, scale, s);
    case 256: return launch<8>(Q, K, V, M, O, b, m, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
