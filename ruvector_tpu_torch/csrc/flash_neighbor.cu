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
// re-rank passes the same candidate pool as k and v (serve/rerank.py), so
// the function needs the pool once: q, pool and out make 135 MB, 0.040 ms
// at 3.35 TB/s (0.080 ms counting k and v as two tensors).
//
// Design: the TPU kernel tiles B x M on a sequential grid and carries the
// running (max, sum, acc) in VMEM across the M axis. Here a query's keys
// are one contiguous [M, D] range, so they stream through shared memory:
//
// * A persistent grid: min(B, CTAs an SM x SMs) CTAs, each walking the
//   queries b = blockIdx.x, blockIdx.x + gridDim.x, ... (no part-empty
//   last wave at B = 1024 on 132 SMs).
// * A ring of kStages stages in dynamic shared memory, each one chunk of
//   KC = 32 key rows (16 KB at D = 128), filled by 1-D bulk copies
//   (cp.async.bulk, csrc/bulk_async.cuh) that complete on the stage's
//   "full" mbarrier. Warp 0 is the producer: its 32 lanes read the chunk's
//   32 mask values at once, the ballot is the chunk's valid bits (kept in
//   shared memory beside the stage), and lane 0 issues the copy, or, for a
//   chunk without a valid key, arrives without one (the chunk is skipped,
//   as before). The ring runs on across query boundaries, so the next
//   query's first chunks load while this one's last are computed. A
//   ragged last chunk copies (M - c0) rows.
// * Where k and v are one tensor (the re-rank), each chunk is copied once
//   and every row, read once into registers, serves as key and as value;
//   otherwise a stage holds the chunk's k rows and its v rows, two copies.
//   Both read the same values in the same order, so they give the same
//   bits.
// * Four consumer warps split a chunk's keys (8 each), lanes spanning D as
//   before: a row is one conflict-free 512-byte shared read at D = 128,
//   and each score one shuffle reduction (the 8 interleaved). A warp
//   releases the stage (its "empty" mbarrier) as soon as its rows are in
//   registers, then keeps its running (max, sum, acc) in float32. Each
//   warp loads the next query a query ahead, off its critical path.
// * At a query's end the four warps' partial states merge in warp order
//   through a double-buffered area of shared memory (one named barrier of
//   the consumer warps a query), each thread merging and storing its own
//   columns: no float atomics, so runs repeat bit for bit.
// Registers hold no copy in flight: the bytes in flight are the ring's,
// kStages x 16 KB a CTA at D = 128, three CTAs an SM.
//
// A test-only instance (NO_RESCALE, D = 128 only) leaves the online
// softmax's correction exp(m_old - m_new) out of acc and l: a fault that
// the card tests and chip_smoke.py's controls must reject.

#include <cuda_runtime.h>

#include "bulk_async.cuh"

namespace {

constexpr int kConsumers = 4;                // consumer warps; warp 0 produces
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int KC = 32;                       // keys a chunk: one per producer lane
constexpr int kKeysPerWarp = KC / kConsumers;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// The shared-memory layout of one instance: the ring (stage s: KC k rows,
// then KC v rows where v is not k), the stages' barriers and valid bits,
// and the double-buffered merge area.
template <int D, bool KV_SAME>
struct Layout {
  static constexpr int kStageFloats = KC * D * (KV_SAME ? 1 : 2);
  static constexpr int kStages = clampi(65536 / (kStageFloats * 4), 2, 8);
  static constexpr int kRingBytes = kStages * kStageFloats * 4;
  static constexpr int kBarBytes = 2 * kStages * 8;              // full, empty
  static constexpr int kValidBytes = ((kStages * 4 + 15) / 16) * 16;
  static constexpr int kMergeFloats = 2 * (2 * kConsumers + kConsumers * D);  // m, l, acc
  static constexpr int kBytes = kRingBytes + kBarBytes + kValidBytes + kMergeFloats * 4;
};

// lane's VPL floats of a D = 32 * VPL row: element e sits at column
// (e / 4) * 128 + lane * 4 + e % 4 for VPL >= 4, lane * VPL + e below.
template <int VPL>
__device__ __forceinline__ void load_row(const float* row, int lane, float (&r)[VPL]) {
  if constexpr (VPL == 1) {
    r[0] = row[lane];
  } else if constexpr (VPL == 2) {
    const float2 t = reinterpret_cast<const float2*>(row)[lane];
    r[0] = t.x;
    r[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < VPL / 4; ++c) {
      const float4 t = reinterpret_cast<const float4*>(row)[c * 32 + lane];
      r[4 * c] = t.x;
      r[4 * c + 1] = t.y;
      r[4 * c + 2] = t.z;
      r[4 * c + 3] = t.w;
    }
  }
}

template <int VPL>
__device__ __forceinline__ void store_row(float* row, int lane, const float (&r)[VPL]) {
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumers) : "memory");
}

template <int VPL, bool KV_SAME, bool NO_RESCALE>
__global__ void __launch_bounds__(kThreads)
stream_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ mask,
                        float* __restrict__ out, int b, int m, float scale) {
  constexpr int D = 32 * VPL;
  using L = Layout<D, KV_SAME>;
  constexpr int S = L::kStages;
  // keys a warp holds in registers at once: 8 (4 at D = 256, twice)
  constexpr int KW = VPL <= 4 ? kKeysPerWarp : kKeysPerWarp / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kRingBytes);
  uint64_t* empty = full + S;
  unsigned* valid = reinterpret_cast<unsigned*>(smem + L::kRingBytes + L::kBarBytes);
  float* merge = reinterpret_cast<float*>(smem + L::kRingBytes + L::kBarBytes + L::kValidBytes);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nchunks = (m + KC - 1) / KC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bulk::mbar_init(&full[s], 1);
      bulk::mbar_init(&empty[s], kConsumers);
    }
    bulk::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 0) {  // the producer
    int i = 0;      // chunk sequence number, shared with the consumers
    for (int row = blockIdx.x; row < b; row += gridDim.x) {
      const size_t base = (size_t)row * m;
      for (int c0 = 0; c0 < m; c0 += KC, ++i) {
        const int key = c0 + lane;
        const bool ok = key < m && (mask == nullptr || mask[base + key] > 0.f);
        const unsigned bits = __ballot_sync(kFull, ok);
        const int s = i % S;
        if (lane == 0) {
          bulk::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
          valid[s] = bits;
          if (bits != 0u) {
            const uint32_t bytes = (uint32_t)min(KC, m - c0) * D * 4;
            float* stage = ring + s * L::kStageFloats;
            bulk::mbar_arrive_expect_tx(&full[s], KV_SAME ? bytes : 2 * bytes);
            bulk::bulk_copy_g2s(stage, k + (base + c0) * D, bytes, &full[s]);
            if (!KV_SAME)
              bulk::bulk_copy_g2s(stage + KC * D, v + (base + c0) * D, bytes, &full[s]);
          } else {
            bulk::mbar_arrive(&full[s]);
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  const int cw = warp - 1;  // consumer warp
  const int t = threadIdx.x - 32;
  int i = 0, qi = 0;
  float qn[VPL];  // the next query, loaded a query ahead
  if (blockIdx.x < b) load_row<VPL>(q + (size_t)blockIdx.x * D, lane, qn);
  for (int row = blockIdx.x; row < b; row += gridDim.x, ++qi) {
    float qv[VPL], acc[VPL];
#pragma unroll
    for (int e = 0; e < VPL; ++e) {
      qv[e] = qn[e];
      acc[e] = 0.f;
    }
    if (row + gridDim.x < b) load_row<VPL>(q + (size_t)(row + gridDim.x) * D, lane, qn);
    float m_run = kNeg, l_run = 0.f;

    for (int c = 0; c < nchunks; ++c, ++i) {
      const int s = i % S;
      bulk::mbar_wait(&full[s], (i / S) & 1);
      const unsigned mine = (valid[s] >> (cw * kKeysPerWarp)) & ((1u << kKeysPerWarp) - 1u);
      const float* kst = ring + s * L::kStageFloats + cw * kKeysPerWarp * D;
      const float* vst = KV_SAME ? kst : kst + KC * D;
#pragma unroll
      for (int g = 0; g < kKeysPerWarp / KW; ++g) {
        const unsigned bits = (mine >> (g * KW)) & ((1u << KW) - 1u);
        float kx[KW][VPL], vx[KV_SAME ? 1 : KW][VPL];
#pragma unroll
        for (int j = 0; j < KW; ++j) {
#pragma unroll
          for (int e = 0; e < VPL; ++e) kx[j][e] = 0.f;
          if (!KV_SAME) {
#pragma unroll
            for (int e = 0; e < VPL; ++e) vx[KV_SAME ? 0 : j][e] = 0.f;
          }
          if ((bits >> j) & 1u) {
            load_row<VPL>(kst + (g * KW + j) * D, lane, kx[j]);
            if (!KV_SAME) load_row<VPL>(vst + (g * KW + j) * D, lane, vx[KV_SAME ? 0 : j]);
          }
        }
        if (g == kKeysPerWarp / KW - 1) {  // every row of the stage is in registers
          __syncwarp();
          if (lane == 0) bulk::mbar_arrive(&empty[s]);
        }
        if (bits == 0u) continue;
        float sc[KW];
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < VPL; ++e) a = fmaf(qv[e], kx[j][e], a);
          sc[j] = a;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int j = 0; j < KW; ++j) sc[j] += __shfl_xor_sync(kFull, sc[j], o);
        }
        float c_max = m_run;
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          sc[j] *= scale;
          if ((bits >> j) & 1u) c_max = fmaxf(c_max, sc[j]);
        }
        const float rescale = NO_RESCALE ? 1.f : expf(m_run - c_max);
#pragma unroll
        for (int e = 0; e < VPL; ++e) acc[e] *= rescale;
        float p_sum = 0.f;
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          if ((bits >> j) & 1u) {
            const float p = expf(sc[j] - c_max);
            p_sum += p;
#pragma unroll
            for (int e = 0; e < VPL; ++e)
              acc[e] = fmaf(p, KV_SAME ? kx[j][e] : vx[KV_SAME ? 0 : j][e], acc[e]);
          }
        }
        l_run = l_run * rescale + p_sum;
        m_run = c_max;
      }
    }

    // merge the consumer warps' partial states in warp order; buffer qi & 1
    float* mb = merge + (qi & 1) * (2 * kConsumers + kConsumers * D);
    if (lane == 0) {
      mb[cw] = m_run;
      mb[kConsumers + cw] = l_run;
    }
    store_row<VPL>(mb + 2 * kConsumers + cw * D, lane, acc);
    consumers_sync();
    float mx = mb[0];
#pragma unroll
    for (int w = 1; w < kConsumers; ++w) mx = fmaxf(mx, mb[w]);
    float f[kConsumers], l = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      f[w] = expf(mb[w] - mx);
      l = fmaf(mb[kConsumers + w], f[w], l);
    }
    const float denom = l > 1e-8f ? l : 1.f;
    for (int col = t; col < D; col += 32 * kConsumers) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumers; ++w) o = fmaf(mb[2 * kConsumers + w * D + col], f[w], o);
      out[(size_t)row * D + col] = o / denom;
    }
  }
}

template <int VPL, bool KV_SAME, bool NO_RESCALE>
int launch(const float* q, const float* k, const float* v, const float* mask, float* out,
           int b, int m, float scale, cudaStream_t stream) {
  auto kernel = stream_attention_kernel<VPL, KV_SAME, NO_RESCALE>;
  constexpr int smem = Layout<32 * VPL, KV_SAME>::kBytes;
  // the persistent grid: CTAs an SM (registers and shared memory) x SMs
  static std::atomic<int> cache[bulk::kMaxDevices];
  int ctas = 0;
  const cudaError_t err = bulk::resident_ctas(kernel, kThreads, smem, cache, &ctas);
  if (err != cudaSuccess) return (int)err;
  kernel<<<min(b, ctas), kThreads, smem, stream>>>(q, k, v, mask, out, b, m, scale);
  return (int)cudaGetLastError();
}

template <int VPL, bool NO_RESCALE>
int launch_kv(const float* q, const float* k, const float* v, const float* mask, float* out,
              int b, int m, float scale, cudaStream_t stream) {
  return k == v ? launch<VPL, true, NO_RESCALE>(q, k, v, mask, out, b, m, scale, stream)
                : launch<VPL, false, NO_RESCALE>(q, k, v, mask, out, b, m, scale, stream);
}

}  // namespace

// mask may be null (every key valid); k == v (one tensor passed as both)
// copies each chunk once. Pointers 16-byte aligned (the wrapper checks
// them). variant 1 is the test-only NO_RESCALE instance (d = 128 only).
extern "C" int flash_neighbor_f32(const void* q, const void* k, const void* v,
                                  const void* mask, void* out, int b, int m, int d,
                                  float scale, int variant, void* stream) {
  const auto* Q = static_cast<const float*>(q);
  const auto* K = static_cast<const float*>(k);
  const auto* V = static_cast<const float*>(v);
  const auto* M = static_cast<const float*>(mask);
  auto* O = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (d != 128) return (int)cudaErrorInvalidValue;
    return launch_kv<4, true>(Q, K, V, M, O, b, m, scale, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_kv<1, false>(Q, K, V, M, O, b, m, scale, s);
    case 64: return launch_kv<2, false>(Q, K, V, M, O, b, m, scale, s);
    case 128: return launch_kv<4, false>(Q, K, V, M, O, b, m, scale, s);
    case 256: return launch_kv<8, false>(Q, K, V, M, O, b, m, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
