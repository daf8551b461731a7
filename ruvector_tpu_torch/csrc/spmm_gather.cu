// Gather-fused padded SpMM: out[i, :] = sum_m w[i, m] * feat[nbr[i, m], :].
//
// Replaces the TPU kernel ruvector_tpu/ops/pallas/spmm.py:34 spmm_pallas
// (kernel body :58-89). The weights already carry the mask (0 on padding).
// Layouts: feat [N, D] f32, nbr [B, M] int32, w [B, M] f32, out [B, D] f32;
// B (the rows of nbr) may differ from N. An index outside [0, N) adds
// nothing and its row is never read; the sum runs over m in order.
//
// What bounds it on an H100: bytes. 2 flops per gathered float. Counting
// each input once (feat, nbr, w) and the output once, the regular graph
// (N = B = 99,840, M = 16, D = 128) moves 115 MB: 0.034 ms at 3.35 TB/s.
// The gather itself reads one 512-byte feature row per edge, 1.6M rows or
// 818 MB: 0.24 ms from device memory. The first port's body (one warp a
// row, 8 rows a CTA) got its rows from L1 and L2 (benchmarks/k8_k9_torch.py
// on the H100: 0.068 ms on the regular graph, 0.114 with its node ids
// permuted, so that nothing is reused on chip). Near the bound only with
// the reuse caught on chip, explicitly:
//
// * A tile is R consecutive output rows, R = min(128, 2048 / M) (at least
//   1; a row of more than 2048 edges goes in batches of 2048). A batch's
//   indices and weights are staged in shared memory, each by one bulk copy
//   (cp.async.bulk on an mbarrier, csrc/bulk_async.cuh), or by the
//   producer warp's plain loads where the batch's words do not start on a
//   16-byte boundary or fill whole 16-byte lines (a ragged last tile, or
//   M % 4 != 0 with R M not a multiple of 4).
// * The batch's valid indices reduce to a window [lo, hi]. Where rows
//   lo..hi of feat fit kWindowBytes (64 KB: 128 rows at D = 128, a cluster
//   of the regular graph), one bulk copy brings them into shared memory
//   and every edge of the batch gathers from there ("staged"): feat is
//   read about once, and the 16 reads a row hit shared memory. Other
//   batches (random indices) gather from device memory with the indices
//   on chip. The choice is per batch, on the card;
//   `ops/kernels/spmm.staged_tiles` gives the same share from the indices.
// * Warp-specialised and persistent: one CTA an SM walks its tiles. A
//   producer warp stages batch i+2's indices and weights, turns batch
//   i+1's into the rows' byte offsets in the window (or rows of feat; -1
//   for an edge that adds nothing) and starts its window's copy, while 16
//   consumer warps gather batch i: a ring of three index lines and two
//   windows on mbarriers, no block-wide barrier after the start. 178 KB
//   of shared memory leaves L1 ~60 KB for the loads of the gathering
//   batches (with 80 KB windows, ~28 KB of L1 made them 11-15% slower).
// * A consumer warp owns rows of the batch in turn; lanes stride the
//   feature axis in float4s (D = 128: one a lane, each gathered row one
//   512-byte read). 16 / C edges (C float4s a lane) have their rows in
//   flight at once as predicated loads issued back to back, summed in
//   order of m; where M % 4 == 0 a row's offsets and weights are read four
//   at a time.
//
// A test-only instance (DROP_LAST, D = 128 only) leaves edge M - 1 of every
// row out of its sum: a fault the card tests and chip_smoke.py's controls
// must reject.

#include <climits>

#include <cuda_runtime.h>

#include "bulk_async.cuh"

namespace {

constexpr int kConsumers = 16;               // gathering warps; one more produces
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kTileEdges = 2048;             // a batch's indices and weights: 16 KB
constexpr int kMaxRows = 128;
constexpr int kWindowBytes = 64 * 1024;      // feature rows a batch may stage
constexpr int kWindows = 2;                  // window buffers: this batch, the next
constexpr int kLines = 3;                    // index lines: this batch and the next two
// a line's words: a batch and the vector reads of a row's last group
// past the batch's end (<= 15)
constexpr int kLineWords = kTileEdges + 16;
constexpr int kSmemBytes = kWindows * kWindowBytes + 2 * kLines * kLineWords * 4;
constexpr unsigned kFull = 0xffffffffu;

// Predicated 16-byte loads: zeros where pred is false. A run of them issues
// back to back, every row in flight before the first is used.
__device__ __forceinline__ float4 lds_if(uint32_t addr, bool pred) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p ld.shared.v4.f32 {%0, %1, %2, %3}, [%5];\n}\n"
      : "+f"(r.x), "+f"(r.y), "+f"(r.z), "+f"(r.w)
      : "r"((int)pred), "r"(addr)
      : "memory");
  return r;
}

__device__ __forceinline__ float4 ldg_if(const float4* p, bool pred) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%5];\n}\n"
      : "+f"(r.x), "+f"(r.y), "+f"(r.z), "+f"(r.w)
      : "r"((int)pred), "l"(static_cast<uint64_t>(__cvta_generic_to_global(p)))
      : "memory");
  return r;
}

// One row's edges kb..ke-1 into acc (row-local; edge kk's word and weight
// at off[kk - koff], w[kk - koff]). A word is the byte offset of the edge's
// row in the window at shared address `win` (STAGED) or its row of feat,
// -1 where the edge adds nothing. vec: M % 4 == 0, so a row's words start
// on a 16-byte boundary of the line and are read four at a time.
template <int C, bool STAGED>
__device__ __forceinline__ void gather_row(uint32_t win, const float4* feat4, const int* off,
                                           const float* w, bool vec, int kb, int ke, int koff,
                                           int d4, int lane, float4 (&acc)[C]) {
  constexpr int G = 16 / C;  // edges whose rows are in flight at once
  for (int k0 = kb; k0 < ke; k0 += G) {
    int o[G];
    float wt[G];
    if (vec) {
#pragma unroll
      for (int u = 0; u < G; u += 4) {
        const int4 ov = *reinterpret_cast<const int4*>(off + k0 + u - koff);
        const float4 wv = *reinterpret_cast<const float4*>(w + k0 + u - koff);
        o[u] = ov.x, o[u + 1] = ov.y, o[u + 2] = ov.z, o[u + 3] = ov.w;
        wt[u] = wv.x, wt[u + 1] = wv.y, wt[u + 2] = wv.z, wt[u + 3] = wv.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int kk = min(k0 + u, ke - 1);
        o[u] = off[kk - koff];
        wt[u] = w[kk - koff];
      }
    }
    bool ok[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {  // a slot past ke is another row's: masked
      ok[u] = k0 + u < ke && o[u] >= 0;
      wt[u] = ok[u] ? wt[u] : 0.f;
    }
    float4 x[G][C];
#pragma unroll
    for (int u = 0; u < G; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = c * 32 + lane;
        if constexpr (STAGED)
          x[u][c] = lds_if(win + o[u] + col * 16, ok[u] && col < d4);
        else
          x[u][c] = ldg_if(feat4 + (size_t)max(o[u], 0) * d4 + col, ok[u] && col < d4);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
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

// A CTA's work is a sequence of batches: its tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ... (R rows each), each tile's edges (flattened
// rows) in batches of at most kTileEdges, one a tile unless M > kTileEdges.
struct Batch {
  int tile;
  long long e0, end;  // the batch's first edge, the tile's end
  __device__ bool valid() const { return e0 < end; }
  __device__ int size() const { return (int)min((long long)kTileEdges, end - e0); }
};

__device__ __forceinline__ Batch tile_batch(int tile, int b, int m, int rows) {
  const long long r0 = (long long)tile * rows;
  return {tile, r0 * m, tile < (b + rows - 1) / rows ? min((long long)b, r0 + rows) * m : 0};
}

__device__ __forceinline__ Batch next_batch(const Batch& t, int b, int m, int rows) {
  if (t.e0 + kTileEdges < t.end) return {t.tile, t.e0 + kTileEdges, t.end};
  return tile_batch(t.tile + gridDim.x, b, m, rows);
}

template <int C, bool DROP_LAST>  // C: float4 chunks a lane, D <= 128 C
__global__ void __launch_bounds__(kThreads, 1)
spmm_tile_kernel(const float* __restrict__ feat, const int* __restrict__ nbr,
                 const float* __restrict__ w, float* __restrict__ out, int n, int b, int m,
                 int d4, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* windows = reinterpret_cast<float4*>(smem);
  uint32_t* idx_lines = reinterpret_cast<uint32_t*>(smem + kWindows * kWindowBytes);
  uint32_t* w_lines = idx_lines + kLines * kLineWords;
  // line_full: a batch's words are in (the producer waits); ready: its
  // words are offsets and its window is in (the consumers wait); the
  // empties: every consumer warp is done with a line or a window
  __shared__ uint64_t line_full[kLines], line_empty[kLines], ready[kWindows],
      win_empty[kWindows];
  __shared__ int staged_flag[kWindows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* feat4 = reinterpret_cast<const float4*>(feat);
  float4* out4 = reinterpret_cast<float4*>(out);
  constexpr int kWinFloat4s = kWindowBytes / 16;

  if (m == 0) {  // empty sums
    for (int t = blockIdx.x; t < (b + rows - 1) / rows; t += gridDim.x)
      for (int row = t * rows + warp; row < min(b, (t + 1) * rows); row += kConsumers + 1)
        for (int col = lane; col < d4; col += 32)
          out4[(size_t)row * d4 + col] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  if (threadIdx.x == 0) {
    for (int l = 0; l < kLines; ++l) {
      bulk::mbar_init(&line_full[l], 1);
      bulk::mbar_init(&line_empty[l], kConsumers);
    }
    for (int v = 0; v < kWindows; ++v) {
      bulk::mbar_init(&ready[v], 1);
      bulk::mbar_init(&win_empty[v], kConsumers);
    }
    bulk::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer
    // batch i's indices and weights into line i % 3 (one bulk copy each,
    // or the warp's plain loads)
    auto stage = [&](const Batch& t, int i) {
      const int l = i % kLines;
      bulk::mbar_wait(&line_empty[l], ((i / kLines) & 1) ^ 1);
      bulk::stage_words(idx_lines + l * kLineWords, reinterpret_cast<const uint32_t*>(nbr + t.e0),
                        t.size(), &line_full[l], lane);
      bulk::stage_words(w_lines + l * kLineWords, reinterpret_cast<const uint32_t*>(w + t.e0),
                        t.size(), &line_full[l], lane);
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive(&line_full[l]);
    };
    Batch t = tile_batch(blockIdx.x, b, m, rows);
    Batch t2 = t.valid() ? next_batch(t, b, m, rows) : t;  // two batches on
    if (t.valid()) stage(t, 0);
    if (t2.valid()) stage(t2, 1);
    for (int i = 0; t.valid(); ++i) {
      const int l = i % kLines, v = i % kWindows, ne = t.size();
      bulk::mbar_wait(&line_full[l], (i / kLines) & 1);
      // the window of the batch's valid indices (an index out of range
      // neither widens it nor is read)
      int* word = reinterpret_cast<int*>(idx_lines + l * kLineWords);
      int lo = INT_MAX, hi = -1;
      for (int e = lane; e < ne; e += 32) {
        const int j = word[e];
        if (j >= 0 && j < n) {
          lo = min(lo, j);
          hi = max(hi, j);
        }
      }
      lo = __reduce_min_sync(kFull, lo);
      hi = __reduce_max_sync(kFull, hi);
      const bool staged = hi >= lo && (long long)(hi - lo + 1) * d4 * 16 <= kWindowBytes;
      // each word becomes its row's byte offset in the window, or its row
      // of feat, or -1 (out of range; DROP_LAST: edge M - 1 of a row)
      for (int e = lane; e < ne; e += 32) {
        const int j = word[e];
        bool ok = j >= 0 && j < n;
        if (DROP_LAST) ok = ok && (t.e0 + e) % m != m - 1;
        word[e] = !ok ? -1 : staged ? (j - lo) * d4 * 16 : j;
      }
      __syncwarp();
      bulk::mbar_wait(&win_empty[v], ((i / kWindows) & 1) ^ 1);
      if (lane == 0) {
        staged_flag[v] = staged;
        if (staged) {
          const uint32_t bytes = (uint32_t)(hi - lo + 1) * d4 * 16;
          bulk::mbar_arrive_expect_tx(&ready[v], bytes);
          bulk::bulk_copy_g2s(windows + v * kWinFloat4s, feat4 + (size_t)lo * d4, bytes,
                              &ready[v]);
        } else {
          bulk::mbar_arrive(&ready[v]);
        }
      }
      const Batch t3 = t2.valid() ? next_batch(t2, b, m, rows) : t2;
      if (t3.valid()) stage(t3, i + 2);
      t = t2;
      t2 = t3;
    }
    return;
  }

  // the consumers: a warp owns rows of a batch in turn; a row longer than
  // a batch (R = 1) stays with warp 0, its sum carried over batches
  float4 acc[C];
  int i = 0;
  for (Batch t = tile_batch(blockIdx.x, b, m, rows); t.valid();
       t = next_batch(t, b, m, rows), ++i) {
    const int l = i % kLines, v = i % kWindows, ne = t.size();
    bulk::mbar_wait(&ready[v], (i / kWindows) & 1);
    const bool staged = staged_flag[v] != 0;
    const int* off = reinterpret_cast<const int*>(idx_lines + l * kLineWords);
    const float* wt = reinterpret_cast<const float*>(w_lines + l * kLineWords);
    const bool vec = m % 4 == 0;
    const uint32_t win = bulk::smem_addr(windows + v * kWinFloat4s);
    const int rb = (int)(t.e0 / m), re = (int)((t.e0 + ne - 1) / m);
    for (int row = rb + warp; row <= re; row += kConsumers) {
      const long long rs = (long long)row * m;
      const int koff = (int)(t.e0 - rs);
      const int kb = koff > 0 ? koff : 0;
      const int ke = (int)min((long long)m, t.e0 + ne - rs);
      if (kb == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (staged)
        gather_row<C, true>(win, feat4, off, wt, vec, kb, ke, koff, d4, lane, acc);
      else
        gather_row<C, false>(win, feat4, off, wt, vec, kb, ke, koff, d4, lane, acc);
      if (ke == m) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = c * 32 + lane;
          if (col < d4) out4[(size_t)row * d4 + col] = acc[c];
        }
      }
    }
    __syncwarp();
    if (lane == 0) {
      bulk::mbar_arrive(&line_empty[l]);
      bulk::mbar_arrive(&win_empty[v]);
    }
  }
}

// Rows a tile: as many as 2048 edges hold, 1..128.
int rows_per_tile(int m) {
  return m <= 0 ? kMaxRows : max(1, min(kMaxRows, kTileEdges / m));
}

template <int C, bool DROP_LAST>
int launch(const float* feat, const int* nbr, const float* w, float* out, int n, int b, int m,
           int d, cudaStream_t stream) {
  auto kernel = spmm_tile_kernel<C, DROP_LAST>;
  static std::atomic<int> cache[bulk::kMaxDevices];  // the persistent grid: one CTA an SM
  int ctas = 0;
  const cudaError_t err = bulk::resident_ctas(kernel, kThreads, kSmemBytes, cache, &ctas);
  if (err != cudaSuccess) return (int)err;
  const int rows = rows_per_tile(m);
  const int tiles = (b + rows - 1) / rows;
  kernel<<<min(tiles, ctas), kThreads, kSmemBytes, stream>>>(feat, nbr, w, out, n, b, m, d / 4,
                                                             rows);
  return (int)cudaGetLastError();
}

}  // namespace

// d must be a multiple of 4 and at most 512; feat 16-byte aligned (the
// wrapper checks both), nbr and w any 4-byte alignment. variant 1 is the
// test-only DROP_LAST instance (d = 128 only).
extern "C" int spmm_gather_f32(const void* feat, const void* nbr, const void* w, void* out,
                               int n, int b, int m, int d, int variant, void* stream) {
  const auto* F = static_cast<const float*>(feat);
  const auto* I = static_cast<const int*>(nbr);
  const auto* W = static_cast<const float*>(w);
  auto* O = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (d % 4 != 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (d != 128) return (int)cudaErrorInvalidValue;
    return launch<1, true>(F, I, W, O, n, b, m, d, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const int chunks = (d / 4 + 31) / 32;
  switch (chunks) {
    case 1: return launch<1, false>(F, I, W, O, n, b, m, d, s);
    case 2: return launch<2, false>(F, I, W, O, n, b, m, d, s);
    case 3: case 4: return launch<4, false>(F, I, W, O, n, b, m, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The rows of a tile for m edges a row (ops/kernels/spmm.py mirrors it).
extern "C" int spmm_gather_rows_per_tile(int m) { return rows_per_tile(m); }

extern "C" const char* rvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
