// Batched min-cut gate per partition (K7): pooled logits, push-relabel
// max flow, canonical minimal-source-side cut, bit-packed keep mask.
//
// Replaces ruvector_tpu/ops/pallas/mincut_gate_block.py:234
// mincut_gate_block_from_x (kernel :48-230). Per partition of B nodes:
//   X  = LN1(x) (rounded to bf16 in bf16 compute mode) or x itself;
//   lg = (X A_sig) X^T in float32 (float32 A_sig, no rounding of the
//        products; the sums taken in float64 and rounded once, so the
//        plain version's float64 matmuls give the same bits),
//        clamped = lg where valid and lg > eps, else 0;
//   a synchronous push-relabel max flow from s = 0 to t = B-1 on the
//   clamped capacities: saturate the source, exact global relabel (two
//   backward BFSs) at the start and every 8 rounds; each round pushes
//   every active node's excess along its admissible edges in column
//   order with heights frozen, applies r -= push, r += push^T after a
//   barrier, then relabels against the updated residual; the loop stops
//   when no node is active, at the round cap 4 B^2 + 8, or as soon as the
//   flow into t exceeds lam * mean positive logit (the cut can then not
//   apply);
//   the cut: s-reachability in the residual; applied (crossing kept edges
//   dropped) only if flow <= threshold, there is a positive logit and the
//   loop did not stop at the cap.
// Outputs the keep words (row i in word i/32 at bit i%32) and stats rows
// 0..3 = cut cost (0 if not applied), flow, applied, rounds.
//
// What bounds it on an H100: the logits are 2 B D (B + D) exact products
// per partition (9.8e10 at config 5's init shape), whose float64 sums
// the float64 tensor cores run at 67 TFLOP/s; each push-relabel round is
// ~10 B^2 element operations over the [B, B] residual, and the rounds
// depend on the data. The residual is 256 KB at B=256, above the 227 KB
// a block may use, so it lives in the block's slice of a global scratch
// buffer (L2-resident) with the push matrix and the clamped logits; the
// push rounds' passes over it are bound by L2 bandwidth and by the block
// barriers between the phases of a round.
//
// Design: a persistent grid of 256-thread blocks that take partitions
// from an atomic counter, so a slow partition does not hold back the
// ones queued behind it on its block; the scratch is per block, so the
// results do not depend on which block solves a partition. The logits
// (bf16 compute with LN1 folded in, B <= 256) run on the float64 tensor
// cores (gated_f64tc.cuh): the bf16 rows X and A_sig^T (float32) in
// shared memory, each warp a 16-row strip whose float32 QS = X A_sig
// stays in shared memory for C = QS X^T; otherwise block_gemm with float64
// sums. The graph searches never read the float residual: the bits
// R[u][v] > kTiny are kept in shared memory, B/32 words per row (8 KB at
// B=256), rewritten in the same passes that write R; the global
// relabel's BFSs and the cut's reachability run frontier by frontier on
// words, and the relabel phase reads bits and heights. The searches give
// the exact distances of a fixpoint, so heights, rounds and pushes do
// not depend on the search order. The push pass is one warp per row (its
// prefix sum a warp scan over 32-column chunks with a carried total, the
// row's loads issued together). The apply pass, r += push^T, walks R in
// 32x32 tiles per warp and reads P^T's block through a shared tile
// (coalesced rows instead of a strided column); each lane sums its
// column of P in the order v = 0, 1, ... as it goes, so there are no
// float atomics and runs repeat bit for bit.
// Push amounts may differ from the plain version's in the last bits (the
// prefix sum associates differently); the max flow value and the
// canonical cut, and so the masks, do not.

#include "gated_f64tc.cuh"

namespace {

using namespace rvt;

constexpr float kTiny = 1e-12f;
constexpr int kRelabelEvery = 8;
constexpr int kMaxW = kMaxB / 32;  // adjacency words of a row
constexpr uint32_t kAll = 0xffffffffu;
constexpr int kTileLd = 33;        // leading dimension of a warp's transpose tile

struct GateArgs {
  const void* x;        // [K, B, D] float32 or bf16
  const float* pad;     // [K, B]
  const float* A_sig;   // [D, D] float32
  const float* gamma;   // [D] or null (no LN)
  const float* beta;
  int32_t* keep;        // [K, B/32, B]
  float* stats;         // [K, 8, B]
  float* scratch;       // grid x (3 B B, + 2 B D for block_gemm's logits)
  long long* probe;     // [K, kPhases] phase cycles (the probe variant), else null
  int* counter;         // partitions taken, 0 at launch
  int k, b, d;
  float lam, eps;
};

// The instance's test-only variants: the probe records each partition's
// phase cycles; kReachOne (a fault) stops the cut's reachability after
// its first frontier.
enum Variant { kExact = 0, kProbe = 1, kReachOne = 2 };

struct alignas(16) FlowSmem {  // 16-byte aligned: the arrays after it take vector loads
  float pad[kMaxB];
  float e[kMaxB];       // excess
  float rs[kMaxB];      // row sums of this round's pushes
  int h[kMaxB];         // heights
  int hn[kMaxB];        // relabelled heights
  int act[kMaxB];       // active at the start of the round
  int dist[kMaxB];      // BFS distances (global relabel)
  int dist_s[kMaxB];
  float red[kThreads];  // block reductions
  float red2[kThreads];
  uint32_t fr[2][kMaxW];  // BFS frontiers
  uint32_t seen[kMaxW];   // the cut's source side
  int next;               // the partition this block took
};

// The probe's phases: cycles (clock64 on thread 0, each phase ending at a
// barrier) of LN and logits, init with the first global relabel, the push
// rounds, the later global relabels, the cut and the keep words; the
// relabels' BFS sweeps and the cut's; then the push rounds' parts: the
// push pass, the apply pass with the column sums, the relabel phase.
enum Phase { kPhLogits, kPhInit, kPhRounds, kPhRelabel, kPhCut, kPhKeep, kPhSweeps,
             kPhCutSweeps, kPhPush, kPhApply, kPhHeights, kPhases };

struct Probe {
  long long acc[kPhases] = {};
  long long t0 = 0, ts = 0;  // the phase's start, the part's start
  __device__ void start() { t0 = ts = clock64(); }
  __device__ void lap(int phase) {
    const long long t = clock64();
    acc[phase] += t - t0;
    t0 = ts = t;
  }
  __device__ void part(int phase) {  // a part of the current phase
    const long long t = clock64();
    acc[phase] += t - ts;
    ts = t;
  }
};

// adjacency row stride in words: B/32 + 1, so that threads on consecutive
// rows read different banks
__host__ __device__ constexpr int adj_stride(int n) { return n / 32 + 1; }

// Shared memory behind FlowSmem: A_sig^T (float32, the tensor-core body's,
// staged once per block), then a region the logits use (X and the warps'
// QS strips, or block_gemm's tiles) and the flow reuses for the
// adjacency bits and the warps' 32 x 32 transpose tiles.
__host__ __device__ constexpr size_t adj_bytes(int n) {
  return ((size_t)n * adj_stride(n) * sizeof(uint32_t) + 15) / 16 * 16;
}

template <int TC_D>
constexpr size_t gate_smem(int n) {
  const size_t adj = adj_bytes(n) + (size_t)kWarps * 32 * kTileLd * sizeof(float);
  const size_t logits = TC_D ? (size_t)n * TC_D * sizeof(bf16) +
                                   (size_t)kWarps * 16 * TC_D * sizeof(float)
                             : sizeof(GemmSmem);
  return sizeof(FlowSmem) + (size_t)TC_D * TC_D * sizeof(float) +
         (adj > logits ? adj : logits);
}

// block-wide sums of two per-thread values, in a fixed order
__device__ void block_sum2(float& a, float& b, FlowSmem& sm) {
  sm.red[threadIdx.x] = a;
  sm.red2[threadIdx.x] = b;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sm.red[threadIdx.x] += sm.red[threadIdx.x + s];
      sm.red2[threadIdx.x] += sm.red2[threadIdx.x + s];
    }
    __syncthreads();
  }
  a = sm.red[0];
  b = sm.red2[0];
  __syncthreads();
}

__device__ __forceinline__ bool bit_of(const uint32_t* words, int v) {
  return (words[v >> 5] >> (v & 31)) & 1u;
}

// R[u n + v] = r, v in a 32-aligned chunk held by one warp (n % 32 == 0,
// every lane on the same row u), and the bit of r > kTiny in the
// adjacency word of (u, v / 32).
__device__ __forceinline__ void store_residual(float* R, uint32_t* adj, int u, int v, int n,
                                               int ws, float r) {
  R[u * n + v] = r;
  const uint32_t word = __ballot_sync(kAll, r > kTiny);
  if ((threadIdx.x & 31) == 0) adj[u * ws + v / 32] = word;
}

// Backward BFS distances to `target` over residual edges u -> v (bits of
// adj): d[target] = 0, d[u] = 1 + min over residual v of d[v], inf = 4B
// for nodes that cannot reach it. Frontier by frontier: u joins level L
// when one of its edges leads into level L - 1. Returns the sweeps.
__device__ int bfs_to(const uint32_t* adj, int n, int target, int* d, FlowSmem& sm) {
  const int lane = threadIdx.x & 31, w_n = n / 32, ws = adj_stride(n), inf = 4 * n;
  for (int v = threadIdx.x; v < n; v += kThreads) d[v] = v == target ? 0 : inf;
  for (int w = threadIdx.x; w < w_n; w += kThreads)
    sm.fr[0][w] = w == target / 32 ? 1u << (target & 31) : 0u;
  __syncthreads();
  int cur = 0, level = 0;
  while (true) {
    ++level;
    int any = 0;
    for (int u = threadIdx.x; u < n; u += kThreads) {  // whole warps: n % 32 == 0
      bool hit = false;
      if (d[u] == inf) {
        const uint32_t* au = adj + (size_t)u * ws;
        uint32_t m = 0;
        for (int w = 0; w < w_n; ++w) m |= au[w] & sm.fr[cur][w];
        hit = m != 0;
      }
      if (hit) d[u] = level;
      const uint32_t word = __ballot_sync(kAll, hit);
      if (lane == 0) sm.fr[cur ^ 1][u >> 5] = word;
      any |= hit;
    }
    if (!__syncthreads_or(any)) break;
    cur ^= 1;
  }
  return level;
}

// Exact distance labels (mincut_device._global_relabel): h[v] = dist to
// t, or n + min(dist to s, n) for nodes cut off from t; h[s] = n; never
// lowered. Returns the BFS sweeps.
__device__ int global_relabel(const uint32_t* adj, int n, FlowSmem& sm) {
  const int inf = 4 * n, t = n - 1;
  const int sweeps = bfs_to(adj, n, t, sm.dist, sm) + bfs_to(adj, n, 0, sm.dist_s, sm);
  for (int v = threadIdx.x; v < n; v += kThreads) {
    int hv = sm.dist[v] < inf ? sm.dist[v] : n + min(sm.dist_s[v], n);
    if (v == 0) hv = n;
    sm.h[v] = max(sm.h[v], hv);
  }
  __syncthreads();
  return sweeps;
}

// The clamped logits C [n, n] of the tensor-core body: LN1(x) rounded to
// bf16 into X in shared memory, then per warp 16-row strips: QS = X A_sig
// (float64 sums, rounded once to float32, kept in the warp's shared
// strip) and C = QS X^T in 32-column passes, clamped as they leave the
// registers. At (float32 [D, D]) = A_sig^T.
template <int D, typename XT>
__device__ void tc_logits(const XT* xk, const GateArgs& a, const float* At, bf16* X,
                          float* QSw, const float* pad, int n, float* C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  ln_rows_bf16<D>(xk, X, a.gamma, a.beta, n, n, 1e-5f);
  double acc[1][4][4];  // 4 tiles of 16x8: rows r0 + 8 h + g
  for (int s = warp; s < n / 16; s += kWarps) {
    const int r0 = 16 * s;
    for (int n0 = 0; n0 < D; n0 += 32) {
      zero_tiles(acc);
      f64_mma_tiles<1, 4>(acc, X + (size_t)r0 * D, D, At + (size_t)n0 * D, D, D);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(QSw + (8 * h + g) * D + n0 + 8 * j + 2 * t) =
              make_float2((float)acc[0][j][2 * h], (float)acc[0][j][2 * h + 1]);
    }
    __syncwarp();
    for (int c0 = 0; c0 < n; c0 += 32) {
      zero_tiles(acc);
      f64_mma_tiles<1, 4>(acc, QSw, D, X + (size_t)c0 * D, D, D);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h + g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lg = (float)acc[0][j][2 * h + e];
            v[e] = pad[r] > 0.f && pad[c + e] > 0.f && lg > a.eps ? lg : 0.f;
          }
          *reinterpret_cast<float2*>(C + (size_t)r * n + c) = make_float2(v[0], v[1]);
        }
      }
    }
    __syncwarp();  // the strip's QS is read before the next strip's is written
  }
  __syncthreads();
}

template <typename XT, bool BF16, int TC_D, int V>
__global__ void __launch_bounds__(kThreads) gate_kernel(const GateArgs a) {
  extern __shared__ uint4 smem_raw[];
  FlowSmem& sm = *reinterpret_cast<FlowSmem*>(smem_raw);
  float* At = reinterpret_cast<float*>(&sm + 1);        // [TC_D, TC_D]
  unsigned char* region = reinterpret_cast<unsigned char*>(At + TC_D * TC_D);
  const int n = a.b, d = a.d, t = n - 1, words = n / 32, ws = adj_stride(n);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // after the logits: the adjacency bits [n, ws] and the warp's transpose tile
  uint32_t* adj = reinterpret_cast<uint32_t*>(region);
  float* T = reinterpret_cast<float*>(region + adj_bytes(n)) + warp * 32 * kTileLd;
  const size_t nn = (size_t)n * n;
  float* C = a.scratch + (size_t)blockIdx.x * (3 * nn + (TC_D ? 0 : 2 * (size_t)n * d));
  float* R = C + nn;               // residual
  float* P = R + nn;               // this round's pushes
  float* X = P + nn;               // block_gemm's logits: X, QS [n, d]
  float* QS = X + (size_t)n * d;
  const int rounds_cap = 4 * n * n + 8;
  const int two_n = 2 * n;
  if constexpr (TC_D > 0) {
    for (int i = tid; i < TC_D * TC_D; i += kThreads)
      At[i] = a.A_sig[(size_t)(i % TC_D) * TC_D + i / TC_D];
  }

  while (true) {
    __syncthreads();  // the previous partition's shared state is no longer read
    if (tid == 0) sm.next = atomicAdd(a.counter, 1);
    __syncthreads();
    const int k = sm.next;
    if (k >= a.k) break;
    const XT* xk = static_cast<const XT*>(a.x) + (size_t)k * n * d;
    Probe pr;
    if (V == kProbe) pr.start();
    for (int i = tid; i < n; i += kThreads) sm.pad[i] = a.pad[(size_t)k * n + i];
    __syncthreads();

    // --- pooled logits, clamped ---
    if constexpr (TC_D > 0) {
      tc_logits<TC_D>(xk, a, At, reinterpret_cast<bf16*>(region),
                      reinterpret_cast<float*>(region + (size_t)n * TC_D * sizeof(bf16)) +
                          warp * 16 * TC_D,
                      sm.pad, n, C);
    } else {
      GemmSmem& gs = *reinterpret_cast<GemmSmem*>(region);
      if (a.gamma != nullptr) {
        layer_norm_rows<BF16>(xk, X, a.gamma, a.beta, n, d, 1e-5f);
      } else {
        for (size_t i = tid; i < (size_t)n * d; i += kThreads) X[i] = ldf(xk + i);
        __syncthreads();
      }
      block_gemm<false, false, double>(X, d, a.A_sig, d, n, d, d, gs,
                                       [&](int m, int c, float v) { QS[(size_t)m * d + c] = v; });
      block_gemm<false, true, double>(QS, d, X, d, n, n, d, gs, [&](int m, int c, float v) {
        const bool ok = sm.pad[m] > 0.f && sm.pad[c] > 0.f && v > a.eps;
        C[(size_t)m * n + c] = ok ? v : 0.f;
      });
    }
    float csum = 0.f, npos = 0.f;
    for (size_t i = tid; i < nn; i += kThreads) {
      const float v = C[i];
      csum += v;
      npos += v > 0.f ? 1.f : 0.f;
    }
    block_sum2(csum, npos, sm);
    const float threshold = a.lam * (csum / fmaxf(npos, 1.f));
    if (V == kProbe) pr.lap(kPhLogits);

    // --- init: saturate the source ---
    for (int i = tid; i < n * n; i += kThreads) {
      const int u = i / n, v = i - u * n;
      store_residual(R, adj, u, v, n, ws, (u == 0 ? 0.f : C[i]) + (v == 0 ? C[u] : 0.f));
    }
    for (int v = tid; v < n; v += kThreads) {
      sm.h[v] = v == 0 ? n : 0;
      sm.e[v] = v == 0 ? 0.f : C[v];
    }
    __syncthreads();
    const int sweeps0 = global_relabel(adj, n, sm);
    if (V == kProbe) {
      pr.lap(kPhInit);
      pr.acc[kPhSweeps] += sweeps0;
    }

    // --- push-relabel rounds ---
    int rounds = 0;
    while (true) {
      int any = 0;
      for (int u = tid; u < n; u += kThreads) {
        const int on = sm.e[u] > kTiny && u != 0 && u != t && sm.h[u] < two_n;
        sm.act[u] = on;
        any |= on;
      }
      any = __syncthreads_or(any);
      if (!(any && rounds < rounds_cap && sm.e[t] <= threshold)) break;

      // push phase, heights frozen: row u fills its admissible edges in
      // column order with its excess (the row's loads issued together)
      for (int u = warp; u < n; u += kWarps) {
        if (!sm.act[u]) continue;
        const float* ru = R + (size_t)u * n;
        float* pu = P + (size_t)u * n;
        const int hu = sm.h[u];
        const float eu = sm.e[u];
        float row[kMaxW];
#pragma unroll
        for (int w = 0; w < kMaxW; ++w)
          if (w < words) row[w] = ru[32 * w + lane];
        float carry = 0.f, rsum = 0.f;
#pragma unroll
        for (int w = 0; w < kMaxW; ++w) {
          if (w >= words) break;
          const int v = 32 * w + lane;
          const float r = row[w];
          const float ra = (r > kTiny && hu == sm.h[v] + 1) ? r : 0.f;
          float cum = ra;  // inclusive warp scan
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float up = __shfl_up_sync(kAll, cum, o);
            if (lane >= o) cum += up;
          }
          cum += carry;
          const float push = fminf(fmaxf(eu - (cum - ra), 0.f), ra);
          pu[v] = push;
          rsum += push;
          carry = __shfl_sync(kAll, cum, 31);
        }
        rsum = warp_sum(rsum);
        if (lane == 0) sm.rs[u] = rsum;
      }
      __syncthreads();
      if (V == kProbe) pr.part(kPhPush);
      // apply: r -= push, r += push^T (and the adjacency bits), and the
      // excess e - row sum + column sum. One warp per 32-row block ub of R
      // walks its 32x32 tiles vb = 0, 1, ... in order: it reads the rows v
      // of the tile's P^T block coalesced (lane l holding P[v][32 ub + l]),
      // sums them into column 32 ub + l's sum in the order v = 0, 1, ...,
      // and passes them through its shared tile T, so that the row-major
      // update of R reads P[v][u] from T instead of from a strided column.
      for (int ub = warp; ub < words; ub += kWarps) {
        const int u_l = 32 * ub + lane;
        float cs = 0.f;
        for (int vb = 0; vb < words; ++vb) {
          float pv[32];
#pragma unroll
          for (int c = 0; c < 32; ++c) {
            const int v = 32 * vb + c;
            pv[c] = sm.act[v] ? P[v * n + u_l] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 32; ++c) {
            if (sm.act[32 * vb + c]) cs += pv[c];
            T[c * kTileLd + lane] = pv[c];
          }
          __syncwarp();
          const int v = 32 * vb + lane;
          const bool act_v = sm.act[v];
          float rr[32], pp[32];  // the tile's rows of R and P, loaded together
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int u = 32 * ub + j;
            rr[j] = R[u * n + v];
            pp[j] = sm.act[u] ? P[u * n + v] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int u = 32 * ub + j;
            float r = rr[j];
            if (sm.act[u]) r -= pp[j];
            if (act_v) r += T[lane * kTileLd + j];
            store_residual(R, adj, u, v, n, ws, r);
          }
          __syncwarp();  // T is read before the next tile's is written
        }
        sm.e[u_l] = (sm.e[u_l] - (sm.act[u_l] ? sm.rs[u_l] : 0.f)) + cs;
      }
      __syncthreads();
      if (V == kProbe) pr.part(kPhApply);
      // relabel phase against the updated residual's bits
      for (int u = warp; u < n; u += kWarps) {
        const int hu = sm.h[u];
        const bool on = sm.e[u] > kTiny && u != 0 && u != t && hu < two_n;
        int lift = two_n + 1, adm = 0;
        if (on) {
          const uint32_t* au = adj + (size_t)u * ws;
          for (int w = 0; w < words; ++w) {
            if ((au[w] >> lane) & 1u) {
              const int hv = sm.h[32 * w + lane];
              lift = min(lift, hv);
              adm |= hu == hv + 1;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) lift = min(lift, __shfl_xor_sync(kAll, lift, o));
          adm = __any_sync(kAll, adm);
        }
        if (lane == 0) sm.hn[u] = (on && !adm) ? max(hu, lift + 1) : hu;
      }
      __syncthreads();
      for (int u = tid; u < n; u += kThreads) sm.h[u] = sm.hn[u];
      __syncthreads();
      if (V == kProbe) {
        pr.part(kPhHeights);
        pr.lap(kPhRounds);
      }
      if ((rounds + 1) % kRelabelEvery == 0) {
        const int sw = global_relabel(adj, n, sm);
        if (V == kProbe) {
          pr.lap(kPhRelabel);
          pr.acc[kPhSweeps] += sw;
        }
      }
      ++rounds;
    }
    if (V == kProbe) pr.lap(kPhRounds);
    const float flow = sm.e[t];
    int still = 0;
    for (int u = tid; u < n; u += kThreads)
      still |= sm.e[u] > kTiny && u != 0 && u != t && sm.h[u] < two_n;
    const bool capped = __syncthreads_or(still) && flow <= threshold;

    // --- canonical cut: s-reachability in the residual, frontier by
    // frontier: the next frontier is the union of the frontier's rows
    // outside what is already reached ---
    for (int w = tid; w < words; w += kThreads) sm.seen[w] = sm.fr[0][w] = w == 0 ? 1u : 0u;
    int cur = 0;
    while (true) {
      __syncthreads();
      for (int w = tid; w < words; w += kThreads) sm.fr[cur ^ 1][w] = 0u;
      __syncthreads();
      for (int i = tid; i < n * words; i += kThreads) {
        const int u = i / words, w = i % words;
        if (bit_of(sm.fr[cur], u)) {
          const uint32_t m = adj[(size_t)u * ws + w];
          if (m) atomicOr(&sm.fr[cur ^ 1][w], m);
        }
      }
      __syncthreads();
      int grew = 0;
      for (int w = tid; w < words; w += kThreads) {
        const uint32_t nf = sm.fr[cur ^ 1][w] & ~sm.seen[w];
        sm.fr[cur ^ 1][w] = nf;
        sm.seen[w] |= nf;
        grew |= nf != 0u;
      }
      if (V == kProbe) ++pr.acc[kPhCutSweeps];
      grew = __syncthreads_or(grew);
      if (V == kReachOne || !grew) break;
      cur ^= 1;
    }
    float cost = 0.f, unused = 0.f;
    for (int i = tid; i < n * n; i += kThreads) {
      const int u = i / n, v = i - u * n;
      if (bit_of(sm.seen, u) && !bit_of(sm.seen, v) && C[i] > 0.f) cost += C[i];
    }
    block_sum2(cost, unused, sm);
    if (V == kProbe) pr.lap(kPhCut);
    const bool applied = flow <= threshold && npos > 0.f && !capped;

    // --- bit-packed keep and stats ---
    int32_t* keepk = a.keep + (size_t)k * words * n;
    for (int i = tid; i < words * n; i += kThreads) {
      const int w = i / n, j = i % n;
      const bool j_reached = bit_of(sm.seen, j);
      uint32_t word = 0;
      for (int bit = 0; bit < 32; ++bit) {
        const int r = w * 32 + bit;
        const bool pos = C[(size_t)r * n + j] > 0.f;
        const bool cross = bit_of(sm.seen, r) && !j_reached;
        const bool kept = npos > 0.f && pos && !(applied && cross);
        word |= (uint32_t)kept << bit;
      }
      keepk[i] = (int32_t)word;
    }
    float* st = a.stats + (size_t)k * 8 * n;
    for (int i = tid; i < 8 * n; i += kThreads) {
      const int row = i / n;
      float v = 0.f;
      if (row == 0) v = applied ? cost : 0.f;
      else if (row == 1) v = flow;
      else if (row == 2) v = applied ? 1.f : 0.f;
      else if (row == 3) v = (float)rounds;
      st[i] = v;
    }
    if (V == kProbe) {
      __syncthreads();
      pr.lap(kPhKeep);
      if (tid == 0)
        for (int ph = 0; ph < kPhases; ++ph) a.probe[(size_t)k * kPhases + ph] = pr.acc[ph];
    }
  }
}

template <typename XT, bool BF16, int TC_D = 0, int V = kExact>
int run(const GateArgs& a, int grid, cudaStream_t s) {
  auto kernel = gate_kernel<XT, BF16, TC_D, V>;
  const size_t smem = gate_smem<TC_D>(a.b);
  if (const int rc = allow_smem(kernel, smem)) return rc;
  const int g = resident_grid(kernel, grid, smem);
  kernel<<<g, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename XT>
int run_tc(const GateArgs& a, int grid, cudaStream_t s) {
  if (a.d == 32) return run<XT, true, 32>(a, grid, s);
  if (a.d == 64) return run<XT, true, 64>(a, grid, s);
  return run<XT, true, 128>(a, grid, s);
}

}  // namespace

// K7. tensor_core (bf16 compute with LN1 folded in, b <= 256) takes the
// float64 tensor-core logits, else block_gemm's (then scratch holds
// 2 b d more floats a block); counter is one int, 0 at launch. variant 1
// (the probe, which fills probe [k, kPhases]) and 2 (the reachability fault)
// are built for the tensor-core body at D = 128 on float32 x only.
extern "C" int mincut_gate_block_from_x(const void* x, const void* pad, const void* A_sig,
                                        const void* gamma, const void* beta, void* keep,
                                        void* stats, void* scratch, void* probe, void* counter,
                                        int k, int b, int d, int grid, int x_bf16,
                                        int compute_bf16, int tensor_core, int variant,
                                        float lam, float eps, void* stream) {
  if (b > kMaxB || b < 2 || b % 32 != 0 || !width_ok(d)) return (int)cudaErrorInvalidValue;
  if (tensor_core && (!compute_bf16 || gamma == nullptr || b > kDmmaMaxB))
    return (int)cudaErrorInvalidValue;
  if (variant != kExact && !(tensor_core && d == 128 && !x_bf16 &&
                             (variant == kReachOne || (variant == kProbe && probe != nullptr))))
    return (int)cudaErrorInvalidValue;
  GateArgs a{x, static_cast<const float*>(pad), static_cast<const float*>(A_sig),
             static_cast<const float*>(gamma), static_cast<const float*>(beta),
             static_cast<int32_t*>(keep), static_cast<float*>(stats),
             static_cast<float*>(scratch), static_cast<long long*>(probe),
             static_cast<int*>(counter), k, b, d, lam, eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == kProbe) return run<float, true, 128, kProbe>(a, grid, s);
  if (variant == kReachOne) return run<float, true, 128, kReachOne>(a, grid, s);
  if (tensor_core) return x_bf16 ? run_tc<__nv_bfloat16>(a, grid, s) : run_tc<float>(a, grid, s);
  // bf16 compute rounds the LN output only; the logit products are float32
  if (x_bf16)
    return compute_bf16 ? run<__nv_bfloat16, true>(a, grid, s)
                        : run<__nv_bfloat16, false>(a, grid, s);
  return compute_bf16 ? run<float, true>(a, grid, s) : run<float, false>(a, grid, s);
}
