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
// What bounds it on an H100: the logits are 2 B D (B + D) float32
// operations per partition; each push-relabel round is ~10 B^2 element
// operations over the [B, B] residual, and the rounds depend on the
// data. The residual is 256 KB at B=256, above the 227 KB a block may
// use, so it lives in the block's slice of a global scratch buffer
// (L2-resident) with the push matrix and the clamped logits (3 B^2 + 2 B D
// floats per block); the passes over it are bound by L2 bandwidth and by
// the block barriers between the phases of a round.
//
// Design: a persistent grid, one block of 256 threads per partition at a
// time; each block leaves its loop when its own partition stops (block-
// wide conditions via __syncthreads_or). Row passes are one warp per row
// (the push's prefix sum a warp scan over 32-column chunks with a carried
// total); column sums of the push matrix run one thread per column in a
// fixed order, so there are no float atomics and runs repeat bit for bit.
// Push amounts may differ from the plain version's in the last bits (the
// prefix sum associates differently); the max flow value and the
// canonical cut, and so the masks, do not.

#include "gated_common.cuh"

namespace {

using namespace rvt;

constexpr float kTiny = 1e-12f;
constexpr int kRelabelEvery = 8;

struct GateArgs {
  const void* x;        // [K, B, D] float32 or bf16
  const float* pad;     // [K, B]
  const float* A_sig;   // [D, D] float32
  const float* gamma;   // [D] or null (no LN)
  const float* beta;
  int32_t* keep;        // [K, B/32, B]
  float* stats;         // [K, 8, B]
  float* scratch;       // grid x (2 B D + 3 B B)
  int k, b, d;
  float lam, eps;
};

struct GateSmem {
  GemmSmem gs;
  float pad[kMaxB];
  float e[kMaxB];       // excess
  float rs[kMaxB];      // row sums of this round's pushes
  int h[kMaxB];         // heights
  int hn[kMaxB];        // relabelled heights
  int act[kMaxB];       // active at the start of the round
  int dist[kMaxB];      // BFS distances (global relabel)
  int dist_s[kMaxB];
  int reach[kMaxB];
  float red[kThreads];  // block reductions
  float red2[kThreads];
};

// block-wide sums of two per-thread values, in a fixed order
__device__ void block_sum2(float& a, float& b, GateSmem& sm) {
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

// Backward BFS distances to `target` over residual edges u -> v (R > 0):
// d[target] = 0, d[u] = 1 + min over residual v of d[v], inf = 4B for
// nodes that cannot reach it. Updates in place until nothing changes (the
// fixpoint, the exact distances, does not depend on the update order).
__device__ void bfs_to(const float* R, int n, int target, int* d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int inf = 4 * n;
  volatile int* vd = d;
  for (int v = threadIdx.x; v < n; v += kThreads) d[v] = v == target ? 0 : inf;
  __syncthreads();
  while (true) {
    int changed = 0;
    for (int u = warp; u < n; u += kWarps) {
      const float* ru = R + (size_t)u * n;
      int via = inf;
      for (int v = lane; v < n; v += 32)
        if (ru[v] > kTiny) via = min(via, vd[v]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) via = min(via, __shfl_xor_sync(0xffffffffu, via, o));
      if (lane == 0 && via + 1 < vd[u]) {
        vd[u] = via + 1;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
}

// Exact distance labels (mincut_device._global_relabel): h[v] = dist to
// t, or n + min(dist to s, n) for nodes cut off from t; h[s] = n; never
// lowered.
__device__ void global_relabel(const float* R, int n, GateSmem& sm) {
  const int inf = 4 * n, t = n - 1;
  bfs_to(R, n, t, sm.dist);
  bfs_to(R, n, 0, sm.dist_s);
  for (int v = threadIdx.x; v < n; v += kThreads) {
    int hv = sm.dist[v] < inf ? sm.dist[v] : n + min(sm.dist_s[v], n);
    if (v == 0) hv = n;
    sm.h[v] = max(sm.h[v], hv);
  }
  __syncthreads();
}

template <typename XT, bool BF16>
__global__ void __launch_bounds__(kThreads) gate_kernel(const GateArgs a) {
  __shared__ GateSmem sm;
  const int n = a.b, d = a.d, t = n - 1, words = (n + 31) / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t nn = (size_t)n * n;
  float* X = a.scratch + (size_t)blockIdx.x * (2 * (size_t)n * d + 3 * nn);
  float* QS = X + (size_t)n * d;
  float* C = QS + (size_t)n * d;   // clamped positive logits
  float* R = C + nn;               // residual
  float* P = R + nn;               // this round's pushes
  const int rounds_cap = 4 * n * n + 8;
  const int two_n = 2 * n;

  for (int k = blockIdx.x; k < a.k; k += gridDim.x) {
    const XT* xk = static_cast<const XT*>(a.x) + (size_t)k * n * d;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) sm.pad[i] = a.pad[(size_t)k * n + i];
    __syncthreads();

    // --- pooled logits, clamped ---
    if (a.gamma != nullptr) {
      layer_norm_rows<BF16>(xk, X, a.gamma, a.beta, n, d, 1e-5f);
    } else {
      for (size_t i = tid; i < (size_t)n * d; i += kThreads) X[i] = ldf(xk + i);
      __syncthreads();
    }
    block_gemm<false, false, double>(X, d, a.A_sig, d, n, d, d, sm.gs,
                                     [&](int m, int c, float v) { QS[(size_t)m * d + c] = v; });
    block_gemm<false, true, double>(QS, d, X, d, n, n, d, sm.gs, [&](int m, int c, float v) {
      const bool ok = sm.pad[m] > 0.f && sm.pad[c] > 0.f && v > a.eps;
      C[(size_t)m * n + c] = ok ? v : 0.f;
    });
    float csum = 0.f, npos = 0.f;
    for (size_t i = tid; i < nn; i += kThreads) {
      const float v = C[i];
      csum += v;
      npos += v > 0.f ? 1.f : 0.f;
    }
    block_sum2(csum, npos, sm);
    const float threshold = a.lam * (csum / fmaxf(npos, 1.f));

    // --- init: saturate the source ---
    for (size_t i = tid; i < nn; i += kThreads) {
      const int u = (int)(i / n), v = (int)(i % n);
      R[i] = (u == 0 ? 0.f : C[i]) + (v == 0 ? C[u] : 0.f);
    }
    for (int v = tid; v < n; v += kThreads) {
      sm.h[v] = v == 0 ? n : 0;
      sm.e[v] = v == 0 ? 0.f : C[v];
    }
    __syncthreads();
    global_relabel(R, n, sm);

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
      // column order with its excess
      for (int u = warp; u < n; u += kWarps) {
        if (!sm.act[u]) continue;
        const float* ru = R + (size_t)u * n;
        float* pu = P + (size_t)u * n;
        const int hu = sm.h[u];
        const float eu = sm.e[u];
        float carry = 0.f, rsum = 0.f;
        for (int v0 = 0; v0 < n; v0 += 32) {
          const int v = v0 + lane;
          float ra = 0.f;
          if (v < n) {
            const float r = ru[v];
            ra = (r > kTiny && hu == sm.h[v] + 1) ? r : 0.f;
          }
          float cum = ra;  // inclusive warp scan
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float up = __shfl_up_sync(0xffffffffu, cum, o);
            if (lane >= o) cum += up;
          }
          cum += carry;
          const float push = fminf(fmaxf(eu - (cum - ra), 0.f), ra);
          if (v < n) pu[v] = push;
          rsum += push;
          carry = __shfl_sync(0xffffffffu, cum, 31);
        }
        rsum = warp_sum(rsum);
        if (lane == 0) sm.rs[u] = rsum;
      }
      __syncthreads();
      // apply: r -= push, r += push^T; excess: e - row sum + column sum
      for (size_t i = tid; i < nn; i += kThreads) {
        const int u = (int)(i / n), v = (int)(i % n);
        float r = R[i];
        if (sm.act[u]) r -= P[i];
        if (sm.act[v]) r += P[(size_t)v * n + u];
        R[i] = r;
      }
      for (int u = tid; u < n; u += kThreads) {
        float cs = 0.f;
        for (int v = 0; v < n; ++v)
          if (sm.act[v]) cs += P[(size_t)v * n + u];
        sm.e[u] = (sm.e[u] - (sm.act[u] ? sm.rs[u] : 0.f)) + cs;
      }
      __syncthreads();
      // relabel phase against the updated residual
      for (int u = warp; u < n; u += kWarps) {
        const int hu = sm.h[u];
        const bool on = sm.e[u] > kTiny && u != 0 && u != t && hu < two_n;
        int lift = two_n + 1, adm = 0;
        if (on) {
          const float* ru = R + (size_t)u * n;
          for (int v = lane; v < n; v += 32) {
            if (ru[v] > kTiny) {
              const int hv = sm.h[v];
              lift = min(lift, hv);
              adm |= hu == hv + 1;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            lift = min(lift, __shfl_xor_sync(0xffffffffu, lift, o));
          adm = __any_sync(0xffffffffu, adm);
        }
        if (lane == 0) sm.hn[u] = (on && !adm) ? max(hu, lift + 1) : hu;
      }
      __syncthreads();
      for (int u = tid; u < n; u += kThreads) sm.h[u] = sm.hn[u];
      __syncthreads();
      if ((rounds + 1) % kRelabelEvery == 0) global_relabel(R, n, sm);
      ++rounds;
    }
    const float flow = sm.e[t];
    int still = 0;
    for (int u = tid; u < n; u += kThreads)
      still |= sm.e[u] > kTiny && u != 0 && u != t && sm.h[u] < two_n;
    const bool capped = __syncthreads_or(still) && flow <= threshold;

    // --- canonical cut: s-reachability in the residual ---
    volatile int* reach = sm.reach;
    for (int v = tid; v < n; v += kThreads) reach[v] = v == 0;
    __syncthreads();
    while (true) {
      int changed = 0;
      for (int u = warp; u < n; u += kWarps) {
        if (!reach[u]) continue;
        const float* ru = R + (size_t)u * n;
        for (int v = lane; v < n; v += 32) {
          if (ru[v] > kTiny && !reach[v]) {
            reach[v] = 1;
            changed = 1;
          }
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
    float cost = 0.f, unused = 0.f;
    for (size_t i = tid; i < nn; i += kThreads) {
      const int u = (int)(i / n), v = (int)(i % n);
      if (reach[u] && !reach[v] && C[i] > 0.f) cost += C[i];
    }
    block_sum2(cost, unused, sm);
    const bool applied = flow <= threshold && npos > 0.f && !capped;

    // --- bit-packed keep and stats ---
    int32_t* keepk = a.keep + (size_t)k * words * n;
    for (int i = tid; i < words * n; i += kThreads) {
      const int w = i / n, j = i % n;
      uint32_t word = 0;
      for (int bit = 0; bit < 32; ++bit) {
        const int r = w * 32 + bit;
        if (r >= n) break;
        const bool pos = C[(size_t)r * n + j] > 0.f;
        const bool cross = reach[r] && !reach[j];
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
  }
}

template <typename XT, bool BF16>
int run(const GateArgs& a, int grid, cudaStream_t s) {
  auto kernel = gate_kernel<XT, BF16>;
  const int g = resident_grid(kernel, grid, 0);
  kernel<<<g, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mincut_gate_block_from_x(const void* x, const void* pad, const void* A_sig,
                                        const void* gamma, const void* beta, void* keep,
                                        void* stats, void* scratch, int k, int b, int d,
                                        int grid, int x_bf16, int compute_bf16, float lam,
                                        float eps, void* stream) {
  if (b > kMaxB || b < 2 || b % 32 != 0 || !width_ok(d)) return (int)cudaErrorInvalidValue;
  GateArgs a{x, static_cast<const float*>(pad), static_cast<const float*>(A_sig),
             static_cast<const float*>(gamma), static_cast<const float*>(beta),
             static_cast<int32_t*>(keep), static_cast<float*>(stats),
             static_cast<float*>(scratch), k, b, d, lam, eps};
  auto s = static_cast<cudaStream_t>(stream);
  // bf16 compute rounds the LN output only; the logit products are float32
  if (x_bf16)
    return compute_bf16 ? run<__nv_bfloat16, true>(a, grid, s)
                        : run<__nv_bfloat16, false>(a, grid, s);
  return compute_bf16 ? run<float, true>(a, grid, s) : run<float, false>(a, grid, s);
}
