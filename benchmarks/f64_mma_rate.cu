// The H100's float64 tensor-core rate by mma shape: m8n8k4 (sm_80's
// shape) against sm_90's m16n8k4 and m16n8k16, each warp issuing
// independent DMMAs on register operands (no memory traffic), 2 blocks of
// 4 or 8 warps per SM; then a check of the m16n8k16 and m16n8k4 fragment
// layouts that csrc/gated_f64tc.cuh (dmma16816, dmma1684) assumes, against
// a product on the host.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o f64_mma_rate benchmarks/f64_mma_rate.cu
//   ./f64_mma_rate
//
// Prints TFLOP/s per shape and occupancy (2 flops a multiply-add) and the
// number of wrong entries of each layout check (0 expected); exits
// non-zero on a CUDA error or a wrong entry.

#include <cuda_runtime.h>
#include <stdio.h>

__device__ __forceinline__ void m884(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

__device__ __forceinline__ void m1684(double (&c)[4], const double (&a)[2], double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

__device__ __forceinline__ void m16816(double (&c)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// SHAPE 0: m8n8k4 (16 chains), 1: m16n8k4 (8 chains), 2: m16n8k16 (4 chains)
template <int SHAPE>
__global__ void rate(double* out, int iters) {
  const double x = 1e-3 * threadIdx.x;
  double s = 0.0;
  if constexpr (SHAPE == 0) {
    double c[16][2] = {};
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) m884(c[j], x, 1.0 + x);
    for (int j = 0; j < 16; ++j) s += c[j][0] + c[j][1];
  } else if constexpr (SHAPE == 1) {
    double c[8][4] = {};
    const double a[2] = {x, 1.0};
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) m1684(c[j], a, 1.0 + x);
    for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  } else {
    double c[4][4] = {};
    double a[8], b[4];
    for (int i = 0; i < 8; ++i) a[i] = x + i;
    for (int i = 0; i < 4; ++i) b[i] = 1.0 + 1e-4 * i;
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m16816(c[j], a, b);
    for (int j = 0; j < 4; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// C = A B for A [16, 16], B [16, 8] (k, n); lane l = 4g + t holds
// a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[j] = B[t + 4j][g],
// c = C[g][2t, 2t + 1], C[g + 8][2t, 2t + 1]. K4 takes the same product
// as four m16n8k4 steps: a = A[g][t + 4q], A[g + 8][t + 4q], b = B[t + 4q][g].
template <bool K4>
__global__ void layout16816(const double* A, const double* B, double* C) {
  const int g = threadIdx.x / 4, t = threadIdx.x % 4;
  double a[8], b[4], c[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = 0; i < 8; ++i) a[i] = A[(g + 8 * (i % 2)) * 16 + t + 4 * (i / 2)];
  for (int j = 0; j < 4; ++j) b[j] = B[(t + 4 * j) * 8 + g];
  if (K4) {
    for (int q = 0; q < 4; ++q) {
      const double aq[2] = {a[2 * q], a[2 * q + 1]};
      m1684(c, aq, b[q]);
    }
  } else {
    m16816(c, a, b);
  }
  for (int h = 0; h < 2; ++h)
    for (int e = 0; e < 2; ++e) C[(g + 8 * h) * 8 + 2 * t + e] = c[2 * h + e];
}

template <int SHAPE>
bool time_shape(const char* name, double macs_per_iter, int warps, double* out) {
  const int blocks = 2 * 132, iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rate<SHAPE><<<blocks, 32 * warps>>>(out, 16);  // warm-up
  cudaEventRecord(e0);
  rate<SHAPE><<<blocks, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  const cudaError_t err = cudaGetLastError();
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * macs_per_iter * iters * blocks * warps;
  printf("%-9s warps/block=%d blocks=%d: %.3f ms, %.1f TFLOP/s (%s)\n", name, warps, blocks, ms,
         flops / ms / 1e9, cudaGetErrorString(err));
  return err == cudaSuccess;
}

int main() {
  double* out;
  cudaMalloc(&out, 2 * 132 * 256 * sizeof(double));
  bool ok = true;
  for (int warps = 4; warps <= 8; warps *= 2) {
    ok &= time_shape<0>("m8n8k4", 16.0 * 8 * 8 * 4, warps, out);
    ok &= time_shape<1>("m16n8k4", 8.0 * 16 * 8 * 4, warps, out);
    ok &= time_shape<2>("m16n8k16", 4.0 * 16 * 8 * 16, warps, out);
  }
  double hA[256], hB[128], hC[128];
  for (int i = 0; i < 256; ++i) hA[i] = (i * 7 % 13) - 6;
  for (int i = 0; i < 128; ++i) hB[i] = (i * 5 % 11) - 5;
  double *dA, *dB, *dC;
  cudaMalloc(&dA, sizeof(hA));
  cudaMalloc(&dB, sizeof(hB));
  cudaMalloc(&dC, sizeof(hC));
  cudaMemcpy(dA, hA, sizeof(hA), cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof(hB), cudaMemcpyHostToDevice);
  int wrong_all = 0;
  for (int k4 = 0; k4 < 2; ++k4) {
    if (k4)
      layout16816<true><<<1, 32>>>(dA, dB, dC);
    else
      layout16816<false><<<1, 32>>>(dA, dB, dC);
    cudaMemcpy(hC, dC, sizeof(hC), cudaMemcpyDeviceToHost);
    int wrong = 0;
    for (int m = 0; m < 16; ++m)
      for (int n = 0; n < 8; ++n) {
        double s = 0.0;
        for (int k = 0; k < 16; ++k) s += hA[m * 16 + k] * hB[k * 8 + n];
        wrong += hC[m * 8 + n] != s;
      }
    printf("%s layout check: %d of 128 wrong\n", k4 ? "m16n8k4" : "m16n8k16", wrong);
    wrong_all += wrong;
  }
  const cudaError_t err = cudaGetLastError();
  printf("layout checks: %s\n", cudaGetErrorString(err));
  return ok && wrong_all == 0 && err == cudaSuccess ? 0 : 1;
}
