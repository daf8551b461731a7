// Bulk asynchronous copies from device memory into shared memory, counted
// on mbarriers (Hopper, sm_90a), written by hand from the PTX.
//
// An mbarrier is a 64-bit word in shared memory. Each phase completes when
// its expected arrivals have arrived and the bytes it was told to expect
// (expect_tx) have landed; waiting names the parity of the phase waited
// for. A bulk copy moves a contiguous range (both addresses 16-byte
// aligned, a size that is a multiple of 16) with no registers or
// instructions spent per byte, and counts its bytes on the barrier it
// names. A barrier that does not complete within ~2^35 clock cycles
// (about 20 s) traps, so a fault in a pipeline fails its launch with an
// error instead of hanging the card.

#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises a barrier for `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// After the inits and before a __syncthreads: makes them visible to the
// other threads and to the bulk copies.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Tells the current phase to expect `bytes` more, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrives and tells the current phase to expect `bytes` more.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so waiting for parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// Copies `bytes` from global `src` to shared `dst`; the bytes count on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))),
      "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Stages n 32-bit words from global `src` into shared `dst` (16-byte
// aligned) for the current phase of `bar`. Called by a whole warp: where
// src is 16-byte aligned and n a multiple of 4, lane 0 adds the bytes to
// the phase with expect_tx and issues one bulk copy; otherwise the 32
// lanes load the words. The caller then syncs the warp and arrives on
// `bar` (so the plain stores are ordered before the arrival), and readers
// wait for the phase.
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src, uint32_t n,
                                            uint64_t* bar, int lane) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n % 4 == 0) {
    if (lane == 0 && n > 0) {
      mbar_expect_tx(bar, 4 * n);
      bulk_copy_g2s(dst, src, 4 * n, bar);
    }
  } else {
    for (uint32_t j = lane; j < n; j += 32) dst[j] = __ldg(src + j);
  }
}

// Host side: the CTAs a persistent grid keeps resident on the current
// device, CTAs an SM (registers and `smem` bytes of dynamic shared memory,
// which it sets as the kernel's limit) x SMs. The runtime is asked once an
// instance and a device: `cache`, a function-local static of the caller's
// kernel instance with a slot a device (0 until set), keeps the answer,
// so later launches make no runtime call but cudaGetDevice.
constexpr int kMaxDevices = 16;

template <typename Kernel>
inline cudaError_t resident_ctas(Kernel kernel, int threads, int smem,
                                 std::atomic<int> (&cache)[kMaxDevices], int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*ctas = cache[dev].load(std::memory_order_acquire)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *ctas = (per_sm > 0 ? per_sm : 1) * sms;
  if (dev < kMaxDevices) cache[dev].store(*ctas, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace bulk
