// mbarrier and bulk asynchronous copy helpers for Hopper (sm_90a), shared
// by the sm90 designs of conv3x3.cu and maxpool2.cu. Header only: every
// function is inlined into the kernel that calls it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mg_async {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async proxy (bulk
// copies and TMA complete on them)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait
// that never ends is a bug: trap after ~2^34 cycles (about 9 s), so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 34))
      __trap();
  }
}

// One contiguous copy of `bytes` (a multiple of 16; both addresses on 16-
// byte boundaries) from device memory into shared memory, which completes
// on the barrier `bar` as that many transaction bytes. No tensor map.
__device__ __forceinline__ void load_1d(uint32_t dst, const void* src, uint32_t bytes,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace mg_async
