// mbarrier, bulk and tensor-map (TMA) copy, wgmma and register helpers
// for Hopper (sm_90a), shared by the sm90 designs of conv3x3.cu,
// conv_i8.cu and maxpool2.cu. Header only: every device function is
// inlined into the kernel that calls it.
#pragma once

#include <cuda.h>  // CUtensorMap and its encoders' types (fetched at run time, no -lcuda)
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

// One TMA im2col load: the box of pixels m.. of the map's walk, offset
// by (dw, dh) from the base pixel (c, w, h, n), completing on `bar`
__device__ __forceinline__ void load_im2col(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int w, int h, int n, uint16_t dw,
                                            uint16_t dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"(dw),
      "h"(dh)
      : "memory");
}

// One TMA load of a 3-D tiled map's box at (c0, c1, c2)
__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma reads, TMA stores and loads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// wgmma's shared-memory layouts of a K-major tile whose rows are
// 128, 64 or 32 bytes, swizzled by TMA's matching mode
enum GmmaLayout : uint64_t { SWIZZLE_128B = 1, SWIZZLE_64B = 2, SWIZZLE_32B = 3 };

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), the swizzle; the tile's base sits
// on the swizzle's repeat (1024, 512 or 256 bytes), so the base offset
// field stays 0
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = SWIZZLE_128B) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | layout << 62;
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async
// products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a driver function through the runtime, so the library needs no -lcuda
inline void* driver_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault,
                                                           &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? fn : nullptr;
}

}  // namespace mg_async
