// The `1x1` design of the int8 conv (conv_i8.cu has the other designs
// and the epilogue's contract): 1x1/s1/p0 parts with Ci and Co multiples
// of 16, a plain s8 x s8 -> s32 GEMM of the pixels (M = N*H*W rows of Ci
// bytes) by the K-major packed weight's slice (Co rows, the weight's
// whole Ci apart), then the epilogue. The zoo's: cifar/prnmg's 8 shortcut
// and head parts at M = 128 (its 1x1 maps at batch 128), K 64 to 512, Co
// 128 to 384. Replaces no TPU kernel (see conv_i8.cu).
//
// What bounds it: at M = 128 nothing but latency (a part moves at most
// 0.27 MB and does 50 MOP: 0.08 us of HBM). The `simple` design ran
// these with a 128 x 64 tile, 2 to 6 blocks on the card's 132 SMs, and
// a K walk of 32 bytes a step through registers; torch._int_mm took
// 0.80 of its time.
//
// The design: tiles of 32 x 32 (64 x 64 where those alone fill the
// card), four warps; the K walk in chunks of 128 bytes through a 4-stage
// cp.async ring (the zoo's whole K is in flight at once); mma.sync
// m16n8k32 from ldmatrix fragments; the tile staged in shared memory,
// finished there and written with 16-byte stores. No split of K: at M =
// 128 the 16 to 48 tiles are latency-bound already, and a split's
// partial sums would cost a second pass over them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_i8.cuh"

namespace {

using namespace mg_i8;

// 16 bytes from device to shared memory, both on 16-byte boundaries; ok
// false: 16 zero bytes, nothing read
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

constexpr int THREADS = 128;  // 2 x 2 warps
constexpr int BK = 128;       // K bytes a stage
constexpr int KP = BK + 16;   // a stage row's pitch: ldmatrix without bank conflicts
constexpr int STAGES = 4;

template <int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (BM + BN) * KP;
}

// x: M rows of ci bytes; w: co rows of ci bytes, ldw bytes apart (the
// packed weight from the slice's first channel); ES: the output's element
// bytes
template <int BM, int BN, int ES>
__global__ void __launch_bounds__(THREADS)
    conv_i8_1x1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epi e,
                       void* y, int out, int M, int ci, int co, long long ldw) {
  constexpr int MI = BM / 32, NI = BN / 16;  // a warp's m16 and n8 tiles
  constexpr int SP = BN * ES + 16;           // staging pitch
  static_assert(BM * SP <= smem_bytes<BM, BN>(), "the staged tile fits the ring");
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;                     // [STAGES][BM][KP]
  uint8_t* Bs = smem + STAGES * BM * KP;  // [STAGES][BN][KP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks = (ci + BK - 1) / BK;

  auto load = [&](int c, int s) {
    const int k0 = c * BK;
    for (int i = tid; i < (BM + BN) * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), kk = k0 + 16 * (i % (BK / 16));
      if (r < BM) {
        const bool ok = m0 + r < M && kk < ci;
        cp16(As + (s * BM + r) * KP + kk - k0,
             ok ? x + static_cast<long long>(m0 + r) * ci + kk : x, ok);
      } else {
        const int rb = r - BM;
        const bool ok = n0 + rb < co && kk < ci;
        cp16(Bs + (s * BN + rb) * KP + kk - k0, ok ? w + (n0 + rb) * ldw + kk : w, ok);
      }
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) load(c, c);
    cp_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; the stage chunk c - 1 used is free
    if (c + STAGES - 1 < chunks) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_commit();
    const uint8_t* a_st = As + (c % STAGES) * BM * KP;
    const uint8_t* b_st = Bs + (c % STAGES) * BN * KP;
    const int ksteps = min(BK, ci - c * BK) / 32 + (min(BK, ci - c * BK) % 32 != 0);
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a[mi], a_st + (wm * (BM / 2) + 16 * mi + (lane & 15)) * KP + 32 * kk +
                               (lane >> 4) * 16);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, b_st + (wn * (BN / 2) + 16 * nj + (lane & 7) + ((lane >> 4) << 3)) * KP +
                           32 * kk + ((lane >> 3) & 1) * 16);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the tile is staged there

  // the epilogue: rows m0.., channels n0.. (Co % 16 == 0: a 16-byte chunk
  // of a row is all in or all out)
  uint8_t* stg = smem;
  const int rows = min(BM, M - m0), cols = min(BN, co - n0);
  uint8_t* yt = static_cast<uint8_t*>(y) + (static_cast<long long>(m0) * co + n0) * ES;
  if (e.y_in != nullptr) {
    copy_rows(stg, SP,
              const_cast<uint8_t*>(static_cast<const uint8_t*>(e.y_in)) +
                  (static_cast<long long>(m0) * co + n0) * ES,
              static_cast<long long>(co) * ES, rows, cols * ES,
              reinterpret_cast<uintptr_t>(e.y_in) % 16 == 0, false, tid, THREADS);
    __syncthreads();
  }
  const float sx = out == OUT_S32 ? 0.f : __ldg(e.sx);
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int c = wn * (BN / 2) + 8 * ni + 2 * t;
    if (c >= cols) continue;
    float v0 = 0.f, v1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (out != OUT_S32) {
      v0 = __fmul_rn(sx, __ldg(e.scale + n0 + c));
      v1 = __fmul_rn(sx, __ldg(e.scale + n0 + c + 1));
      if (e.bias != nullptr) b0 = __ldg(e.bias + n0 + c), b1 = __ldg(e.bias + n0 + c + 1);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * (BM / 2) + 16 * mi + gq + 8 * h;
        if (r < rows)
          finish_pair(stg + r * SP + c * ES, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], out,
                      v0, v1, b0, b1, e);
      }
  }
  __syncthreads();
  copy_rows(stg, SP, yt, static_cast<long long>(co) * ES, rows, cols * ES,
            reinterpret_cast<uintptr_t>(y) % 16 == 0, true, tid, THREADS);
}

template <int BM, int BN, int ES>
int launch_cfg(const int8_t* x, const int8_t* w, const Epi& e, void* y, int out, int m, int ci,
               int co, long long ldw, cudaStream_t stream) {
  auto kernel = conv_i8_1x1_kernel<BM, BN, ES>;
  constexpr int SMEM = smem_bytes<BM, BN>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  static unsigned allowed = 0;  // the dynamic shared memory allowed, once per device
  if (!(allowed >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed |= 1u << dev;
  }
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), (co + BN - 1) / BN);
  kernel<<<grid, THREADS, SMEM, stream>>>(x, w, e, y, out, m, ci, co, ldw);
  return static_cast<int>(cudaGetLastError());
}

template <int ES>
int launch_es(const int8_t* x, const int8_t* w, const Epi& e, void* y, int out, int m, int ci,
              int co, long long ldw, int sms, cudaStream_t stream) {
  // 64 x 64 tiles where they alone give every SM one, else 32 x 32
  const long long big = static_cast<long long>((m + 63) / 64) * ((co + 63) / 64);
  if (big >= sms) return launch_cfg<64, 64, ES>(x, w, e, y, out, m, ci, co, ldw, stream);
  return launch_cfg<32, 32, ES>(x, w, e, y, out, m, ci, co, ldw, stream);
}

}  // namespace

// The 1x1 design, 1x1/s1/p0 only: the arguments of mg_conv_i8_sm90 (w the
// K-major packed weight (co, w_tap_stride) bytes from the slice's first
// input channel); Ci, Co, w_tap_stride multiples of 16, x and w on
// 16-byte boundaries, else cudaErrorInvalidValue.
extern "C" int mg_conv_i8_1x1(const void* x, const void* w, const void* sx, const void* scale,
                              const void* y_in, const void* bias, void* y, int n, int h, int wd,
                              int ci, int co, int k, int s, int p, long long w_tap_stride,
                              int out_kind, int relu, int pad_top, int pad_bottom,
                              void* stream) {
  const Epi e{static_cast<const float*>(sx), static_cast<const float*>(scale), y_in,
              static_cast<const float*>(bias), relu};
  const long long m = static_cast<long long>(n) * h * wd;
  if (bad_args(e, y, n, h, wd, ci, co, k, s, p, pad_top, pad_bottom, out_kind) || k != 1 ||
      s != 1 || p != 0 || ci % 16 != 0 || co % 16 != 0 || w_tap_stride % 16 != 0 ||
      w_tap_stride < ci || !aligned(x, 16) || !aligned(w, 16) || m >= (1ll << 31))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  return out_kind == OUT_BF16
             ? launch_es<2>(xp, wp, e, y, out_kind, static_cast<int>(m), ci, co, w_tap_stride,
                            sms, st)
             : launch_es<4>(xp, wp, e, y, out_kind, static_cast<int>(m), ci, co, w_tap_stride,
                            sms, st);
}
