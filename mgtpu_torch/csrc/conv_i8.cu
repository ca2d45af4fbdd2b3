// int8 x int8 -> int32 convolution, NHWC x / HWIO w, any square kernel
// k, stride s and zero padding p, with an optional fused dequant
// epilogue: y[m, co] = cast(float(acc[m, co]) * v[co]) in f32 or bf16.
//
// Replaces no TPU kernel. The JAX package's int8 serving conv,
// mgtpu/ops/quant.py::conv_i8, is an int8 conv_general_dilated with an
// int32 result that XLA lowers; PyTorch has no int8 convolution on CUDA
// (F.conv2d refuses torch.int8), so the port writes one.
//
// Bound on this card: the zoo's convs are GEMMs with K = k*k*Ci of 27 to
// 4608 and enough reuse to be bound by arithmetic on the int8 tensor
// cores (1,979 TOP/s dense) at the wide shapes; the narrow ones and the
// stems (Ci = 1 or 3) move few bytes and waste most of each MMA.
//
// Design (the first, simple one): an implicit GEMM, M = N*OH*OW output
// pixels, N = Co and K walked as k*k taps x Ci chunks of 32 channels, on
// mma.sync m16n8k32 s8 x s8 -> s32. A chunk past Ci is zero in shared
// memory, so Ci = 1, 3 and 16 need no padded copy of x; the conv's zero
// padding is a bounds check on the gather. A block computes a 128-pixel
// x 64-channel tile with 8 warps of 32 x 32; A (pixels x 32 channels)
// and B (channels x 32 K slots, transposed from the HWIO rows so that
// both operands are K-contiguous) go through two shared-memory stages
// with 48-byte rows, which ldmatrix reads without bank conflicts. The
// next step's tiles are loaded into registers while the current one is
// multiplied. x is read 16 bytes a thread when Ci is a multiple of 16
// and x is 16-byte aligned, byte by byte otherwise; w byte by byte (the
// weights are small and stay in L1/L2). The s32 sums are exact, so the
// result does not depend on the order of the K walk. The epilogue
// computes float(acc) * v[co] with round-to-nearest conversions and one
// rounded multiply, the plain version's formula, bit for bit.
// The exchange passes slices of a wider weight along its input
// channels: taps are w_tap_stride elements apart, rows Co apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K slots per step: 32 input channels of one tap
constexpr int PITCH = 48;    // bytes per shared-memory row (32 + 16: no bank conflicts)
constexpr int THREADS = 256;

enum Out { OUT_S32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

struct Shape {
  int n, h, w, ci, co, k, s, p, oh, ow;
  long long tap_stride;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float v) {
  return __fmul_rn(__int2float_rn(acc), v);
}

// Two adjacent output channels (co, co + 1) of one pixel; pair: both exist
// and the address is aligned for one vector store (Co even)
template <int OUT>
__device__ __forceinline__ void store2(void* y, long long idx, int a0, int a1, const float* v,
                                       int co, bool pair, bool second) {
  if (OUT == OUT_S32) {
    int* p = static_cast<int*>(y) + idx;
    if (pair) {
      *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
    } else {
      p[0] = a0;
      if (second) p[1] = a1;
    }
  } else if (OUT == OUT_F32) {
    float* p = static_cast<float*>(y) + idx;
    const float f0 = dequant(a0, v[co]);
    if (pair) {
      *reinterpret_cast<float2*>(p) = make_float2(f0, dequant(a1, v[co + 1]));
    } else {
      p[0] = f0;
      if (second) p[1] = dequant(a1, v[co + 1]);
    }
  } else {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(y) + idx;
    const __nv_bfloat16 b0 = __float2bfloat16_rn(dequant(a0, v[co]));
    if (pair) {
      __nv_bfloat162 b;
      b.x = b0;
      b.y = __float2bfloat16_rn(dequant(a1, v[co + 1]));
      *reinterpret_cast<__nv_bfloat162*>(p) = b;
    } else {
      p[0] = b0;
      if (second) p[1] = __float2bfloat16_rn(dequant(a1, v[co + 1]));
    }
  }
}

// VEC: x is read 16 bytes a thread (Ci % 16 == 0, x 16-byte aligned)
template <bool VEC, int OUT>
__global__ void __launch_bounds__(THREADS)
    conv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ v, void* __restrict__ y, Shape sh) {
  __shared__ __align__(16) int8_t As[2][BM * PITCH];
  __shared__ __align__(16) int8_t Bs[2][BN * PITCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per_img = static_cast<long long>(sh.oh) * sh.ow;
  const long long m_total = per_img * sh.n;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int co0 = blockIdx.y * BN;
  const int chunks = (sh.ci + BK - 1) / BK;
  const int steps = sh.k * sh.k * chunks;

  // the A gather: tile row ra, 16 channels from 16 * ha of the chunk
  const int ra = tid >> 1, ha = tid & 1;
  const long long m = m0 + ra;
  const bool m_ok = m < m_total;
  int ih0 = 0, iw0 = 0;
  const int8_t* x_img = x;
  if (m_ok) {
    const int img = static_cast<int>(m / per_img);
    const int r = static_cast<int>(m - img * per_img);
    const int oh = r / sh.ow;
    ih0 = oh * sh.s - sh.p;
    iw0 = (r - oh * sh.ow) * sh.s - sh.p;
    x_img = x + static_cast<long long>(img) * sh.h * sh.w * sh.ci;
  }
  // the B gather: K slots 4 * bk .. 4 * bk + 3 of output channels 2 * bn, 2 * bn + 1
  const int bk = tid & 7, bn = tid >> 3;

  uint4 a_reg;
  uint32_t b_reg[2];
  auto load = [&](int step) {
    const int tap = step / chunks;
    const int c0 = (step - tap * chunks) * BK;
    const int kh = tap / sh.k, kw = tap - kh * sh.k;
    const int ih = ih0 + kh, iw = iw0 + kw;
    const int ca = c0 + 16 * ha;
    a_reg = make_uint4(0u, 0u, 0u, 0u);
    if (m_ok && ih >= 0 && ih < sh.h && iw >= 0 && iw < sh.w && ca < sh.ci) {
      const int8_t* src = x_img + (static_cast<long long>(ih) * sh.w + iw) * sh.ci + ca;
      if (VEC) {
        a_reg = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (ca + j < sh.ci)
            wd[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + j)))
                          << (8 * (j & 3));
        a_reg = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
    const int8_t* wt = w + tap * sh.tap_stride;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = co0 + 2 * bn + j;
      uint32_t word = 0u;
      if (co < sh.co) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + 4 * bk + i;
          if (c < sh.ci)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        __ldg(wt + static_cast<long long>(c) * sh.co + co)))
                    << (8 * i);
        }
      }
      b_reg[j] = word;
    }
  };
  auto store = [&](int buf) {
    *reinterpret_cast<uint4*>(&As[buf][ra * PITCH + 16 * ha]) = a_reg;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint32_t*>(&Bs[buf][(2 * bn + j) * PITCH + 4 * bk]) = b_reg[j];
  };

  // warp tile: pixels 32 * wm .. +31, channels 32 * wn .. +31
  const int wm = warp & 3, wn = warp >> 2;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], &As[buf][(32 * wm + 16 * mi + (lane & 15)) * PITCH + (lane >> 4) * 16]);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      ldmatrix_x4(r, &Bs[buf][(32 * wn + 16 * nj + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                              ((lane >> 3) & 1) * 16]);
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    if (step + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // accumulator e of tile (mi, ni): pixel row g (+8 for e >= 2), channels 2t, 2t + 1
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + 32 * wm + 16 * mi + g + 8 * half;
      if (row >= m_total) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = co0 + 32 * wn + 8 * ni + 2 * t;
        if (co >= sh.co) continue;
        const bool second = co + 1 < sh.co;
        store2<OUT>(y, row * sh.co + co, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1], v, co,
                    second && (sh.co % 2 == 0), second);
      }
    }
}

template <bool VEC>
cudaError_t launch_out(const int8_t* x, const int8_t* w, const float* v, void* y, const Shape& sh,
                       int out_kind, cudaStream_t stream) {
  const long long m_total = static_cast<long long>(sh.n) * sh.oh * sh.ow;
  const dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM), (sh.co + BN - 1) / BN);
  if (out_kind == OUT_S32)
    conv_i8_kernel<VEC, OUT_S32><<<grid, THREADS, 0, stream>>>(x, w, v, y, sh);
  else if (out_kind == OUT_F32)
    conv_i8_kernel<VEC, OUT_F32><<<grid, THREADS, 0, stream>>>(x, w, v, y, sh);
  else
    conv_i8_kernel<VEC, OUT_BF16><<<grid, THREADS, 0, stream>>>(x, w, v, y, sh);
  return cudaGetLastError();
}

}  // namespace

// x (n, h, wd, ci) int8 NHWC, contiguous; w (k, k, ci, co) int8 HWIO rows of
// co contiguous, taps w_tap_stride elements apart (a slice along the input
// channels); y (n, oh, ow, co) contiguous, oh = (h + 2p - k) / s + 1: int32
// sums (out_kind 0), or float(sum) * v[co] in f32 (1) or bf16 (2), v (co,)
// f32. Refuses, with cudaErrorInvalidValue, what it does not take.
extern "C" int mg_conv_i8(const void* x, const void* w, const void* v, void* y, int n, int h,
                          int wd, int ci, int co, int k, int s, int p, long long w_tap_stride,
                          int out_kind, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ci <= 0 || co <= 0 || k <= 0 || s <= 0 || p < 0 ||
      out_kind < OUT_S32 || out_kind > OUT_BF16 || (out_kind != OUT_S32 && v == nullptr) ||
      (co + BN - 1) / BN > 65535 || h + 2 * p < k || wd + 2 * p < k)
    return cudaErrorInvalidValue;
  const Shape sh{n, h, wd, ci, co, k, s, p, (h + 2 * p - k) / s + 1, (wd + 2 * p - k) / s + 1,
                 w_tap_stride};
  const auto xs = static_cast<const int8_t*>(x);
  const auto ws = static_cast<const int8_t*>(w);
  const auto vs = static_cast<const float*>(v);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ci % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_out<true>(xs, ws, vs, y, sh, out_kind, st);
  return launch_out<false>(xs, ws, vs, y, sh, out_kind, st);
}
