// int8 x int8 -> int32 convolution, NHWC x, any square kernel k, stride
// s and zero padding p, with one epilogue for every caller: the int32
// sums, or in f32 or bf16
//   y = relu?( [y_in +] cast(float(acc) * (sx * scale[co])) [+ cast(bias[co])] )
// rounded where torch rounds the int8 layers' sequence (see finish).
//
// Per-side H padding: pad_top and pad_bottom (0..p each; p, p is the
// plain conv, the same launch bit for bit) are the zero rows above and
// below x; where one is below p, x holds the neighbour's rows there
// instead (the halo rows of an H-slab, under -spatial). x has h rows, y
// (h + pad_top + pad_bottom - k) / s + 1, and output row o reads input
// rows o * s - pad_top .. + k - 1. W keeps p on both sides.
//
// Replaces no TPU kernel. The JAX package's int8 serving conv,
// mgtpu/ops/quant.py::conv_i8, is an int8 conv_general_dilated with an
// int32 result that XLA lowers, and XLA fuses the dequant, the part sums
// and the bias of mgtpu/nn.py's int8 branch into its consumers; PyTorch
// has no int8 convolution on CUDA (F.conv2d refuses torch.int8) and runs
// eagerly, so the port writes the conv and that fusion by hand.
//
// Bound on this card: the zoo's 3x3 parts are GEMMs with K = 9*Ci of 144
// to 4608 and enough reuse to be bound by arithmetic on the int8 tensor
// cores (1,979 TOP/s dense); the 7x7/2 stems on 3 channels (K = 147)
// write far more than they compute and are bound by bytes; the 1x1 parts
// at M = 128 move few bytes and are bound by latency.
//
// Four designs of one implicit GEMM, M = N*OH*OW output pixels, N = Co.
// Which one a launch takes is a fixed function of shape and alignment,
// decided by the wrapper (mgtpu_torch/ops/cuda_conv_i8.py::_route); each
// refuses what it does not take, and nothing falls back:
//   sm90   (mg_conv_i8_sm90; section "sm90" below): TMA + wgmma s8, for
//          3x3/s1/p1 with Ci, Co, the weight's total Ci and its slice
//          offset multiples of 16 and 16-byte aligned operands: 152 of
//          R-MG-34's 155 int8 conv parts;
//   stem   (mg_conv_i8_stem, conv_i8_stem.cu): Ci < 16 with k * k * Ci
//          <= 160 and Co 16, 32 or 64, x at any byte offset: the 7x7/2
//          and 3x3 stems on 3 and 1 channels;
//   1x1    (mg_conv_i8_1x1, conv_i8_1x1.cu): 1x1/s1/p0 with Ci, Co and
//          the packed weight's row and offset multiples of 16, x 16-byte
//          aligned: cifar/prnmg's shortcuts and heads;
//   simple (mg_conv_i8): the first design, with a packed K walk, for
//          everything else (unmg's 1x1 heads on 10 channels; any shape
//          through cuda_conv_i8._simple_forward, for comparisons).
// The s32 sums are exact, so no design's result depends on the order of
// its K walk: all equal the plain version bit for bit. The epilogue's
// rounding, finish(), and what the designs share are in conv_i8.cuh.
//
// The simple design: K is walked as the packed slots tap * Ci + c of all
// k*k taps, in steps of 32, on mma.sync m16n8k32 s8 x s8 -> s32. With
// Ci a multiple of 32 a step is 32 channels of one tap (the first walk);
// with Ci = 3 a 7x7 stem takes 5 steps for its 147 slots instead of 49
// steps of 3 used slots. A slot past the end is zero in shared memory,
// and the conv's zero padding is a bounds check on the gather. A block
// computes a 128-pixel x 64-channel tile with 8 warps of 32 x 32; A
// (pixels x 32 slots) and B (channels x 32 slots, transposed from the
// HWIO rows so that both operands are K-contiguous) go through two
// shared-memory stages with 48-byte rows, which ldmatrix reads without
// bank conflicts. The next step's tiles are loaded into registers while
// the current one is multiplied. x is read 16 bytes a thread when Ci is
// a multiple of 16 and x is 16-byte aligned (16 slots are then 16
// channels of one tap), byte by byte otherwise; w byte by byte from its
// HWIO slice (taps w_tap_stride elements apart, rows Co apart).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_i8.cuh"
#include "sm90_async.cuh"

namespace {

using namespace mg_i8;  // Epi, finish, bad_args, mma.sync and ldmatrix

// finish() with its operands loaded here, one element at a time
__device__ __forceinline__ float epilogue(int acc, float sx, const Epi& e, int out,
                                          const void* y_in, long long idx, int co) {
  const bool bf = out == OUT_BF16;
  float prev = 0.f;
  if (y_in != nullptr)
    prev = bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(y_in)[idx])
              : static_cast<const float*>(y_in)[idx];
  return finish(acc, __fmul_rn(sx, __ldg(e.scale + co)), prev,
                e.bias != nullptr ? __ldg(e.bias + co) : 0.f, bf, y_in != nullptr,
                e.bias != nullptr, e.relu);
}

// Two adjacent output channels (co, co + 1) of one pixel at element idx
// of y; pair: both exist and the address is aligned for one vector store
// (Co even); second: co + 1 exists. y_in and y may be the same tensor:
// each element is read before it is written, by the same thread.
__device__ __forceinline__ void store_pair(void* y, const Epi& e, float sx, int out,
                                           long long idx, int co, int a0, int a1, bool pair,
                                           bool second) {
  if (out == OUT_S32) {
    int* p = static_cast<int*>(y) + idx;
    if (pair) {
      *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
    } else {
      p[0] = a0;
      if (second) p[1] = a1;
    }
    return;
  }
  const float f0 = epilogue(a0, sx, e, out, e.y_in, idx, co);
  const float f1 = second ? epilogue(a1, sx, e, out, e.y_in, idx + 1, co + 1) : 0.f;
  if (out == OUT_F32) {
    float* p = static_cast<float*>(y) + idx;
    if (pair) {
      *reinterpret_cast<float2*>(p) = make_float2(f0, f1);
    } else {
      p[0] = f0;
      if (second) p[1] = f1;
    }
  } else {  // f0, f1 hold bf16 values: the conversion is exact
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(y) + idx;
    if (pair) {
      __nv_bfloat162 b;
      b.x = __float2bfloat16_rn(f0);
      b.y = __float2bfloat16_rn(f1);
      *reinterpret_cast<__nv_bfloat162*>(p) = b;
    } else {
      p[0] = __float2bfloat16_rn(f0);
      if (second) p[1] = __float2bfloat16_rn(f1);
    }
  }
}

namespace simple {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K slots per step
constexpr int PITCH = 48;    // bytes per shared-memory row (32 + 16: no bank conflicts)
constexpr int THREADS = 256;

// p pads W on both sides; pad_top is the zero rows above x (its H
// padding below is in oh)
struct Shape {
  int n, h, w, ci, co, k, s, p, pad_top, oh, ow;
  long long tap_stride;
};

// VEC: x is read 16 bytes a thread (Ci % 16 == 0, x 16-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epi e, void* y,
                   int out, Shape sh) {
  __shared__ __align__(16) int8_t As[2][BM * PITCH];
  __shared__ __align__(16) int8_t Bs[2][BN * PITCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per_img = static_cast<long long>(sh.oh) * sh.ow;
  const long long m_total = per_img * sh.n;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int co0 = blockIdx.y * BN;
  const int slots = sh.k * sh.k * sh.ci;  // K, packed: slot = tap * Ci + c
  const int steps = (slots + BK - 1) / BK;

  // the A gather: tile row ra, slots 16 * ha .. +15 of the step
  const int ra = tid >> 1, ha = tid & 1;
  const long long m = m0 + ra;
  const bool m_ok = m < m_total;
  int ih0 = 0, iw0 = 0;
  const int8_t* x_img = x;
  if (m_ok) {
    const int img = static_cast<int>(m / per_img);
    const int r = static_cast<int>(m - img * per_img);
    const int oh = r / sh.ow;
    ih0 = oh * sh.s - sh.pad_top;
    iw0 = (r - oh * sh.ow) * sh.s - sh.p;
    x_img = x + static_cast<long long>(img) * sh.h * sh.w * sh.ci;
  }
  // the B gather: slots 4 * bk .. 4 * bk + 3 of output channels 2 * bn, 2 * bn + 1
  const int bk = tid & 7, bn = tid >> 3;

  uint4 a_reg;
  uint32_t b_reg[2];
  auto load = [&](int step) {
    const int s0 = step * BK + 16 * ha;
    a_reg = make_uint4(0u, 0u, 0u, 0u);
    if (m_ok && s0 < slots) {
      int tap = s0 / sh.ci, c = s0 - tap * sh.ci;
      if (VEC) {  // the 16 slots are channels c .. c + 15 of one tap
        const int kh = tap / sh.k, ih = ih0 + kh, iw = iw0 + tap - kh * sh.k;
        if (ih >= 0 && ih < sh.h && iw >= 0 && iw < sh.w)
          a_reg = __ldg(reinterpret_cast<const uint4*>(
              x_img + (static_cast<long long>(ih) * sh.w + iw) * sh.ci + c));
      } else {  // (kh, kw, c) of each slot stepped along, no division in the loop
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
        int kh = tap / sh.k, kw = tap - kh * sh.k;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int ih = ih0 + kh, iw = iw0 + kw;
          if (s0 + j < slots && ih >= 0 && ih < sh.h && iw >= 0 && iw < sh.w)
            wd[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(
                              x_img + (static_cast<long long>(ih) * sh.w + iw) * sh.ci + c)))
                          << (8 * (j & 3));
          if (++c == sh.ci) {
            c = 0;
            if (++kw == sh.k) kw = 0, ++kh;
          }
        }
        a_reg = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
    const int sb = step * BK + 4 * bk;
    int tap = sb / sh.ci, c = sb - tap * sh.ci;
    b_reg[0] = b_reg[1] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (sb + i < slots) {
        const int8_t* row = w + tap * sh.tap_stride + static_cast<long long>(c) * sh.co;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = co0 + 2 * bn + j;
          if (co < sh.co)
            b_reg[j] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + co))) << (8 * i);
        }
      }
      if (++c == sh.ci) c = 0, ++tap;
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
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

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

  // accumulator q of tile (mi, ni): pixel row g (+8 for q >= 2), channels 2t, 2t + 1
  const float sx = out == OUT_S32 ? 0.f : __ldg(e.sx);
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
        store_pair(y, e, sx, out, row * sh.co + co, co, acc[mi][ni][2 * half],
                   acc[mi][ni][2 * half + 1], second && (sh.co % 2 == 0), second);
      }
    }
}

int launch(const int8_t* x, const int8_t* w, const Epi& e, void* y, int out, const Shape& sh,
           cudaStream_t stream) {
  const long long m_total = static_cast<long long>(sh.n) * sh.oh * sh.ow;
  const dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM), (sh.co + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (sh.ci % 16 == 0 && aligned(x, 16))
    conv_i8_kernel<true><<<grid, THREADS, 0, stream>>>(x, w, e, y, out, sh);
  else
    conv_i8_kernel<false><<<grid, THREADS, 0, stream>>>(x, w, e, y, out, sh);
  return cudaGetLastError();
}

}  // namespace simple

// ================================================================ sm90
//
// The sm90 design: a warp-specialized, persistent implicit GEMM for
// Hopper (sm_90a), s8 operands, s32 accumulators, for 3x3/s1/p1 parts.
// It follows conv3x3.cu's sm90 design, with what int8 changes:
//   A: x through an im2col tensor map (C, W, H, N) of bytes. One load
//      brings the 128 pixels m0..m0+127 of a tile at one tap and BK
//      channels: 128 rows of BK bytes, swizzled by TMA's mode of that
//      width (BK = 128, 64 or 32: the largest that divides Ci, 32 for
//      Ci = 16). TMA's zero fill is the conv's padding and the rows past
//      the last image.
//   B: wgmma takes 8-bit operands K-major only, so the HWIO weight
//      (rows of Co) cannot be read as an MN-major B as the bf16 design
//      reads it. The wrapper passes a K-major copy, (Co, 9, Ci_total)
//      bytes, packed once per weight (Conv.set_quantized); a part's
//      slice is channels [ofs, ofs + Ci) of each tap, addressed by a
//      tiled map (Ci, 9, Co) over that buffer from channel ofs with
//      byte strides (Ci_total, 9 * Ci_total): boxes of BK channels x BN
//      output channels, swizzled as A.
//   Ci = 16 is below wgmma's 32-byte depth: its channel box is 32 bytes
//      anyway, and TMA fills channels 16..31 of x and of the weight with
//      zeros (out of the maps' bounds), so the extra products add 0.
// Math: two consumer warpgroups each run wgmma m64nBNk32 s8.s8.s32 on
// their 64 rows of the tile, BK/32 per tap and stage, one stage's group
// in flight while the next is awaited; setmaxnreg moves registers from
// the producer warpgroup (40) to the consumers (232). The accumulators
// are exact, so the result equals the simple design's bit for bit. (Two
// warpgroups on alternate whole tiles, so that one's epilogue overlaps
// the other's products, measured slower: 5.42 against 5.09 ms a batch-128
// R-MG-34 forward, the 7x7 parts up to 1.7x, the rest unchanged.)
// Epilogue (store_tile): each warpgroup's 64 x BN tile goes through its
// own staging tile in shared memory, 128 bytes of channels at a time: the
// part sum y_in (read where y is written; its first block loaded into
// registers when the tile starts, so the loads land during the products)
// and the result move in coalesced 16-byte accesses, and finish() runs on
// the staged values. (Bulk copies of the part sum's rows, issued when
// the tile starts, measured slower: 5.21 ms against 4.47.)
// Schedule: persistent, grid = min(tiles, SMs), tiles walked with Co
// fastest. Tile 128 pixels x BN channels, BN 128, 64 or 32 (pick_bn:
// 32 for Co <= 32, 64 for Co <= 64, else as conv3x3's sm90 picks).
// Ring: a stage holds one tap's (BK = 128) or three taps' (BK = 64, 32)
// A and B tiles, so a barrier round trip feeds 96 to 192 bytes of K to
// the products (one tap a stage measured 1% slower in all, 3% at the
// 56x56 parts on 32 channels); as many stages as fit 192 KB (at most 8):
// 6 of 32 KB at BK = BN = 128, 4 of 48 KB at BK = 64, BN = 128; then the
// two 9 KB staging tiles.
namespace sm90 {

using namespace mg_async;  // the mbarrier (bar_wait traps), TMA, wgmma and register helpers

constexpr int BM = 128;       // output pixels per tile: two consumer warpgroups x 64 rows
constexpr int THREADS = 384;  // warpgroup 0 loads; warpgroups 1 and 2 compute
constexpr int RING_BUDGET = 192 * 1024;
// a warpgroup's staging tile: 64 rows of 128 bytes (64 bf16 or 32 f32 /
// s32 channels) and 16 of padding, which spreads a warp's writes of its
// 8 rows over the 32 banks
constexpr int STAGING_PITCH = 144;
constexpr int STAGING_BYTES = 64 * STAGING_PITCH;

template <int BK, int BN>
struct Cfg {
  // taps a stage: three with the narrow channel boxes
  static constexpr int TAPS = BK == 128 ? 1 : 3;
  static constexpr int A_SUB = BM * BK, B_SUB = BN * BK;  // one tap's tiles
  static constexpr int A_BYTES = TAPS * A_SUB;
  static constexpr int STAGE_BYTES = TAPS * (A_SUB + B_SUB);
  static constexpr int STAGES = RING_BUDGET / STAGE_BYTES < 8 ? RING_BUDGET / STAGE_BYTES : 8;
  // dynamic shared memory: 1 KB of slack to align the ring, the ring, the
  // two warpgroups' staging tiles, the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGING_BYTES + 2 * STAGES * 8;
  static constexpr uint64_t LAYOUT = BK == 128 ? SWIZZLE_128B : BK == 64 ? SWIZZLE_64B
                                                                         : SWIZZLE_32B;
  // between 8-row groups of a K-major swizzled tile
  static constexpr uint32_t SBO = 8 * BK;
};

// d += A (K-major, shared memory) * B (K-major, shared memory): one
// m64nBNk32 s8 x s8 product with s32 accumulators
template <int BN>
__device__ __forceinline__ void mma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void mma_s8<32>(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// This thread's share of the part sum y_in in one warpgroup's column
// block from channel n0: 16-byte chunks t, t + 128, ... of its 64 rows
// (zeros past M). Coalesced.
template <int BN, int ES>
__device__ __forceinline__ void load_part_sum(uint4 (&v)[4], const void* y_in, int row_base,
                                              int n0, int M, int Co, int t) {
  constexpr int CB = BN < 128 / ES ? BN : 128 / ES;
  constexpr int CHUNKS = CB * ES / 16;
#pragma unroll
  for (int k = 0; k < 64 * CHUNKS / 128; ++k) {
    const int i = t + 128 * k, r = i / CHUNKS, col = n0 + i % CHUNKS * (16 / ES);
    v[k] = row_base + r < M && col < Co
               ? *reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(y_in) +
                                                 ((long long)(row_base + r) * Co + col) * ES)
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// One warpgroup's 64-row x BN tile out of its accumulators, through its
// staging tile in column blocks of 128 bytes (ES: the output's element
// bytes): the block of the part sum y_in goes into the staging tile (the
// first block from `first`, loaded while the products ran; later ones
// loaded here), each thread finishes its elements there, and the block
// goes out by coalesced 16-byte stores. (Stored from the accumulators'
// layout, a warp's store touched 8 rows 16 bytes each: the `sm90`
// launches of a batch-128 R-MG-34 forward took 5.13 ms that way, 4.47
// staged, 4.29 with the first block loaded early; measured on the card.)
// Co % 16 == 0: a 16-byte chunk is all in or all out.
template <int BN, int ES>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], const uint4 (&first)[4],
                                           uint8_t* stg, void* y, const Epi& e, float sx,
                                           int out, int row_base, int n0, int M, int Co, int t,
                                           int barrier) {
  constexpr int CB = BN < 128 / ES ? BN : 128 / ES;  // channels a column block
  constexpr int CHUNKS = CB * ES / 16;                // 16-byte chunks a row of it
  const int lane = t % 32, r_lo = t / 32 * 16 + lane / 4;
  const bool bf = out == OUT_BF16, has_in = e.y_in != nullptr, has_bias = e.bias != nullptr;
#pragma unroll
  for (int c0 = 0; c0 < BN; c0 += CB) {
    if (has_in) {  // the first block's part sum was loaded while the products ran
      uint4 v[4];
      if (c0 == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = first[k];
      } else {
        load_part_sum<BN, ES>(v, e.y_in, row_base, n0 + c0, M, Co, t);
      }
#pragma unroll
      for (int k = 0; k < 64 * CHUNKS / 128; ++k) {
        const int i = t + 128 * k;
        *reinterpret_cast<uint4*>(stg + i / CHUNKS * STAGING_PITCH + i % CHUNKS * 16) = v[k];
      }
      named_sync(barrier, 128);
    }
    // accumulator 4j + 2*half (+1) is row r_lo + 8*half, channel 8j +
    // 2*(lane % 4) (+1) of the tile
#pragma unroll
    for (int jj = 0; jj < CB / 8; ++jj) {
      const int j = c0 / 8 + jj, cl = 8 * jj + 2 * (lane % 4), co = n0 + c0 + cl;
      float v0 = 0.f, v1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (out != OUT_S32 && co < Co) {
        v0 = __fmul_rn(sx, __ldg(e.scale + co));
        v1 = __fmul_rn(sx, __ldg(e.scale + co + 1));
        if (has_bias) b0 = __ldg(e.bias + co), b1 = __ldg(e.bias + co + 1);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint8_t* p = stg + (r_lo + 8 * half) * STAGING_PITCH + cl * ES;
        const int a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
        if (out == OUT_S32) {
          *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
        } else if (bf) {  // the finished values are bf16 values: the conversion is exact
          const __nv_bfloat162 prev = *reinterpret_cast<const __nv_bfloat162*>(p);
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(
              finish(a0, v0, __low2float(prev), b0, true, has_in, has_bias, e.relu),
              finish(a1, v1, __high2float(prev), b1, true, has_in, has_bias, e.relu));
        } else {
          const float2 prev = *reinterpret_cast<const float2*>(p);
          *reinterpret_cast<float2*>(p) =
              make_float2(finish(a0, v0, prev.x, b0, false, has_in, has_bias, e.relu),
                          finish(a1, v1, prev.y, b1, false, has_in, has_bias, e.relu));
        }
      }
    }
    named_sync(barrier, 128);
#pragma unroll
    for (int i = t; i < 64 * CHUNKS; i += 128) {
      const int r = i / CHUNKS, q = i % CHUNKS, col = n0 + c0 + q * (16 / ES);
      if (row_base + r < M && col < Co)
        *reinterpret_cast<uint4*>(static_cast<uint8_t*>(y) +
                                  ((long long)(row_base + r) * Co + col) * ES) =
            *reinterpret_cast<const uint4*>(stg + r * STAGING_PITCH + q * 16);
    }
    named_sync(barrier, 128);  // the staging tile is free again
  }
}

template <int BK, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv_i8_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, Epi e, void* y, int out,
                        int H, int W, int Ci, int Co, int M, int pad_top) {
  using C = Cfg<BK, BN>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzles repeat every 1024 bytes or less: align the stages to it
  uint8_t* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + C::STAGES * C::STAGE_BYTES;  // one tile per consumer warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * STAGING_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x;
  const int n_tiles = (Co + BN - 1) / BN, tiles = (M + BM - 1) / BM * n_tiles;
  const int chunks = (Ci + BK - 1) / BK, k_steps = 9 / C::TAPS * chunks;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      bar_init(saddr(full + s), 1);   // the producer's arrival, plus the bytes of the stage
      bar_init(saddr(empty + s), 2);  // one arrival per consumer warpgroup
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread keeps the ring full, across tiles
    regs_dec<40>();
    if (tid == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        const int img = m0 / (H * W), h = m0 % (H * W) / W, w = m0 % W;
        for (int tap0 = 0; tap0 < 9; tap0 += C::TAPS) {
          for (int c = 0; c < chunks; ++c, ++it) {
            const int s = it % C::STAGES;
            bar_wait(saddr(empty + s), (it / C::STAGES & 1) ^ 1);
            const uint32_t fb = saddr(full + s), a = saddr(ring + s * C::STAGE_BYTES);
            bar_expect_tx(fb, C::STAGE_BYTES);
#pragma unroll
            for (int t = 0; t < C::TAPS; ++t) {
              const int tap = tap0 + t;
              // the base pixel is pad_top rows up (input row h - pad_top:
              // one row up, or the halo row) and one column left of the
              // output pixel; the offsets pick the tap
              load_im2col(a + t * C::A_SUB, &xmap, fb, c * BK, w - 1, h - pad_top, img,
                          (uint16_t)(tap % 3), (uint16_t)(tap / 3));
              load_3d(a + C::A_BYTES + t * C::B_SUB, &wmap, fb, c * BK, tap, n0);
            }
          }
        }
      }
    }
  } else {
    regs_inc<232>();
    const int wg = tid / 128 - 1;  // rows 64*wg.. of each tile
    const int t = tid % 128;
    const float sx = out == OUT_S32 ? 0.f : __ldg(e.sx);
    int acc[BN / 2];
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      // the first column block's part sum, loaded now, in flight during the products
      uint4 part_sum[4] = {};
      if (e.y_in != nullptr) {
        if (out == OUT_BF16)
          load_part_sum<BN, 2>(part_sum, e.y_in, m0 + 64 * wg, n0, M, Co, t);
        else
          load_part_sum<BN, 4>(part_sum, e.y_in, m0 + 64 * wg, n0, M, Co, t);
      }
      for (int k = 0; k < k_steps; ++k, ++it) {
        const int s = it % C::STAGES;
        const uint32_t stage = saddr(ring + s * C::STAGE_BYTES);
        bar_wait(saddr(full + s), it / C::STAGES & 1);
        const uint32_t a = stage + wg * (C::A_SUB / 2), b = stage + C::A_BYTES;
        fence_regs(acc);
        mma_fence();
#pragma unroll
        for (int tp = 0; tp < C::TAPS; ++tp)
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            mma_s8<BN>(acc, gmma_desc(a + tp * C::A_SUB + 32 * kk, 16, C::SBO, C::LAYOUT),
                       gmma_desc(b + tp * C::B_SUB + 32 * kk, 16, C::SBO, C::LAYOUT));
        mma_commit();
        mma_wait<1>();
        fence_regs(acc);
        // the previous step's products are done: release its stage
        if (k > 0 && t == 0) bar_arrive(saddr(empty + (it - 1) % C::STAGES));
      }
      mma_wait<0>();
      fence_regs(acc);
      if (t == 0) bar_arrive(saddr(empty + (it - 1) % C::STAGES));

      uint8_t* stg = staging + wg * STAGING_BYTES;
      if (out == OUT_BF16)
        store_tile<BN, 2>(acc, part_sum, stg, y, e, sx, out, m0 + 64 * wg, n0, M, Co, t, 1 + wg);
      else
        store_tile<BN, 4>(acc, part_sum, stg, y, e, sx, out, m0 + 64 * wg, n0, M, Co, t, 1 + wg);
    }
  }
}

int pick_bn(long long m, int co, int sms) {
  if (co <= 32) return 32;
  if (co <= 64 || co % 128 != 0) return 64;
  const long long m_tiles = (m + BM - 1) / BM;
  const long long w128 = (m_tiles * (co / 128) + sms - 1) / sms;
  const long long w64 = (m_tiles * (co / 64) + sms - 1) / sms;
  return w128 * (128 + 64) <= w64 * (64 + 64) ? 128 : 64;
}

template <int BK, int BN>
int launch_cfg(const CUtensorMap& xmap, const CUtensorMap& wmap, const Epi& e, void* y, int out,
               int h, int wd, int ci, int co, long long m, int pad_top, int dev, int sms,
               cudaStream_t s) {
  using C = Cfg<BK, BN>;
  auto kernel = conv_i8_sm90_kernel<BK, BN>;
  // allow this instantiation its dynamic shared memory, once per device
  static unsigned allowed = 0;
  if (!(allowed >> dev & 1)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1u << dev;
  }
  const long long tiles = (m + BM - 1) / BM * ((co + BN - 1) / BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, C::SMEM, s>>>(xmap, wmap, e, y, out, h, wd, ci, co, (int)m, pad_top);
  return (int)cudaGetLastError();
}

template <int BK>
int launch_bk(const CUtensorMap& xmap, const CUtensorMap& wmap, const Epi& e, void* y, int out,
              int h, int wd, int ci, int co, long long m, int pad_top, int dev, int sms,
              cudaStream_t s) {
  switch (pick_bn(m, co, sms)) {
    case 32:
      return launch_cfg<BK, 32>(xmap, wmap, e, y, out, h, wd, ci, co, m, pad_top, dev, sms, s);
    case 64:
      return launch_cfg<BK, 64>(xmap, wmap, e, y, out, h, wd, ci, co, m, pad_top, dev, sms, s);
    default:
      return launch_cfg<BK, 128>(xmap, wmap, e, y, out, h, wd, ci, co, m, pad_top, dev, sms, s);
  }
}

// w: the K-major packed weight (Co, 9, ci_total) bytes from the slice's
// first input channel; ci_total (the tap stride) and that offset
// multiples of 16. x has h rows, y oh = h - 2 + pad_top + pad_bottom
// (pads 0 or 1: the caller checks)
int launch(const void* x, const void* w, const Epi& e, void* y, int out, int n, int h, int wd,
           int ci, int co, long long ci_total, int pad_top, int pad_bottom, cudaStream_t s) {
  const int oh = h - 2 + pad_top + pad_bottom;
  const long long m = (long long)n * oh * wd;
  if (ci % 16 != 0 || co % 16 != 0 || ci_total % 16 != 0 || ci_total < ci || !aligned(x, 16) ||
      !aligned(w, 16) || m >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  static const auto tiled = reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
  static const auto im2col =
      reinterpret_cast<EncodeIm2col>(driver_fn("cuTensorMapEncodeIm2col"));
  if (!tiled || !im2col) return (int)cudaErrorNotSupported;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;

  // the channel box: the largest of 128, 64, 32 bytes that divides Ci (32
  // for Ci = 16, zero-filled past Ci), with TMA's swizzle of that width
  const int bk = ci % 128 == 0 ? 128 : ci % 64 == 0 ? 64 : 32;
  const CUtensorMapSwizzle swz = bk == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, wmap;
  // x (C, W, H, N), im2col: bk channels of 128 pixels per load; the
  // bounding box of the base pixel (corners {W, H}) runs from -1 to W - 2
  // in W and from -pad_top to h - 3 + pad_bottom (= oh - 1 - pad_top) in
  // H: oh positions, so M stays N*oh*W output pixels, and TMA's zero fill
  // outside x is the padding on the sides that have it (a halo row is
  // inside x, and loaded)
  const cuuint64_t xdim[4] = {(cuuint64_t)ci, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xstride[3] = {(cuuint64_t)ci, (cuuint64_t)ci * wd, (cuuint64_t)ci * wd * h};
  const int lower[2] = {-1, -pad_top}, upper[2] = {-1, -1 - (1 - pad_bottom)};
  CUresult r = im2col(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), xdim,
                      xstride, lower, upper, (cuuint32_t)bk, BM, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // w (Ci, 9 taps, Co) of the packed slice, tiled: bk channels x BN rows
  // (the box's row count is the launch's BN: pick_bn, as launch_bk picks)
  const cuuint64_t wdim[3] = {(cuuint64_t)ci, 9, (cuuint64_t)co};
  const cuuint64_t wstride[2] = {(cuuint64_t)ci_total, 9ull * ci_total};
  const cuuint32_t wbox[3] = {(cuuint32_t)bk, 1, (cuuint32_t)pick_bn(m, co, sms)};
  if (r == CUDA_SUCCESS)
    r = tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), wdim, wstride,
              wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (bk == 128)
    return launch_bk<128>(xmap, wmap, e, y, out, oh, wd, ci, co, m, pad_top, dev, sms, s);
  if (bk == 64)
    return launch_bk<64>(xmap, wmap, e, y, out, oh, wd, ci, co, m, pad_top, dev, sms, s);
  return launch_bk<32>(xmap, wmap, e, y, out, oh, wd, ci, co, m, pad_top, dev, sms, s);
}

}  // namespace sm90

}  // namespace

// Both entry points take the same arguments (as do mg_conv_i8_1x1, and
// mg_conv_i8_stem with its plan after them). x (n, h, wd, ci) int8 NHWC,
// contiguous; y (n, oh, ow, co) contiguous, oh = (h + pad_top +
// pad_bottom - k) / s + 1, ow = (wd + 2p - k) / s + 1 (pad_top and
// pad_bottom 0..p; p, p the plain conv):
// the int32 sums (out_kind 0), or the epilogue above in f32 (1) or bf16
// (2) with sx (1,) and scale (co,) f32, y_in (the output type, y's shape;
// may be y) and bias (co,) f32 optional (null), relu 0 or 1. Each returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it refuses.
//
// The simple design: w (k, k, ci, co) int8 HWIO rows of co contiguous,
// taps w_tap_stride elements apart (a slice along the input channels).
extern "C" int mg_conv_i8(const void* x, const void* w, const void* sx, const void* scale,
                          const void* y_in, const void* bias, void* y, int n, int h, int wd,
                          int ci, int co, int k, int s, int p, long long w_tap_stride,
                          int out_kind, int relu, int pad_top, int pad_bottom, void* stream) {
  const Epi e{static_cast<const float*>(sx), static_cast<const float*>(scale), y_in,
              static_cast<const float*>(bias), relu};
  if (bad_args(e, y, n, h, wd, ci, co, k, s, p, pad_top, pad_bottom, out_kind))
    return cudaErrorInvalidValue;
  const simple::Shape sh{n, h, wd, ci, co, k, s, p, pad_top,
                         (h + pad_top + pad_bottom - k) / s + 1, (wd + 2 * p - k) / s + 1,
                         w_tap_stride};
  return simple::launch(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), e, y,
                        out_kind, sh, static_cast<cudaStream_t>(stream));
}

// The sm90 design, 3x3/s1/p1 only (pad_top, pad_bottom 0 or 1): w the
// K-major packed weight (co, 9, w_tap_stride) bytes, from the slice's
// first input channel (w_tap_stride: the whole weight's input channels).
extern "C" int mg_conv_i8_sm90(const void* x, const void* w, const void* sx, const void* scale,
                               const void* y_in, const void* bias, void* y, int n, int h,
                               int wd, int ci, int co, int k, int s, int p,
                               long long w_tap_stride, int out_kind, int relu, int pad_top,
                               int pad_bottom, void* stream) {
  const Epi e{static_cast<const float*>(sx), static_cast<const float*>(scale), y_in,
              static_cast<const float*>(bias), relu};
  if (bad_args(e, y, n, h, wd, ci, co, k, s, p, pad_top, pad_bottom, out_kind) || k != 3 ||
      s != 1 || p != 1)
    return cudaErrorInvalidValue;
  return sm90::launch(x, w, e, y, out_kind, n, h, wd, ci, co, w_tap_stride, pad_top, pad_bottom,
                      static_cast<cudaStream_t>(stream));
}
