// 3x3, stride 1, pad 1 convolution, NHWC x / HWIO w, bf16 and f32,
// with an f32 accumulator that starts at the bias, an optional ReLU and
// an optional per-channel (sum, sum of squares) epilogue; optionally
// with a BatchNorm-apply + ReLU prologue on its input.
//
// Replaces: mgtpu/ops/pallas_conv.py::conv3x3 (kernel bodies
// _conv_rows_kernel and _conv_slab_kernel) as mg_conv3x3 and
// mg_conv3x3_sm90, and pallas_conv.py::conv3x3_bn_relu_in (body
// _conv_slab_pro_kernel) as mg_conv3x3_bn_relu_in and
// mg_conv3x3_bn_relu_in_sm90. Same functions; not a block-by-block copy.
//
// Bound on this card: at the multigrid's shapes (Ci, Co in 16..512,
// K = 9*Ci) the conv is a GEMM with enough reuse to be bound by
// arithmetic, not by device memory, so bf16 belongs on the tensor cores
// (989 TFLOP/s dense) and f32 on the CUDA cores (67 TFLOP/s).
//
// Two designs of one implicit GEMM, M = N*H*W output pixels, N = Co and
// K = 9*Ci, walked as 9 taps x Ci chunks. The HWIO weight is already a
// (9*Ci, Co) row-major matrix; the exchange passes a slice of a wider
// weight along Ci, so taps are w_tap_stride elements apart. Which design
// a launch takes is a fixed function of dtype, shape and alignment,
// decided by the wrapper (mgtpu_torch/ops/cuda_conv.py::_route):
//   sm90  (mg_conv3x3_sm90, mg_conv3x3_bn_relu_in_sm90; section "sm90"
//         below): TMA + wgmma, for bf16 with Ci and Co multiples of 64
//         and 16-byte aligned x and w: every large shape of R-MG-34;
//   tile  (mg_conv3x3, mg_conv3x3_bn_relu_in): the first design, for
//         everything else (narrow channel counts, f32).
//
// The tile design. A block
// computes a 64-pixel x 64-channel output tile, staging A (gathered on
// the fly from NHWC x) and B through shared memory. The conv's zero
// padding is a bounds check on the gather: no padded copy of x is made
// (the Pallas kernel pads in device memory, pallas_conv.py::_pad_input).
// Every tail (pixels, Ci, Co) is masked.
// The prologue (PRO) changes only the gather of A: an in-image tap
// becomes max(x*scale[ci] + shift[ci], 0), computed in f32 and rounded
// to the operand type before the tile; an out-of-image tap stays 0, not
// relu(shift): pad positions are not activations (the Pallas kernel
// forces its halo back to zero for the same reason). The normalized
// input never goes to device memory. It adds two f32 loads (L1-cached),
// a multiply and an add per gathered element: small against the 2*Co
// flops that each gathered element feeds.
//   bf16: 4 warps, each a 32x32 sub-tile of 2x2 WMMA 16x16x16 bf16
//         products with f32 accumulators; K chunks of 32 channels,
//         loaded 16 bytes a thread when Ci and Co are multiples of 8
//         (every shape of R-MG-34), element by element otherwise. One
//         shared-memory stage, loaded synchronously.
//   f32:  256 threads, each a 4x4 sub-tile of FMAs, K chunks of 16.
// The stats replace the Pallas kernel's accumulation across its
// sequential grid, which a GPU does not have: each block reduces its
// tile's per-channel sums in shared memory and adds them into the
// (2, Co) f32 output with atomicAdd, so their summation order varies
// from run to run.

#include <cuda.h>  // CUtensorMap and its encoders' types (fetched at run time, no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "sm90_async.cuh"

namespace {

constexpr int BM = 64;  // output pixels per block
constexpr int BN = 64;  // output channels per block

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// (image, row, column) of output pixel m; ok is false past the last pixel
struct Pixel {
  int img, h, w;
  bool ok;
};

__device__ __forceinline__ Pixel pixel(long long m, long long M, int H, int W) {
  Pixel p;
  p.ok = m < M;
  const long long mm = p.ok ? m : 0;
  p.w = (int)(mm % W);
  p.h = (int)((mm / W) % H);
  p.img = (int)(mm / ((long long)W * H));
  return p;
}

// ReLU (NaN stays NaN, as in jnp.maximum), store, and per-channel sums of
// the f32 values for the stats
template <typename T>
__device__ __forceinline__ float finish(float v, int relu, T* dst) {
  if (relu && v < 0.f) v = 0.f;
  *dst = from_f32<T>(v);
  return v;
}

// BN-apply + ReLU of the prologue, rounded as x*scale + shift is in
// plain f32 (a product, then a sum: no fused multiply-add); NaN stays
// NaN, as in jnp.maximum
__device__ __forceinline__ float bn_relu(float v, const float* scale, const float* shift, int c) {
  v = __fadd_rn(__fmul_rn(v, __ldg(scale + c)), __ldg(shift + c));
  return v < 0.f ? 0.f : v;
}

// ---------------------------------------------------------------- bf16

constexpr int WK = 32;            // input channels per K chunk
constexpr int WTHREADS = 128;     // 4 warps, 2x2 over the 64x64 tile
constexpr int A_LD = WK + 8;      // padded leading dims (multiples of 8
constexpr int B_LD = BN + 8;      // elements, as WMMA needs)
constexpr int C_LD = BN + 4;

template <bool VEC, bool PRO>
__global__ void __launch_bounds__(WTHREADS)
conv3x3_wmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ scale,
                    const float* __restrict__ shift, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ stats, int H, int W, int Ci, int Co, long long M,
                    long long w_tap_stride, int relu, int with_stats) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM][A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[WK][B_LD];
  __shared__ __align__(32) float Cs[BM][C_LD];
  __shared__ float red[2][BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // this warp's 32x32 sub-tile
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // accumulators start at the bias: broadcast it down a tile, load that
  for (int i = tid; i < BM * BN; i += WTHREADS) {
    const int n = n0 + i % BN;
    Cs[i / BN][i % BN] = n < Co ? bias[n] : 0.f;
  }
  if (tid < 2 * BN) red[tid / BN][tid % BN] = 0.f;
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(acc[i][j], &Cs[wm * 32 + i * 16][wn * 32 + j * 16], C_LD,
                             wmma::mem_row_major);

  // this thread stages 8-channel groups v = tid + 128*r (r < 2) of A
  // (row v/4, channels 8*(v%4)..) and of B (row v/8, channels 8*(v%8)..)
  Pixel ap[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) ap[r] = pixel(m0 + (tid + WTHREADS * r) / 4, M, H, W);

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const __nv_bfloat16* wt = w + tap * w_tap_stride;
    for (int ci0 = 0; ci0 < Ci; ci0 += WK) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = tid + WTHREADS * r;
        const int row = v / 4, k = (v % 4) * 8;
        const int hh = ap[r].h + dh, ww = ap[r].w + dw;
        const bool in = ap[r].ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
        const __nv_bfloat16* src = x + (((long long)ap[r].img * H + hh) * W + ww) * Ci + ci0 + k;
        if (VEC) {
          uint4 val = make_uint4(0, 0, 0, 0);
          if (in && ci0 + k < Ci) {
            val = *reinterpret_cast<const uint4*>(src);
            if (PRO) {
              __nv_bfloat16* e8 = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                e8[e] = __float2bfloat16(
                    bn_relu(__bfloat162float(e8[e]), scale, shift, ci0 + k + e));
            }
          }
          *reinterpret_cast<uint4*>(&As[row][k]) = val;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            __nv_bfloat16 a = __float2bfloat16(0.f);
            if (in && ci0 + k + e < Ci) {
              a = src[e];
              if (PRO) a = __float2bfloat16(bn_relu(__bfloat162float(a), scale, shift, ci0 + k + e));
            }
            As[row][k + e] = a;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = tid + WTHREADS * r;
        const int row = v / 8, n = (v % 8) * 8;
        const bool in = ci0 + row < Ci;
        const __nv_bfloat16* src = wt + (long long)(ci0 + row) * Co + n0 + n;
        if (VEC) {
          uint4 val = make_uint4(0, 0, 0, 0);
          if (in && n0 + n < Co) val = *reinterpret_cast<const uint4*>(src);
          *reinterpret_cast<uint4*>(&Bs[row][n]) = val;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            Bs[row][n + e] = in && n0 + n + e < Co ? src[e] : __float2bfloat16(0.f);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue through shared memory: thread t owns channel t % 64 of rows
  // t / 64 + 2*r, so its stores along a row are coalesced
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  const int col = tid % BN, n = n0 + col;
  float psum = 0.f, psq = 0.f;
  if (n < Co) {
    for (int row = tid / BN; row < BM; row += WTHREADS / BN) {
      const long long m = m0 + row;
      if (m >= M) break;
      const float v = finish(Cs[row][col], relu, &y[m * Co + n]);
      psum += v;
      psq += v * v;
    }
  }
  if (with_stats) {
    if (n < Co) {
      atomicAdd(&red[0][col], psum);
      atomicAdd(&red[1][col], psq);
    }
    __syncthreads();
    if (tid < BN && n0 + tid < Co) {
      atomicAdd(&stats[n0 + tid], red[0][tid]);
      atomicAdd(&stats[Co + n0 + tid], red[1][tid]);
    }
  }
}

// ----------------------------------------------------------------- f32

constexpr int FK = 16;  // input channels per K chunk
constexpr int FTHREADS = 256;

template <bool PRO>
__global__ void __launch_bounds__(FTHREADS)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ y,
                   float* __restrict__ stats, int H, int W, int Ci, int Co, long long M,
                   long long w_tap_stride, int relu, int with_stats) {
  __shared__ float As[FK][BM + 1];  // +1: the transposed store hits distinct banks
  __shared__ float Bs[FK][BN];
  __shared__ float red[2][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  if (tid < 2 * BN) red[tid / BN][tid % BN] = 0.f;

  // this thread gathers A rows ty + 16*i (i < 4), input channel ci0 + tx
  Pixel ap[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ap[i] = pixel(m0 + ty + 16 * i, M, H, W);
  // ... and B rows tid/64 + 4*i (i < 4), output channel n0 + tid%64
  const int b_col = tid % BN, b_row = tid / BN;
  const bool b_ok = n0 + b_col < Co;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    const float b0 = n < Co ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = b0;
  }

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const float* wt = w + tap * w_tap_stride;
    for (int ci0 = 0; ci0 < Ci; ci0 += FK) {
      const int ci = ci0 + tx;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hh = ap[i].h + dh, ww = ap[i].w + dw;
        float v = 0.f;
        if (ap[i].ok && ci < Ci && hh >= 0 && hh < H && ww >= 0 && ww < W) {
          v = x[(((long long)ap[i].img * H + hh) * W + ww) * Ci + ci];
          if (PRO) v = bn_relu(v, scale, shift, ci);
        }
        As[tx][ty + 16 * i] = v;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = b_row + 4 * i;
        float v = 0.f;
        if (b_ok && ci0 + k < Ci) v = wt[(long long)(ci0 + k) * Co + n0 + b_col];
        Bs[k][b_col] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float psum[4] = {0.f, 0.f, 0.f, 0.f}, psq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Co) continue;
      const float v = finish(acc[i][j], relu, &y[m * Co + n]);
      psum[j] += v;
      psq[j] += v * v;
    }
  }
  if (with_stats) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + tx + 16 * j < Co) {
        atomicAdd(&red[0][tx + 16 * j], psum[j]);
        atomicAdd(&red[1][tx + 16 * j], psq[j]);
      }
    }
    __syncthreads();
    if (tid < BN && n0 + tid < Co) {
      atomicAdd(&stats[n0 + tid], red[0][tid]);
      atomicAdd(&stats[Co + n0 + tid], red[1][tid]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <bool PRO>
int launch(const void* x, const void* w, const void* b, const void* scale, const void* shift,
           void* y, void* stats, int n, int h, int wd, int ci, int co, long long w_tap_stride,
           int relu, int with_stats, int is_bf16, cudaStream_t s) {
  const long long m = (long long)n * h * wd;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  const float* bias = static_cast<const float*>(b);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* st = static_cast<float*>(stats);
  if (is_bf16) {
    auto xb = static_cast<const __nv_bfloat16*>(x);
    auto wb = static_cast<const __nv_bfloat16*>(w);
    auto yb = static_cast<__nv_bfloat16*>(y);
    // 16-byte loads need every 8-channel group of x and w on a 16-byte boundary
    const bool vec = ci % 8 == 0 && co % 8 == 0 && w_tap_stride % 8 == 0 && aligned16(x) &&
                     aligned16(w);
    if (vec)
      conv3x3_wmma_kernel<true, PRO><<<grid, WTHREADS, 0, s>>>(
          xb, wb, bias, sc, sh, yb, st, h, wd, ci, co, m, w_tap_stride, relu, with_stats);
    else
      conv3x3_wmma_kernel<false, PRO><<<grid, WTHREADS, 0, s>>>(
          xb, wb, bias, sc, sh, yb, st, h, wd, ci, co, m, w_tap_stride, relu, with_stats);
  } else {
    conv3x3_fma_kernel<PRO><<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias, sc, sh,
        static_cast<float*>(y), st, h, wd, ci, co, m, w_tap_stride, relu, with_stats);
  }
  return (int)cudaGetLastError();
}

// ================================================================ sm90
//
// The sm90 design: a warp-specialized, persistent implicit GEMM for
// Hopper (sm_90a), bf16 operands, f32 accumulators. Same function as the
// tile design, for the routed shapes.
//
// Bound on this card: arithmetic. At 128x14x14x256->256 (29.6 GFLOP)
// x and y are 12.8 MB each: moving them takes ~8 us at 3.35 TB/s, the
// math ~30 us at the 989 TFLOP/s bf16 dense peak. The tile design runs at
// 72-102 TFLOP/s on the large shapes: legacy mma.sync through WMMA, one
// synchronous shared-memory stage, 64x64 tiles.
//
// Copies by TMA, into a ring of shared-memory stages guarded by mbarrier
// full/empty pairs; one producer thread keeps the ring full.
//   A: x through an im2col tensor map (C, W, H, N). One load brings the
//      128 pixels m0..m0+127 of a tile (in N*H*W order) at one tap
//      (offsets kw, kh) and 64 channels: 128 rows of 128 bytes, 128-byte
//      swizzled. The map's bounding box (corners -1, -1) walks a pixel
//      along W, then H, then N, and TMA fills every element outside the
//      image with zero: that fill is the conv's padding, and rows past
//      the last image are zero too. No padded copy of x, no bounds check
//      in the loop. im2col, and not a spatial box of a 4-D tiled map,
//      because it tiles M linearly: on the 7x7 and 14x14 grids a spatial
//      box of 128 rows holds 98 useful pixels.
//   B: the HWIO weight (or its slice) through a tiled map (Co, Ci, 9)
//      with byte strides (2*Co, 2*w_tap_stride): boxes of 64 output
//      channels x 64 rows of K, Co contiguous. wgmma reads that as an
//      MN-major ("transposed") B, which it takes for 16-bit types: no
//      K-major copy is made, at no cost.
// Math by wgmma: two consumer warpgroups each run m64nBNk16 (bf16 in,
// f32 accumulate) on their 64 rows of the 128-row tile, four per
// 64-channel K step, with one step's group in flight while the next
// stage is awaited. setmaxnreg moves registers from the producer
// warpgroup (40 a thread) to the consumers (232): 128*40 + 256*232 fits
// the 65,536 a block of 384 threads holds at 168 a thread.
// Epilogue: the accumulators start at the bias of their column; then the
// optional ReLU; then the stats (rows reduced by shuffles, warps by
// shared-memory atomics into a per-block (2, Co) sum, flushed with one
// atomicAdd per channel per block at the end); then y in bf16 through a
// swizzled staging tile and a TMA store, which clips rows past M.
// Schedule: persistent, grid = min(tiles, SMs), tiles walked with Co
// fastest, so the producer loads the next tile while the consumers
// finish the last one, and blocks in flight share their A tiles in L2.
// Tile: 128 pixels x BN channels, BN 128 or 64, chosen per launch from
// the waves each gives on the card's SMs (pick_bn): 128 at 14x14x256->256
// (392 tiles, 2.97 waves on 132 SMs), 64 where Co is 64 or 128-wide
// tiles leave SMs idle (7x7x128->128: 98 tiles instead of 49).
// Ring and budget: a stage holds A (16 KB) and B (BN*128 bytes): 5
// stages at BN 128 (160 KB), 7 at BN 64 (168 KB); plus the staging tile
// (BM*BN bf16), the stats sum (2*Co f32) and the prologue's scale and
// shift (2*Ci f32): 206 KB of dynamic shared memory at Ci = Co = 512
// (R-MG-34's widest), 225 KB at MAX_C, of the 227 KB a block may hold;
// one block an SM.
// The prologue (PRO): once a stage lands, each consumer thread rewrites
// its four 16-byte chunks of its warpgroup's A rows in place as
// max(x*scale + shift, 0) (f32, a product then a sum, as bn_relu above,
// rounded to bf16), then fences the generic-proxy writes for wgmma.
// TMA's zero fill cannot tell the halo from an activation that is 0, so
// the halo is masked by position (tile origin + row + tap) and stays 0.
namespace sm90 {

constexpr int BM = 128;       // output pixels per tile: two consumer warpgroups x 64 rows
constexpr int BK = 64;        // input channels per K step: one 128-byte swizzled row
constexpr int THREADS = 384;  // warpgroup 0 loads; warpgroups 1 and 2 compute
constexpr int A_BYTES = BM * BK * 2;
constexpr int BOX_BYTES = 64 * 64 * 2;  // one 64x64 bf16 TMA box
constexpr int MAX_C = 2048;  // the block keeps 2*Co + 2*Ci floats in shared memory

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 128 ? 5 : 7;
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int OUT_BYTES = BM * BN * 2;
  static constexpr int BAR_BYTES = 2 * STAGES * 8;
  // dynamic shared memory of a launch, with 1 KB of slack to align the base
  static size_t smem(int ci, int co) {
    return 1024 + RING_BYTES + OUT_BYTES + BAR_BYTES + 8 * (size_t)co + 8 * (size_t)ci;
  }
};

using namespace mg_async;  // saddr, the mbarrier helpers (bar_wait traps)

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

__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the stores committed so far have read their shared-memory source
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// wgmma shared-memory matrix descriptor for a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
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

// d += A (K-major, from shared memory) * B (MN-major, from shared memory):
// one m64nBNk16 bf16 product with f32 accumulators
template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// bn_relu of two packed bf16 values (low half first), rounded back to
// bf16: the ReLU in the conversion, which keeps NaN a NaN
__device__ __forceinline__ uint32_t bn_relu2(uint32_t v, float s0, float s1, float h0, float h1) {
  const float a0 = __fadd_rn(__fmul_rn(__uint_as_float(v << 16), s0), h0);
  const float a1 = __fadd_rn(__fmul_rn(__uint_as_float(v & 0xffff0000u), s1), h1);
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(a1), "f"(a0));
  return r;
}

template <int BN, bool PRO>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    float* __restrict__ stats, int H, int W, int Ci, int Co, int M, int relu,
                    int with_stats) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* out = ring + C::RING_BYTES;  // staging tile of y, 64 rows per consumer warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(out + C::OUT_BYTES);
  uint64_t* empty = full + C::STAGES;
  float* ssum = reinterpret_cast<float*>(empty + C::STAGES);  // (2, Co): this block's stats
  float* bnp = ssum + 2 * Co;                                  // scale (Ci), then shift (Ci)

  const int tid = threadIdx.x;
  const int n_tiles = Co / BN, tiles = (M + BM - 1) / BM * n_tiles;
  const int chunks = Ci / BK, k_steps = 9 * chunks;

  for (int i = tid; i < 2 * Co; i += THREADS) ssum[i] = 0.f;
  if (PRO) {
    for (int i = tid; i < Ci; i += THREADS) {
      bnp[i] = scale[i];
      bnp[Ci + i] = shift[i];
    }
  }
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
        for (int tap = 0; tap < 9; ++tap) {
          for (int c = 0; c < chunks; ++c, ++it) {
            const int s = it % C::STAGES;
            bar_wait(saddr(empty + s), (it / C::STAGES & 1) ^ 1);
            const uint32_t fb = saddr(full + s), a = saddr(ring + s * C::STAGE_BYTES);
            bar_expect_tx(fb, C::STAGE_BYTES);
            // the base pixel is one row up and one column left of the
            // output pixel; the offsets pick the tap
            load_im2col(a, &xmap, fb, c * BK, w - 1, h - 1, img, (uint16_t)(tap % 3),
                        (uint16_t)(tap / 3));
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              load_3d(a + A_BYTES + j * BOX_BYTES, &wmap, fb, n0 + 64 * j, c * BK, tap);
          }
        }
      }
    }
  } else {
    regs_inc<232>();
    const int wg = tid / 128 - 1;  // rows 64*wg.. of each tile
    const int t = tid % 128, lane = t % 32;
    const int r_lo = t / 32 * 16 + lane / 4;  // accumulator rows r_lo and r_lo + 8
    float acc[BN / 2];
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
        acc[4 * j] = acc[4 * j + 2] = b0;
        acc[4 * j + 1] = acc[4 * j + 3] = b1;
      }
      // PRO: this thread rewrites A rows t/8 + 16*i (i < 4) of its
      // warpgroup; bit tap of in_image[i] is set where row i's pixel at
      // that tap lies in the image (never past the last pixel)
      uint32_t in_image[4] = {0, 0, 0, 0};
      if (PRO) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + 64 * wg + t / 8 + 16 * i;
          const int ph = m % (H * W) / W, pw = m % W;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int hh = ph + tap / 3 - 1, ww = pw + tap % 3 - 1;
            if (m < M && hh >= 0 && hh < H && ww >= 0 && ww < W) in_image[i] |= 1u << tap;
          }
        }
      }
      for (int k = 0, tap = 0, c = 0; k < k_steps; ++k, ++it) {
        const int s = it % C::STAGES;
        uint8_t* stage = ring + s * C::STAGE_BYTES;
        bar_wait(saddr(full + s), it / C::STAGES & 1);
        if (PRO) {
          // the 16-byte chunks this thread rewrites sit at swizzled position
          // t % 8 of rows whose index is t / 8 mod 8: all hold the same
          // logical 8 channels
          const int c0 = c * BK + 8 * ((t % 8) ^ (t / 8 % 8));
          const float4 s0 = *reinterpret_cast<const float4*>(bnp + c0);
          const float4 s1 = *reinterpret_cast<const float4*>(bnp + c0 + 4);
          const float4 h0 = *reinterpret_cast<const float4*>(bnp + Ci + c0);
          const float4 h1 = *reinterpret_cast<const float4*>(bnp + Ci + c0 + 4);
          uint4* rows = reinterpret_cast<uint4*>(stage + wg * (A_BYTES / 2));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (in_image[i] >> tap & 1) {
              uint4 v = rows[t + 128 * i];
              v.x = bn_relu2(v.x, s0.x, s0.y, h0.x, h0.y);
              v.y = bn_relu2(v.y, s0.z, s0.w, h0.z, h0.w);
              v.z = bn_relu2(v.z, s1.x, s1.y, h1.x, h1.y);
              v.w = bn_relu2(v.w, s1.z, s1.w, h1.z, h1.w);
              rows[t + 128 * i] = v;
            }
          }
          fence_async_smem();
          named_sync(1 + wg, 128);
          if (++c == chunks) c = 0, ++tap;
        }
        const uint32_t a = saddr(stage) + wg * (A_BYTES / 2), b = saddr(stage) + A_BYTES;
        fence_regs(acc);
        mma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma<BN>(acc, gmma_desc(a + 32 * kk, 16, 1024),
                  gmma_desc(b + 2048 * kk, BOX_BYTES, 1024));
        mma_commit();
        mma_wait<1>();
        fence_regs(acc);
        // the previous step's products are done: release its stage
        if (k > 0 && t == 0) bar_arrive(saddr(empty + (it - 1) % C::STAGES));
      }
      mma_wait<0>();
      fence_regs(acc);
      if (t == 0) bar_arrive(saddr(empty + (it - 1) % C::STAGES));

      // epilogue: ReLU (NaN stays NaN), stats of the rows < M, y
      if (relu) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = acc[i] < 0.f ? 0.f : acc[i];
      }
      const int m_lo = m0 + 64 * wg + r_lo;
      if (with_stats) {
        const bool ok_lo = m_lo < M, ok_hi = m_lo + 8 < M;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float v0 = ok_lo ? acc[4 * j] : 0.f, v1 = ok_lo ? acc[4 * j + 1] : 0.f;
          const float v2 = ok_hi ? acc[4 * j + 2] : 0.f, v3 = ok_hi ? acc[4 * j + 3] : 0.f;
          float s0 = v0 + v2, s1 = v1 + v3, q0 = v0 * v0 + v2 * v2, q1 = v1 * v1 + v3 * v3;
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            q0 += __shfl_xor_sync(0xffffffffu, q0, off);
            q1 += __shfl_xor_sync(0xffffffffu, q1, off);
          }
          if (lane < 4) {
            const int n = n0 + 8 * j + 2 * lane;
            atomicAdd(ssum + n, s0);
            atomicAdd(ssum + n + 1, s1);
            atomicAdd(ssum + Co + n, q0);
            atomicAdd(ssum + Co + n + 1, q1);
          }
        }
      }
      // y: this warpgroup's 64 rows as BN/64 swizzled 64x64 boxes, then
      // one TMA store per box
      uint8_t* o = out + wg * (C::OUT_BYTES / 2);
      if (t == 0) store_wait_read();  // the last tile's stores have read the staging tile
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint8_t* p = o + j / 8 * BOX_BYTES + r_lo * 128 + ((j % 8) ^ (r_lo % 8)) * 16 +
                     lane % 4 * 4;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (t == 0 && m0 + 64 * wg < M) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          store_2d(&ymap, saddr(o + j * BOX_BYTES), n0 + 64 * j, m0 + 64 * wg);
        store_commit();
      }
    }
    if (t == 0) store_wait_all();
    if (with_stats) {
      named_sync(3, 256);  // every consumer's shared-memory sums are in
      for (int i = tid - 128; i < 2 * Co; i += 256) atomicAdd(stats + i, ssum[i]);
    }
  }
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
void* driver_fn(const char* name) {
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

// 128-wide tiles where Co allows them and they fill the card at least as
// well as 64-wide ones, by a cost of waves x (BN + 64): a tile's A loads
// cost about what 64 output channels' worth of B and math do
int pick_bn(long long m, int co, int sms) {
  if (co % 128 != 0) return 64;
  const long long m_tiles = (m + BM - 1) / BM;
  const long long w128 = (m_tiles * (co / 128) + sms - 1) / sms;
  const long long w64 = (m_tiles * (co / 64) + sms - 1) / sms;
  return w128 * (128 + 64) <= w64 * (64 + 64) ? 128 : 64;
}

template <int BN, bool PRO>
int launch_bn(const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& ymap,
              const float* bias, const float* sc, const float* sh, float* st, int h, int wd,
              int ci, int co, long long m, int relu, int with_stats, int dev, int sms,
              cudaStream_t s) {
  auto kernel = conv3x3_sm90_kernel<BN, PRO>;
  const size_t smem = Cfg<BN>::smem(ci, co);
  // allow this instantiation the card's largest dynamic shared memory,
  // once per device
  static unsigned allowed = 0;
  if (!(allowed >> dev & 1)) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1u << dev;
  }
  const long long tiles = (m + BM - 1) / BM * (co / BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, smem, s>>>(xmap, wmap, ymap, bias, sc, sh, st, h, wd, ci, co, (int)m,
                                     relu, with_stats);
  return (int)cudaGetLastError();
}

template <bool PRO>
int launch(const void* x, const void* w, const void* b, const void* scale, const void* shift,
           void* y, void* stats, int n, int h, int wd, int ci, int co, long long w_tap_stride,
           int relu, int with_stats, int is_bf16, cudaStream_t s) {
  const long long m = (long long)n * h * wd;
  // the shapes the wrapper routes here; anything else is refused
  if (!is_bf16 || ci % BK != 0 || co % 64 != 0 || ci > MAX_C || co > MAX_C ||
      w_tap_stride % 8 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(y) || m <= 0 ||
      m >= (1ll << 31))
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

  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, wmap, ymap;
  // x (C, W, H, N), im2col: 64 channels of 128 pixels per load; the
  // bounding box of the base pixel runs from -1 to (size - 2) in W and H
  const cuuint64_t xdim[4] = {(cuuint64_t)ci, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xstride[3] = {2ull * ci, 2ull * ci * wd, 2ull * ci * wd * h};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  CUresult r = im2col(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim,
                      xstride, lower, upper, BK, BM, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // w (Co, Ci, 9 taps), tiled: 64x64 boxes
  const cuuint64_t wdim[3] = {(cuuint64_t)co, (cuuint64_t)ci, 9};
  const cuuint64_t wstride[2] = {2ull * co, 2ull * w_tap_stride};
  const cuuint32_t wbox[3] = {64, 64, 1};
  if (r == CUDA_SUCCESS)
    r = tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wdim, wstride,
              wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // y (Co, M), tiled: 64x64 boxes, stored
  const cuuint64_t ydim[2] = {(cuuint64_t)co, (cuuint64_t)m};
  const cuuint64_t ystride[1] = {2ull * co};
  const cuuint32_t ybox[2] = {64, 64};
  if (r == CUDA_SUCCESS)
    r = tiled(&ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, ydim, ystride, ybox, ones,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  const float* bias = static_cast<const float*>(b);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* st = static_cast<float*>(stats);
  if (pick_bn(m, co, sms) == 128)
    return launch_bn<128, PRO>(xmap, wmap, ymap, bias, sc, sh, st, h, wd, ci, co, m, relu,
                               with_stats, dev, sms, s);
  return launch_bn<64, PRO>(xmap, wmap, ymap, bias, sc, sh, st, h, wd, ci, co, m, relu,
                            with_stats, dev, sms, s);
}

}  // namespace sm90

}  // namespace

extern "C" int mg_conv3x3(const void* x, const void* w, const void* b, void* y, void* stats,
                          int n, int h, int wd, int ci, int co, long long w_tap_stride,
                          int relu, int with_stats, int is_bf16, void* stream) {
  return launch<false>(x, w, b, nullptr, nullptr, y, stats, n, h, wd, ci, co, w_tap_stride, relu,
                       with_stats, is_bf16, static_cast<cudaStream_t>(stream));
}

// conv3x3(max(x*scale + shift, 0)) with the conv's zero padding kept;
// scale and shift (ci,) f32
extern "C" int mg_conv3x3_bn_relu_in(const void* x, const void* w, const void* b,
                                     const void* scale, const void* shift, void* y, void* stats,
                                     int n, int h, int wd, int ci, int co,
                                     long long w_tap_stride, int relu, int with_stats,
                                     int is_bf16, void* stream) {
  return launch<true>(x, w, b, scale, shift, y, stats, n, h, wd, ci, co, w_tap_stride, relu,
                      with_stats, is_bf16, static_cast<cudaStream_t>(stream));
}

// The sm90 design of mg_conv3x3 (same arguments; bf16 only): refuses,
// with cudaErrorInvalidValue, any launch the wrapper would not route here
extern "C" int mg_conv3x3_sm90(const void* x, const void* w, const void* b, void* y, void* stats,
                               int n, int h, int wd, int ci, int co, long long w_tap_stride,
                               int relu, int with_stats, int is_bf16, void* stream) {
  return sm90::launch<false>(x, w, b, nullptr, nullptr, y, stats, n, h, wd, ci, co, w_tap_stride,
                             relu, with_stats, is_bf16, static_cast<cudaStream_t>(stream));
}

// The sm90 design of mg_conv3x3_bn_relu_in (same arguments; bf16 only)
extern "C" int mg_conv3x3_bn_relu_in_sm90(const void* x, const void* w, const void* b,
                                          const void* scale, const void* shift, void* y,
                                          void* stats, int n, int h, int wd, int ci, int co,
                                          long long w_tap_stride, int relu, int with_stats,
                                          int is_bf16, void* stream) {
  return sm90::launch<true>(x, w, b, scale, shift, y, stats, n, h, wd, ci, co, w_tap_stride, relu,
                            with_stats, is_bf16, static_cast<cudaStream_t>(stream));
}
