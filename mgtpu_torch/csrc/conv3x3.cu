// 3x3, stride 1, pad 1 convolution, NHWC x / HWIO w, bf16 and f32,
// with an f32 accumulator that starts at the bias, an optional ReLU and
// an optional per-channel (sum, sum of squares) epilogue.
//
// Replaces: mgtpu/ops/pallas_conv.py::conv3x3 (kernel bodies
// _conv_rows_kernel and _conv_slab_kernel). Same function; not a
// block-by-block copy.
//
// Bound on this card: at the multigrid's shapes (Ci, Co in 16..512,
// K = 9*Ci) the conv is a GEMM with enough reuse to be bound by
// arithmetic, not by device memory, so bf16 belongs on the tensor cores
// (989 TFLOP/s dense) and f32 on the CUDA cores (67 TFLOP/s).
//
// Design: implicit GEMM with M = N*H*W output pixels, N = Co and
// K = 9*Ci, walked as 9 taps x Ci chunks. The HWIO weight is already a
// (9*Ci, Co) row-major matrix; the exchange passes a slice of a wider
// weight along Ci, so taps are w_tap_stride elements apart. A block
// computes a 64-pixel x 64-channel output tile, staging A (gathered on
// the fly from NHWC x) and B through shared memory. The conv's zero
// padding is a bounds check on the gather: no padded copy of x is made
// (the Pallas kernel pads in device memory, pallas_conv.py::_pad_input).
// Every tail (pixels, Ci, Co) is masked.
//   bf16: 4 warps, each a 32x32 sub-tile of 2x2 WMMA 16x16x16 bf16
//         products with f32 accumulators; K chunks of 32 channels,
//         loaded 16 bytes a thread when Ci and Co are multiples of 8
//         (every shape of R-MG-34), element by element otherwise. One
//         shared-memory stage, no TMA or wgmma yet: simple first.
//   f32:  256 threads, each a 4x4 sub-tile of FMAs, K chunks of 16.
// The stats replace the Pallas kernel's accumulation across its
// sequential grid, which a GPU does not have: each block reduces its
// tile's per-channel sums in shared memory and adds them into the
// (2, Co) f32 output with atomicAdd, so their summation order varies
// from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int BM = 64;  // output pixels per block
constexpr int BN = 64;  // output channels per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
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

// ---------------------------------------------------------------- bf16

constexpr int WK = 32;            // input channels per K chunk
constexpr int WTHREADS = 128;     // 4 warps, 2x2 over the 64x64 tile
constexpr int A_LD = WK + 8;      // padded leading dims (multiples of 8
constexpr int B_LD = BN + 8;      // elements, as WMMA needs)
constexpr int C_LD = BN + 4;

template <bool VEC>
__global__ void __launch_bounds__(WTHREADS)
conv3x3_wmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
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
          if (in && ci0 + k < Ci) val = *reinterpret_cast<const uint4*>(src);
          *reinterpret_cast<uint4*>(&As[row][k]) = val;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            As[row][k + e] = in && ci0 + k + e < Ci ? src[e] : __float2bfloat16(0.f);
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

__global__ void __launch_bounds__(FTHREADS)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
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
        if (ap[i].ok && ci < Ci && hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = x[(((long long)ap[i].img * H + hh) * W + ww) * Ci + ci];
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

}  // namespace

extern "C" int mg_conv3x3(const void* x, const void* w, const void* b, void* y, void* stats,
                          int n, int h, int wd, int ci, int co, long long w_tap_stride,
                          int relu, int with_stats, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long m = (long long)n * h * wd;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  const float* bias = static_cast<const float*>(b);
  float* st = static_cast<float*>(stats);
  if (is_bf16) {
    auto xb = static_cast<const __nv_bfloat16*>(x);
    auto wb = static_cast<const __nv_bfloat16*>(w);
    auto yb = static_cast<__nv_bfloat16*>(y);
    // 16-byte loads need every 8-channel group of x and w on a 16-byte boundary
    const bool vec = ci % 8 == 0 && co % 8 == 0 && w_tap_stride % 8 == 0 && aligned16(x) &&
                     aligned16(w);
    if (vec)
      conv3x3_wmma_kernel<true><<<grid, WTHREADS, 0, s>>>(xb, wb, bias, yb, st, h, wd, ci, co, m,
                                                          w_tap_stride, relu, with_stats);
    else
      conv3x3_wmma_kernel<false><<<grid, WTHREADS, 0, s>>>(xb, wb, bias, yb, st, h, wd, ci, co,
                                                           m, w_tap_stride, relu, with_stats);
  } else {
    conv3x3_fma_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(y), st, h, wd, ci, co, m, w_tap_stride, relu, with_stats);
  }
  return (int)cudaGetLastError();
}
