// 2x2/2 max pool, NHWC, ceil mode, bf16 and f32.
//
// Replaces: mgtpu/ops/pallas_pool.py::_fwd_kernel (called by
// maxpool2_pallas -> _pool_fwd_call), extended to ceil mode: a window
// that runs past the bottom or right edge is clipped, which equals the
// -inf padding of mgtpu/ops/resample.py::maxpool2_ceil. So one kernel
// serves every H and W and the wrapper needs no shape dispatch (the
// Pallas kernel took even sizes only).
//
// Bound on this card: device-memory bandwidth. Each output element
// reads 4 inputs and writes 1; there is no arithmetic to speak of.
//
// Design: one thread per output element, with C the fastest index, so
// a warp's loads of one window corner and its stores are contiguous
// runs along C (coalesced). The max propagates NaN like lax.max and
// torch's max_pool2d (fmaxf would drop it), and selects the input value
// itself, so the result is bit-exact in both types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ void take_max(T& best, float& best_f, T cand) {
  const float c = to_f32(cand);
  if (best_f != best_f) return;  // a NaN best stays
  if (c > best_f || c != c) {    // a NaN candidate wins
    best = cand;
    best_f = c;
  }
}

template <typename T>
__global__ void maxpool2_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W,
                                int C, int OH, int OW, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int c = (int)(i % C);
    long long t = i / C;
    const int ow = (int)(t % OW);
    t /= OW;
    const int oh = (int)(t % OH);
    const long long n = t / OH;
    const int h0 = 2 * oh, w0 = 2 * ow;
    const long long row = (long long)W * C;
    const T* p = x + ((n * H + h0) * W + w0) * C + c;
    T best = p[0];  // (h0, w0) lies inside: oh < ceil(H/2), ow < ceil(W/2)
    float best_f = to_f32(best);
    const bool right = w0 + 1 < W, down = h0 + 1 < H;
    if (right) take_max(best, best_f, p[C]);
    if (down) take_max(best, best_f, p[row]);
    if (right && down) take_max(best, best_f, p[row + C]);
    y[i] = best;
  }
}

template <typename T>
int launch(const void* x, void* y, int n, int h, int w, int c, cudaStream_t stream) {
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  const long long total = (long long)n * oh * ow * c;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1LL << 30) ? want : (1LL << 30));
  maxpool2_kernel<T><<<blocks, threads, 0, stream>>>(static_cast<const T*>(x),
                                                     static_cast<T*>(y), h, w, c, oh, ow,
                                                     total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mg_maxpool2(const void* x, void* y, int n, int h, int w, int c, int is_bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, n, h, w, c, s) : launch<float>(x, y, n, h, w, c, s);
}
