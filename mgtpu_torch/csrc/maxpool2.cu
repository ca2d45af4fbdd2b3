// 2x2/2 max pool, NHWC, ceil mode, bf16 and f32: forward and backward.
//
// Forward. Replaces: mgtpu/ops/pallas_pool.py::_fwd_kernel (called by
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
//
// Backward. Replaces: mgtpu/ops/pallas_pool.py::_pool_bwd (body
// _bwd_kernel), with two tie rules for a window whose max several
// elements share:
//   all   (first_only = 0): dx = (x == y[window]) ? g[window] : 0, the
//         Pallas kernel's rule; every tied element gets the cotangent,
//         sum(dx) = k*g for k ties;
//   first (first_only = 1): only the first tied element in row-major
//         window order gets it: the rule of XLA's SelectAndScatter,
//         which differentiates mgtpu/ops/resample.py::maxpool2_ceil in
//         the JAX model zoo, and of torch's max_pool2d. The port's
//         training path uses it: on R-MG-34 ties at positive values are
//         common (the stem's overlapping 3x3/2 pool copies one maximum
//         into neighbouring outputs), so the two rules give different
//         parameter gradients.
// A NaN never compares equal, so a window whose max is NaN passes
// nothing under either rule. Ceil mode comes for free: a clipped edge
// window just holds fewer elements.
//
// Bound on this card: device-memory bandwidth. Per input element one
// read of x and one write of dx, plus a quarter-size read each of y
// and g: 2.5 elements moved per input element, no arithmetic.
//
// Design: one thread per V consecutive channels of one pooled pixel,
// with V * sizeof(T) = 16 bytes when C % V == 0 and all four pointers
// are 16-byte aligned (every shape of R-MG-34), else V = 1. The thread
// reads y and g once, walks its window's (up to) four input pixels in
// row-major order, and writes each one's dx: so the first-tie rule
// needs no second pass, and every dx element is written (no memset).
// Loads and stores are 16 bytes a thread, contiguous along C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// V elements of T, loaded and stored as one access of V * sizeof(T) bytes
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V, bool FIRST>
__global__ void maxpool2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                    const T* __restrict__ g, T* __restrict__ dx, int H, int W,
                                    int C, int OH, int OW, long long total) {
  using P = Pack<T, V>;
  const int CV = C / V;
  const T zero = T(0.f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int c = (int)(i % CV) * V;
    long long t = i / CV;
    const int ow = (int)(t % OW);
    t /= OW;
    const int oh = (int)(t % OH);
    const long long n = t / OH;
    const long long yo = ((n * OH + oh) * OW + ow) * C + c;
    const P yv = *reinterpret_cast<const P*>(y + yo);
    const P gv = *reinterpret_cast<const P*>(g + yo);
    bool taken[V];
#pragma unroll
    for (int e = 0; e < V; ++e) taken[e] = false;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int h = 2 * oh + a, w = 2 * ow + b;
        if (h >= H || w >= W) continue;  // clipped edge window
        const long long xo = ((n * H + h) * W + w) * C + c;
        const P xv = *reinterpret_cast<const P*>(x + xo);
        P out;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          bool hit = to_f32(xv.v[e]) == to_f32(yv.v[e]);
          if (FIRST) {
            hit = hit && !taken[e];
            taken[e] = taken[e] || hit;
          }
          out.v[e] = hit ? gv.v[e] : zero;
        }
        *reinterpret_cast<P*>(dx + xo) = out;
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <typename T, bool FIRST>
int launch_bwd(const void* x, const void* y, const void* g, void* dx, int n, int h, int w, int c,
               cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  const bool vec = c % V == 0 && aligned16(x) && aligned16(y) && aligned16(g) && aligned16(dx);
  const long long total = (long long)n * oh * ow * c / (vec ? V : 1);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1LL << 30) ? want : (1LL << 30));
  auto xp = static_cast<const T*>(x), yp = static_cast<const T*>(y), gp = static_cast<const T*>(g);
  auto dxp = static_cast<T*>(dx);
  if (vec)
    maxpool2_bwd_kernel<T, V, FIRST><<<blocks, threads, 0, stream>>>(xp, yp, gp, dxp, h, w, c,
                                                                     oh, ow, total);
  else
    maxpool2_bwd_kernel<T, 1, FIRST><<<blocks, threads, 0, stream>>>(xp, yp, gp, dxp, h, w, c,
                                                                     oh, ow, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mg_maxpool2(const void* x, void* y, int n, int h, int w, int c, int is_bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, n, h, w, c, s) : launch<float>(x, y, n, h, w, c, s);
}

// x (n, h, w, c); y, g (n, ceil(h/2), ceil(w/2), c); dx like x; g in x's
// type. first_only picks the tie rule (see the top of this file).
extern "C" int mg_maxpool2_bwd(const void* x, const void* y, const void* g, void* dx, int n, int h,
                               int w, int c, int first_only, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return first_only ? launch_bwd<__nv_bfloat16, true>(x, y, g, dx, n, h, w, c, s)
                      : launch_bwd<__nv_bfloat16, false>(x, y, g, dx, n, h, w, c, s);
  return first_only ? launch_bwd<float, true>(x, y, g, dx, n, h, w, c, s)
                    : launch_bwd<float, false>(x, y, g, dx, n, h, w, c, s);
}
