// Per-tensor symmetric int8 quantization of an activation, in one pass:
//   x8 = clamp(rint(float(x) / sx), -127, 127) as int8,
// written at the input's resolution or, for an exchange's "up" part,
// nearest-upsampled 2x and cropped to (oh, ow); and, for dynamic scales,
// the scale's absmax reduction.
//
// Replaces no TPU kernel. The JAX package's quantizer,
// mgtpu/ops/quant.py::quantize_act (and mgtpu/nn.py's nearest upsample
// of an "up" part's int8 values), is elementwise jnp that XLA fuses into
// one pass under jit. The port runs eagerly, where the same ops are five
// to ten launches a conv part (cast, divide, round, clamp, int8 cast;
// abs, amax, divide, clamp for a dynamic scale; two repeat_interleaves
// for an "up" part), each a full pass over the tensor; this is that
// fusion, written by hand.
//
// Bound on this card: device-memory bandwidth. Each input element is
// read once (2 bytes bf16, 4 bytes f32) and each output byte written
// once (4 per input element of an "up" part).
//
// Bits. The divide is IEEE (__fdiv_rn, never a multiply by the
// reciprocal), rint rounds half to even, and the clamp bounds the value
// before the conversion, so the result equals the plain version's torch
// ops bit for bit: +-inf give +-127, values past +-127*sx clip, +-0
// give 0. A NaN gives 0 (torch's float -> int8 conversion of the NaN
// that its clamp keeps gives 0 on the card and on x86). The dynamic
// scale is sx = max(absmax / 127, 1e-12) with the divide IEEE and the
// max keeping a NaN absmax (torch's clamp_min does), so a NaN anywhere
// in the tensor makes sx NaN and every x8 0.
//
// Design. mg_quant_i8: one thread per 16 values (16-byte stores, 32 or
// 64 bytes of loads) when they are 16 consecutive values of the flat
// tensor (no up: the quantize is elementwise) or 16 channels of one input
// pixel (up: C % 16 == 0), and x and x8 are 16-byte aligned; one thread
// a value otherwise; grid-stride. An "up" input pixel (i, j) is read and
// quantized once and stored to output pixels (2i + a, 2j + b) inside the
// crop: no output byte is written twice, no input read twice.
// mg_absmax: zeroes its f32 accumulator (cudaMemsetAsync), then each
// thread takes the max of |x| over 16-byte loads, a warp and block
// reduction follows, and one atomicMax per block on the float's bits
// (non-negative floats order as their int bits; a NaN's bits exceed
// +inf's, so a NaN wins as in torch's amax). The max is order-free, so
// the result is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__device__ __forceinline__ int8_t quantize(float v, float sx) {
  float q = rintf(__fdiv_rn(v, sx));
  if (q != q) return 0;  // NaN
  q = q < -127.f ? -127.f : q > 127.f ? 127.f : q;
  return static_cast<int8_t>(static_cast<int>(q));
}

// the scale of this launch: the static one, or the dynamic one from the
// absmax (written once, to sx_out, for the conv and the calibration)
__device__ __forceinline__ float scale_of(const float* sx, const float* absmax) {
  if (absmax == nullptr) return __ldg(sx);
  const float s = __fdiv_rn(__ldg(absmax), 127.f);
  return s < 1e-12f ? 1e-12f : s;  // keeps NaN
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 consecutive values of x (16-byte aligned) as floats
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 raw = __ldg(reinterpret_cast<const float4*>(p) + g);
    v[4 * g] = raw.x, v[4 * g + 1] = raw.y, v[4 * g + 2] = raw.z, v[4 * g + 3] = raw.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + g);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[8 * g + 2 * q] = __uint_as_float(words[q] << 16);
      v[8 * g + 2 * q + 1] = __uint_as_float(words[q] & 0xffff0000u);
    }
  }
}

// VEC: 16 values a thread (16-byte stores). Without up: the quantize is
// elementwise, so item i is values 16i.. (or value i) of the flat tensor.
// With up: item i is 16 channels (or one) of input pixel i / (c / G),
// quantized once and stored to each of the up to 4 output pixels of its
// 2x2 block that the crop keeps.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    quant_kernel(const T* __restrict__ x, const float* __restrict__ sx,
                 const float* __restrict__ absmax, float* __restrict__ sx_out,
                 int8_t* __restrict__ y, int h, int w, int c, int oh, int ow, int up,
                 long long items) {
  const float s = scale_of(sx, absmax);
  if (sx_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *sx_out = s;
  constexpr int G = VEC ? 16 : 1;
  const int cg = c / G;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < items;
       i += (long long)gridDim.x * THREADS) {
    const T* xp = up ? x + i / cg * c + (i % cg) * G : x + i * G;
    uint4 q8 = make_uint4(0u, 0u, 0u, 0u);
    int8_t q1 = 0;
    if (VEC) {
      float v[16];
      load16(xp, v);
      uint32_t words[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        words[g] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          words[g] |= static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[4 * g + b], s)))
                      << (8 * b);
      }
      q8 = make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      q1 = quantize(to_f32(xp[0]), s);
    }
    if (!up) {
      if (VEC)
        *reinterpret_cast<uint4*>(y + i * G) = q8;
      else
        y[i] = q1;
      continue;
    }
    const long long pix = i / cg;  // input pixel (img, r, q) of (n, h, w)
    const int q = static_cast<int>(pix % w), r = static_cast<int>(pix / w % h);
    const long long img = pix / w / h;
    const int c0 = static_cast<int>(i % cg) * G;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int rr = 2 * r + a;
      if (rr >= oh) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int qq = 2 * q + b;
        if (qq >= ow) continue;
        int8_t* yp = y + ((img * oh + rr) * ow + qq) * c + c0;
        if (VEC)
          *reinterpret_cast<uint4*>(yp) = q8;
        else
          *yp = q1;
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = (o > v || o != o) ? o : v;  // NaN wins
  }
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    absmax_kernel(const T* __restrict__ x, float* __restrict__ absmax, long long n) {
  float m = 0.f;
  constexpr int V = VEC ? 16 / sizeof(T) : 1;  // elements a load
  const long long loads = n / V;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < loads;
       i += (long long)gridDim.x * THREADS) {
    if (VEC) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + i);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[2];
        int nv = 1;
        if (sizeof(T) == 2) {
          v[0] = __uint_as_float(words[q] << 16);
          v[1] = __uint_as_float(words[q] & 0xffff0000u);
          nv = 2;
        } else {
          v[0] = __uint_as_float(words[q]);
        }
        for (int b = 0; b < nv; ++b) {
          const float a = fabsf(v[b]);
          m = (a > m || a != a) ? a : m;
        }
      }
    } else {
      const float a = fabsf(to_f32(x[i]));
      m = (a > m || a != a) ? a : m;
    }
  }
  __shared__ float part[THREADS / 32];
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? part[threadIdx.x] : 0.f;
    m = warp_max(m);
    // |x| >= 0 (a NaN's sign bit cleared): its bits order as an int
    if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(absmax), __float_as_int(m));
  }
}

// blocks for `work` threads' worth of items: at most 8 a multiprocessor
// (the loops are grid-stride)
unsigned grid_for(long long work) {
  static int sms_of[32] = {};  // per device, asked once
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess && dev < 32) {
    if (sms_of[dev] == 0 &&
        cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms_of[dev] = 132;
    sms = sms_of[dev];
  }
  const long long blocks = (work + THREADS - 1) / THREADS, most = 8ll * sms;
  return static_cast<unsigned>(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

template <typename T>
int quant_launch(const void* x, const float* sx, const float* absmax, float* sx_out, void* y,
                 int n, int h, int w, int c, int oh, int ow, int up, cudaStream_t stream) {
  const long long numel = (long long)n * h * w * c;
  // 16 values a thread: the flat tensor in 16s, or an up part's pixels in
  // 16-channel groups
  const bool vec = (up ? c % 16 == 0 : numel % 16 == 0) && aligned16(x) && aligned16(y);
  const long long items = vec ? numel / 16 : numel;
  const auto xs = static_cast<const T*>(x);
  const auto ys = static_cast<int8_t*>(y);
  if (vec)
    quant_kernel<T, true><<<grid_for(items), THREADS, 0, stream>>>(xs, sx, absmax, sx_out, ys,
                                                                   h, w, c, oh, ow, up, items);
  else
    quant_kernel<T, false><<<grid_for(items), THREADS, 0, stream>>>(xs, sx, absmax, sx_out, ys,
                                                                    h, w, c, oh, ow, up, items);
  return cudaGetLastError();
}

template <typename T>
int absmax_launch(const void* x, float* absmax, long long n, cudaStream_t stream) {
  const int v = 16 / sizeof(T);
  const bool vec = n % v == 0 && aligned16(x);
  const long long loads = vec ? n / v : n;
  if (vec)
    absmax_kernel<T, true><<<grid_for(loads), THREADS, 0, stream>>>(static_cast<const T*>(x),
                                                                    absmax, n);
  else
    absmax_kernel<T, false><<<grid_for(loads), THREADS, 0, stream>>>(static_cast<const T*>(x),
                                                                     absmax, n);
  return cudaGetLastError();
}

}  // namespace

// x (n, h, w, c) NHWC, contiguous, f32 (is_bf16 0) or bf16 (1) -> y (n,
// oh, ow, c) int8: (oh, ow) = (h, w), or with up = 1 the nearest 2x
// upsample cropped to (oh, ow) <= (2h, 2w). The scale: sx (one f32 in
// device memory) with absmax null; or, dynamic, from absmax (mg_absmax's
// result), written to sx_out. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it refuses.
extern "C" int mg_quant_i8(const void* x, const void* sx, const void* absmax, void* sx_out,
                           void* y, int n, int h, int w, int c, int oh, int ow, int up,
                           int is_bf16, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || (up != 0 && up != 1) ||
      (up ? (oh <= 0 || ow <= 0 || oh > 2 * h || ow > 2 * w) : (oh != h || ow != w)) ||
      (absmax == nullptr) == (sx == nullptr) || (absmax == nullptr) != (sx_out == nullptr))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto s = static_cast<const float*>(sx);
  const auto a = static_cast<const float*>(absmax);
  const auto so = static_cast<float*>(sx_out);
  if (is_bf16) return quant_launch<__nv_bfloat16>(x, s, a, so, y, n, h, w, c, oh, ow, up, st);
  return quant_launch<float>(x, s, a, so, y, n, h, w, c, oh, ow, up, st);
}

// absmax (one f32) = max |x| over the n elements of x (f32, or bf16 with
// is_bf16 1); zeroed first, on the stream
extern "C" int mg_absmax(const void* x, void* absmax, long long n, int is_bf16, void* stream) {
  if (n <= 0 || absmax == nullptr) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(absmax, 0, sizeof(float), st);
  if (err != cudaSuccess) return err;
  auto a = static_cast<float*>(absmax);
  return is_bf16 ? absmax_launch<__nv_bfloat16>(x, a, n, st) : absmax_launch<float>(x, a, n, st);
}
