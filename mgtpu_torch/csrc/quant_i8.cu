// Per-tensor symmetric int8 quantization of activations, in one pass:
//   x8 = clamp(rint(float(x) / sx), -127, 127) as int8,
// written at the input's resolution or, for an exchange's "up" part,
// nearest-upsampled 2x and cropped to (oh, ow); and, for dynamic scales,
// the scale's absmax reduction. Two designs:
//   group (mg_quant_i8_group, mg_absmax_group; namespace group, below):
//          every quantized-conv input of a multigrid layer in one launch,
//          each with its own scale: the design on the port's path
//          (quant.py::quant_i8_group, one launch a layer where the
//          per-part design took one a part: 33 against 155 a R-MG-34 int8
//          forward);
//   part (mg_quant_i8, mg_absmax): the first design, one launch a
//          tensor, kept only to hold the group design against and to time
//          it (quant.py::_part_forward; chip_smoke.py, the card tests).
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
// once (4 per input element of an "up" part). Half of a R-MG-34 int8
// forward's 155 parts move under 5 MB at batch 128, less than the fixed
// cost of a launch of their own: the group design puts a layer's parts
// in one launch over one resident wave of the card.
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
// The part design. mg_quant_i8: one thread per 16 values (16-byte
// stores, 32 or 64 bytes of loads) when they are 16 consecutive values of
// the flat tensor (no up: the quantize is elementwise) or 16 channels of
// one input pixel (up: C % 16 == 0), and x and x8 are 16-byte aligned;
// one thread a value otherwise; grid-stride. An "up" input pixel (i, j)
// is read and quantized once and stored to output pixels (2i + a, 2j + b)
// inside the crop: no output byte is written twice, no input read twice.
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


// The group design: one launch for every quantized-conv input of a
// multigrid layer (the design on the port's path since it came).
//
// The member table. The wrapper (quant.py::_group_table) fills one Table a
// launch and it travels by value as a __grid_constant__ kernel parameter:
// no device allocation, no host-to-device copy. Member j is one conv part:
// its input x, its int8 output y, and its static scale sx or, dynamic
// (sx null), its slot in the layer's scale vector. Its items are its
// lanes: 16 values (vec = 1) where the part takes 16-byte lanes as
// mg_quant_i8's VEC path does (16 consecutive values of the flat tensor
// without up, 16 channels of one input pixel with it; x and y 16-byte
// aligned), else one value (vec = 0), so lane widths, dtypes and up may
// differ within a group. The absmax launch takes a table of the dynamic
// members whose items are 16-value loads of the flat x (numel % 16 == 0
// and x aligned), else single values.
//
// Work. A tile is per_thread * THREADS consecutive items of one member;
// tile0[j] is the prefix sum of the earlier members' tiles, so a block
// finds the member of its tile by a scan of at most MAX_MEMBERS prefix
// sums. Blocks walk the tiles blockIdx.x, + gridDim.x, ...; the wrapper
// sizes the grid to at most one resident wave of the card, so a layer of
// small parts fills the SMs that each part alone left idle. A thread
// issues the loads of all its items of a tile before it quantizes and
// stores any; 16-byte loads and stores carry the streaming hint (each
// byte is read once a pass, written once). A table holds MAX_MEMBERS
// members (the zoo's layers have at most 7 parts; a longer layer is
// split): 16 ran 2% slower on an H100, the launch carrying twice the
// parameter bytes (probe_quant_group.py). Index math is 32-bit: the
// wrapper refuses a member of 2^31 values or more, and valid() checks
// the table again.
//
// Dynamic scales. group_absmax_kernel keeps a block's running max across
// its consecutive tiles of one member and adds it with one atomicMax on
// the float's bits when the member changes or the block ends (the rule of
// absmax_kernel: NaN wins). Between it and group_quant_kernel the wrapper
// all-reduces the whole vector over the mesh (one MAX a layer); each
// member's scale is then scale_of() of its slot, written once to
// sx_out[slot] by the block that takes the member's first tile.
namespace group {

constexpr int MAX_MEMBERS = 8;
constexpr int THREADS = 256;
constexpr int MAX_ITEMS = 2;
// blocks an SM: the launch bounds leave a thread 85 registers, two f32
// items' 32 words of loads among them (at 4 blocks, 64 registers, the
// quantize kernel spilled 40 bytes on an H100: ptxas -v); the wrapper
// sizes the grid to this many blocks an SM (quant.py::GROUP_BLOCKS_PER_SM)
constexpr int MIN_BLOCKS = 3;

// one conv part of the group; field order and types are mirrored by
// quant.py::_Member
struct Member {
  const void* x;    // (n, h, w, c), f32 or bf16
  void* y;          // int8 (n, oh, ow, c)
  const float* sx;  // the static scale, or null (dynamic)
  int slot;         // dynamic: the index in absmax and sx_out; static: -1
  int n, h, w, c;
  int oh, ow;  // (h, w), or with up the 2x upsample's crop
  int up;      // 1: an exchange's "up" part
  int bf16;    // 1: x is bf16
  int vec;     // 1: a lane is 16 values; 0: one value
  int items;   // the member's lanes (quantize) or loads (absmax)
  int tile0;   // the member's first tile
};

// mirrored by quant.py::_Table
struct Table {
  Member m[MAX_MEMBERS];
  int count;       // members, 1..MAX_MEMBERS
  int tiles;       // every member's tiles
  int per_thread;  // items a thread in a tile, 1..MAX_ITEMS
};

// the member whose tiles hold tile tl
__device__ __forceinline__ int member_of(const Table& t, int tl) {
  int j = 0;
#pragma unroll
  for (int k = 1; k < MAX_MEMBERS; ++k)
    if (k < t.count && tl >= t.m[k].tile0) j = k;
  return j;
}

// the raw bits of one item: VEC 16 values (64 bytes f32, 32 bf16), else 1
template <typename T, bool VEC>
struct Raw {
  static constexpr int WORDS = VEC ? 16 * sizeof(T) / 16 : 1;  // uint4 a lane
  uint4 u[VEC ? WORDS : 1];
  T one;
  __device__ __forceinline__ void load(const T* x, uint32_t item) {
    if constexpr (VEC) {
      const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)item * 16);
#pragma unroll
      for (int g = 0; g < WORDS; ++g) u[g] = __ldcs(p + g);
    } else {
      one = x[item];
    }
  }
  // value i of the lane (VEC), or the one value
  __device__ __forceinline__ void values(float (&v)[VEC ? 16 : 1]) const {
    if constexpr (VEC) {
#pragma unroll
      for (int g = 0; g < WORDS; ++g) {
        const uint32_t words[4] = {u[g].x, u[g].y, u[g].z, u[g].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (sizeof(T) == 4) {
            v[4 * g + q] = __uint_as_float(words[q]);
          } else {
            v[8 * g + 2 * q] = __uint_as_float(words[q] << 16);
            v[8 * g + 2 * q + 1] = __uint_as_float(words[q] & 0xffff0000u);
          }
        }
      }
    } else {
      v[0] = to_f32(one);
    }
  }
};

// the items of one quantize tile that thread threadIdx.x owns: base +
// k * THREADS; an up member's item is 16 channels (or one) of an input
// pixel, stored to each output pixel of its 2x2 block inside the crop
template <typename T, bool VEC>
__device__ __forceinline__ void quant_tile(const Member& m, uint32_t base, int per_thread,
                                           float s) {
  constexpr int G = VEC ? 16 : 1;
  const T* x = static_cast<const T*>(m.x);
  int8_t* y = static_cast<int8_t*>(m.y);
  Raw<T, VEC> raw[MAX_ITEMS];
  bool ok[MAX_ITEMS];
#pragma unroll
  for (int k = 0; k < MAX_ITEMS; ++k) {
    const uint32_t item = base + k * THREADS;
    ok[k] = k < per_thread && item < (uint32_t)m.items;
    if (ok[k]) raw[k].load(x, item);
  }
  const uint32_t cg = (uint32_t)(m.c / G);
#pragma unroll
  for (int k = 0; k < MAX_ITEMS; ++k) {
    if (!ok[k]) continue;
    const uint32_t item = base + k * THREADS;
    float v[G];
    raw[k].values(v);
    uint4 q8 = make_uint4(0u, 0u, 0u, 0u);
    int8_t q1 = 0;
    if constexpr (VEC) {
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
      q1 = quantize(v[0], s);
    }
    if (!m.up) {
      if constexpr (VEC)
        __stcs(reinterpret_cast<uint4*>(y + (size_t)item * 16), q8);
      else
        y[item] = q1;
      continue;
    }
    const uint32_t pix = item / cg;  // input pixel (img, r, q) of (n, h, w)
    const uint32_t q = pix % (uint32_t)m.w, r = pix / (uint32_t)m.w % (uint32_t)m.h;
    const uint32_t img = pix / (uint32_t)m.w / (uint32_t)m.h;
    const uint32_t c0 = item % cg * G;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const uint32_t rr = 2 * r + a;
      if (rr >= (uint32_t)m.oh) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const uint32_t qq = 2 * q + b;
        if (qq >= (uint32_t)m.ow) continue;
        int8_t* yp = y + ((size_t)(img * m.oh + rr) * m.ow + qq) * m.c + c0;
        if constexpr (VEC)
          __stcs(reinterpret_cast<uint4*>(yp), q8);
        else
          *yp = q1;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
group_quant_kernel(const __grid_constant__ Table t, const float* __restrict__ absmax,
                   float* __restrict__ sx_out) {
  for (int tl = blockIdx.x; tl < t.tiles; tl += gridDim.x) {
    const Member& m = t.m[member_of(t, tl)];
    const float s = m.sx != nullptr ? __ldg(m.sx) : scale_of(nullptr, absmax + m.slot);
    if (m.sx == nullptr && tl == m.tile0 && threadIdx.x == 0) sx_out[m.slot] = s;
    const uint32_t base =
        (uint32_t)(tl - m.tile0) * (uint32_t)(t.per_thread * THREADS) + threadIdx.x;
    if (m.bf16) {
      if (m.vec)
        quant_tile<__nv_bfloat16, true>(m, base, t.per_thread, s);
      else
        quant_tile<__nv_bfloat16, false>(m, base, t.per_thread, s);
    } else {
      if (m.vec)
        quant_tile<float, true>(m, base, t.per_thread, s);
      else
        quant_tile<float, false>(m, base, t.per_thread, s);
    }
  }
}

// max |x| over the items of one absmax tile that thread threadIdx.x owns
template <typename T, bool VEC>
__device__ __forceinline__ float absmax_tile(const Member& m, uint32_t base, int per_thread,
                                             float acc) {
  const T* x = static_cast<const T*>(m.x);
  Raw<T, VEC> raw[MAX_ITEMS];
  bool ok[MAX_ITEMS];
#pragma unroll
  for (int k = 0; k < MAX_ITEMS; ++k) {
    const uint32_t item = base + k * THREADS;
    ok[k] = k < per_thread && item < (uint32_t)m.items;
    if (ok[k]) raw[k].load(x, item);
  }
#pragma unroll
  for (int k = 0; k < MAX_ITEMS; ++k) {
    if (!ok[k]) continue;
    float v[VEC ? 16 : 1];
    raw[k].values(v);
#pragma unroll
    for (int i = 0; i < (VEC ? 16 : 1); ++i) {
      const float a = fabsf(v[i]);
      acc = (a > acc || a != a) ? a : acc;
    }
  }
  return acc;
}

// the block's max of acc, added to *dst with one atomicMax (thread 0);
// every thread of the block calls it
__device__ __forceinline__ void block_flush(float acc, float* dst) {
  __shared__ float part[THREADS / 32];
  acc = warp_max(acc);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < THREADS / 32 ? part[threadIdx.x] : 0.f;
    acc = warp_max(acc);
    // |x| >= 0 (a NaN's sign bit cleared): its bits order as an int
    if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(dst), __float_as_int(acc));
  }
  __syncthreads();  // part[] is free for the next flush
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
group_absmax_kernel(const __grid_constant__ Table t, float* __restrict__ absmax) {
  float acc = 0.f;
  int slot = -1;  // the member whose max acc holds
  for (int tl = blockIdx.x; tl < t.tiles; tl += gridDim.x) {
    const Member& m = t.m[member_of(t, tl)];
    if (m.slot != slot) {  // uniform over the block
      if (slot >= 0) block_flush(acc, absmax + slot);
      acc = 0.f;
      slot = m.slot;
    }
    const uint32_t base =
        (uint32_t)(tl - m.tile0) * (uint32_t)(t.per_thread * THREADS) + threadIdx.x;
    if (m.bf16) {
      acc = m.vec ? absmax_tile<__nv_bfloat16, true>(m, base, t.per_thread, acc)
                  : absmax_tile<__nv_bfloat16, false>(m, base, t.per_thread, acc);
    } else {
      acc = m.vec ? absmax_tile<float, true>(m, base, t.per_thread, acc)
                  : absmax_tile<float, false>(m, base, t.per_thread, acc);
    }
  }
  if (slot >= 0) block_flush(acc, absmax + slot);
}

// the launches the wrapper plans; anything else is refused. `absmax`:
// the table of an absmax launch (every member dynamic, items its loads of
// the flat x); else a quantize launch's (items its lanes)
bool valid(const Table& t, int grid, int n_slots, bool absmax) {
  if (t.count < 1 || t.count > MAX_MEMBERS || t.per_thread < 1 || t.per_thread > MAX_ITEMS ||
      grid < 1 || n_slots < 0)
    return false;
  const long long tile_items = (long long)t.per_thread * THREADS;
  long long tiles = 0;
  for (int j = 0; j < t.count; ++j) {
    const Member& m = t.m[j];
    if (m.n < 1 || m.h < 1 || m.w < 1 || m.c < 1 || (m.up != 0 && m.up != 1) ||
        (m.bf16 != 0 && m.bf16 != 1) || (m.vec != 0 && m.vec != 1) || m.x == nullptr ||
        (m.up ? (m.oh < 1 || m.ow < 1 || m.oh > 2 * m.h || m.ow > 2 * m.w)
              : (m.oh != m.h || m.ow != m.w)) ||
        (m.sx == nullptr) != (m.slot >= 0) || m.slot >= n_slots)
      return false;
    const long long numel = (long long)m.n * m.h * m.w * m.c;
    if (numel >= (1ll << 31) || (long long)m.n * m.oh * m.ow * m.c >= (1ll << 31)) return false;
    long long items;
    if (absmax) {
      if (m.sx != nullptr || (m.vec && !(numel % 16 == 0 && aligned16(m.x)))) return false;
      items = m.vec ? numel / 16 : numel;
    } else {
      if (m.y == nullptr ||
          (m.vec && !((m.up ? m.c % 16 == 0 : numel % 16 == 0) && aligned16(m.x) &&
                      aligned16(m.y))))
        return false;
      items = m.vec ? numel / 16 : numel;
    }
    if (items != m.items || m.tile0 != tiles) return false;
    tiles += (items + tile_items - 1) / tile_items;
  }
  return tiles == t.tiles && tiles < (1ll << 31);
}

}  // namespace group

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


// The group design (namespace group). table: a group::Table of
// table_bytes bytes (the wrapper's ctypes mirror; refused unless the size
// is the C side's), grid blocks. absmax and sx_out: the layer's dynamic
// scale vector (n_slots f32 each, or null with n_slots 0): the quantize
// reads member j's absmax[slot] and writes its scale to sx_out[slot].
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a table the
// wrapper would not plan.
extern "C" int mg_quant_i8_group(const void* table, int table_bytes, int grid, const void* absmax,
                                 void* sx_out, int n_slots, void* stream) {
  if (table == nullptr || table_bytes != (int)sizeof(group::Table) ||
      (n_slots > 0) != (absmax != nullptr) || (n_slots > 0) != (sx_out != nullptr))
    return cudaErrorInvalidValue;
  const group::Table& t = *static_cast<const group::Table*>(table);
  if (!group::valid(t, grid, n_slots, false)) return cudaErrorInvalidValue;
  group::group_quant_kernel<<<grid, group::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(absmax), static_cast<float*>(sx_out));
  return cudaGetLastError();
}

// absmax[slot] = max |x| over each member of the table (every one
// dynamic), into an f32 vector of n_slots; its first `zero` floats are
// zeroed first, on the stream (the wrapper zeroes the whole vector with
// a layer's first launch)
extern "C" int mg_absmax_group(const void* table, int table_bytes, int grid, void* absmax,
                               int n_slots, int zero, void* stream) {
  if (table == nullptr || table_bytes != (int)sizeof(group::Table) || absmax == nullptr ||
      n_slots < 1 || zero < 0 || zero > n_slots)
    return cudaErrorInvalidValue;
  const group::Table& t = *static_cast<const group::Table*>(table);
  if (!group::valid(t, grid, n_slots, true)) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (zero > 0) {
    const cudaError_t err = cudaMemsetAsync(absmax, 0, sizeof(float) * zero, st);
    if (err != cudaSuccess) return err;
  }
  group::group_absmax_kernel<<<grid, group::THREADS, 0, st>>>(t, static_cast<float*>(absmax));
  return cudaGetLastError();
}
