// 2x2/2 max pool, NHWC, ceil mode, bf16 and f32: forward and backward.
//
// Forward. Replaces: mgtpu/ops/pallas_pool.py::_fwd_kernel (called by
// maxpool2_pallas -> _pool_fwd_call), extended to ceil mode: a window
// that runs past the bottom or right edge is clipped, which equals the
// -inf padding of mgtpu/ops/resample.py::maxpool2_ceil, so the simple
// design below serves every H and W (the Pallas kernel took even sizes
// only).
//
// Bound on this card: device-memory bandwidth. Each output element
// reads 4 inputs and writes 1; there is no arithmetic to speak of.
//
// The max propagates NaN like lax.max and torch's max_pool2d (fmaxf
// would drop it), and selects the input value itself, so the result is
// bit-exact in both types. Two designs compute it; which one a launch
// takes is a fixed function of dtype, shape and alignment, decided by
// the wrapper (mgtpu_torch/ops/cuda_pool.py::_route):
//   sm90   (mg_maxpool2_sm90; section "sm90" below): bulk asynchronous
//          copies into a shared-memory ring, 16-byte lanes; even H,
//          C*sizeof(T) a multiple of 16, 16-byte aligned x, a row pair
//          within one stage: every pool of R-MG-34;
//   simple (mg_maxpool2): the first design, for everything else. One
//          thread per output element, with C the fastest index, so a
//          warp's loads of one window corner and its stores are
//          contiguous runs along C (coalesced). It moves 2 bytes a
//          thread per access and pays 64-bit divisions per element: it
//          is bound by instruction issue, at under a third of the
//          bandwidth on R-MG-34's large shapes.
//
// Backward. Replaces: mgtpu/ops/pallas_pool.py::_pool_bwd (lines 81-99,
// body _bwd_kernel), with two tie rules for a window whose max several
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
// window just holds fewer elements. g comes in x's type (the wrapper
// casts it), and every dx element is written, so dx needs no memset.
//
// Bound on this card: device-memory bandwidth. Per input element one
// read of x and one write of dx, plus a quarter-size read each of y
// and g: 2.5 elements moved per input element, no arithmetic
// (chip_smoke.py::kernel_work). Two designs compute it:
//   group  (mg_maxpool2_bwd_group; section "group" below): the design
//          the port runs. One launch serves up to MAX_MEMBERS tensors:
//          the pools of one multigrid layer, which share a tie rule and
//          a dtype and whose cotangents reach autograd together. What
//          it attacks is the fixed cost of a launch, not bandwidth: on an
//          H100 at ~3.5 us a launch (an empty kernel alone ~1.9 us) the
//          small pools of the CIFAR nets and PR-MG-30 (32-256 KB
//          tensors) cannot reach half their bound one launch a tensor,
//          while the large ones already stream near the card's rate;
//   simple (mg_maxpool2_bwd): the first design, one launch a tensor,
//          kept to hold the group design against and to time it
//          (cuda_pool.py::_simple_backward). One thread per V
//          consecutive channels of one pooled pixel, with V * sizeof(T)
//          = 16 bytes when C % V == 0 and all four pointers are 16-byte
//          aligned, else V = 1; 64-bit index math, a grid-stride loop.
// Both read y and g once per lane, walk the window's (up to) four input
// pixels in row-major order and write each one's dx, so the first-tie
// rule needs no second pass; loads and stores are V elements a thread,
// contiguous along C. Bit-exact in bf16 and f32: dx is g or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_async.cuh"

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

// The sm90 design of the forward: a stream of bulk asynchronous copies
// through a shared-memory ring, reduced in 16-byte lanes.
//
// Rows as one flat stream: with H even, NHWC with n outermost puts row
// pair (n, 2*oh, 2*oh + 1) right after (n, 2*oh - 2, 2*oh - 1) and after
// the last pair of image n - 1. So x is a flat sequence of N*H/2 row
// pairs of 2*W*C elements, and y the matching sequence of output rows of
// OW*C. A chunk is K consecutive row pairs: one contiguous copy in, one
// contiguous run of y out. The wrapper's planner (cuda_pool.py::_plan)
// picks K (K row pairs fit a stage) and the grid (at most one block an
// SM, each walking chunks blockIdx.x, + gridDim.x, ...).
// Loads: one producer thread brings each chunk into a ring of STAGES
// stages guarded by mbarrier full/empty pairs, with one cp.async.bulk
// after mbarrier.arrive.expect_tx: no tensor map, since the chunk is
// contiguous. Up to six chunks (~170 KB at R-MG-34's large shapes) are
// in flight an SM from one thread; the simple design keeps 2 bytes in
// flight a thread.
// The reduction: 16 consumer warps. Each lane owns up to MAX_ITEMS
// 16-byte output vectors of a stage (8 bf16 or 4 f32 channels of one
// output pixel), the same ones in every chunk, so the index math, 32-bit
// divisions included, runs once per block and not per element: it gives
// each vector's top-left corner as an offset into the stage. The lane
// reads the four corners with 16-byte shared loads, consecutive lanes
// on consecutive vectors along C (no bank conflicts where C*sizeof(T)
// is 128 bytes or more; up to two-way below), takes the max in
// row-major window order under take_max's rule, and writes y with one
// 16-byte store; a warp's stores are contiguous. Then each warp arrives
// on the stage's empty barrier.
// Odd W: a clipped last window of a row has no right column. Its right
// corners are read from its left column again, which cannot change the
// max under take_max's rule (an equal candidate never wins, a NaN best
// stays), so no branch is needed. Odd H breaks the flat stream of pairs
// and takes the simple design.
// Hangs: every mbarrier wait traps after ~2^34 cycles (bar_wait), so a
// broken ring fails the launch instead of hanging the card.
namespace sm90 {

using namespace mg_async;

constexpr int CONSUMER_WARPS = 16;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = 32 + CONSUMERS;  // warp 0 loads; warps 1.. reduce
constexpr int STAGES = 6;
// the most a stage holds; the wrapper's planner keeps K row pairs within
// it and passes its own limit (cuda_pool.py::SM90_STAGE_BYTES), which
// launch() refuses unless it is this one
constexpr int STAGE_BYTES = 32768;
// 16-byte output vectors a consumer thread owns in a stage: a stage of B
// bytes yields at most B/32 of them (W = 1; about B/64 for an even W)
constexpr int MAX_ITEMS = STAGE_BYTES / 32 / CONSUMERS;
constexpr int BAR_BYTES = 2 * STAGES * 8;  // the full and empty barriers, before the ring

// take_max on bit patterns: one f32, or one bf16 in the high half (the
// f32 it widens to)
__device__ __forceinline__ uint32_t pick(uint32_t best, uint32_t cand) {
  const float b = __uint_as_float(best), c = __uint_as_float(cand);
  return b == b && (c > b || c != c) ? cand : best;
}

template <typename T>
__device__ __forceinline__ uint32_t pick_word(uint32_t best, uint32_t cand);
template <>
__device__ __forceinline__ uint32_t pick_word<float>(uint32_t best, uint32_t cand) {
  return pick(best, cand);
}
// two bf16 a word, low one first
template <>
__device__ __forceinline__ uint32_t pick_word<__nv_bfloat16>(uint32_t best, uint32_t cand) {
  return pick(best & 0xffff0000u, cand & 0xffff0000u) | pick(best << 16, cand << 16) >> 16;
}

template <typename T>
__device__ __forceinline__ void take_max16(uint4& best, const uint8_t* p) {
  const uint4 c = *reinterpret_cast<const uint4*>(p);
  best.x = pick_word<T>(best.x, c.x);
  best.y = pick_word<T>(best.y, c.y);
  best.z = pick_word<T>(best.z, c.z);
  best.w = pick_word<T>(best.w, c.w);
}

// x, y as bytes and 16-byte vectors; W input columns, CV 16-byte vectors
// a pixel (C*sizeof(T)/16), K row pairs a chunk, pairs = N*H/2 in all
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
maxpool2_sm90_kernel(const uint8_t* __restrict__ x, uint4* __restrict__ y, int W, int CV, int K,
                     int pairs) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  uint8_t* ring = smem + BAR_BYTES;
  const uint32_t OW = (W + 1) / 2;
  const uint32_t row_bytes = 16u * W * CV;  // one input row
  const uint32_t stage_bytes = 2u * K * row_bytes;
  const int row_out = OW * CV;  // output vectors a row pair
  const int chunks = (pairs + K - 1) / K;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(saddr(full + s), 1);                // the producer's arrival, plus the bytes
      bar_init(saddr(empty + s), CONSUMER_WARPS);  // one arrival per consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tid < 32) {
    // producer: one thread keeps the ring full
    if (tid == 0) {
      uint32_t it = 0;
      for (int c = blockIdx.x; c < chunks; c += gridDim.x, ++it) {
        const int s = it % STAGES;
        const long long p0 = (long long)c * K;
        const uint32_t kc = pairs - p0 < K ? (uint32_t)(pairs - p0) : (uint32_t)K;
        bar_wait(saddr(empty + s), (it / STAGES & 1) ^ 1);
        bar_expect_tx(saddr(full + s), kc * 2 * row_bytes);
        load_1d(saddr(ring + s * stage_bytes), x + p0 * 2 * row_bytes, kc * 2 * row_bytes,
                saddr(full + s));
      }
    }
    return;
  }

  // consumers: this thread's output vectors j = ct + i*CONSUMERS of a
  // chunk, each at pixel t = j / CV (row pair t / OW, column t % OW),
  // vector j % CV; off[i] is its top-left corner in a stage, right[i]
  // the step to its right column (0 where the window is clipped)
  const int ct = tid - 32, lane = tid % 32;
  uint32_t off[MAX_ITEMS], right[MAX_ITEMS];
#pragma unroll
  for (int i = 0; i < MAX_ITEMS; ++i) {
    const uint32_t j = ct + i * CONSUMERS, t = j / CV, cv = j % CV;
    const uint32_t k = t / OW, ow = t % OW;
    off[i] = ((2 * k * W + 2 * ow) * CV + cv) * 16;
    right[i] = 2 * ow + 1 < (uint32_t)W ? 16 * CV : 0;
  }
  uint32_t it = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x, ++it) {
    const int s = it % STAGES;
    const long long p0 = (long long)c * K;
    const int n_out = (pairs - p0 < K ? (int)(pairs - p0) : K) * row_out;
    uint4* out = y + p0 * row_out;
    const uint8_t* stage = ring + s * stage_bytes;
    bar_wait(saddr(full + s), it / STAGES & 1);
#pragma unroll
    for (int i = 0; i < MAX_ITEMS; ++i) {
      const int j = ct + i * CONSUMERS;
      if (j < n_out) {
        const uint8_t* p = stage + off[i];
        uint4 best = *reinterpret_cast<const uint4*>(p);
        take_max16<T>(best, p + right[i]);
        take_max16<T>(best, p + row_bytes);
        take_max16<T>(best, p + row_bytes + right[i]);
        out[j] = best;
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(saddr(empty + s));
  }
}

template <typename T>
int launch(const void* x, void* y, int n, int h, int w, int c, int k, int grid, int stage_limit,
           cudaStream_t s) {
  const long long pairs = (long long)n * h / 2;
  const long long stage_bytes = 2ll * k * w * c * (long long)sizeof(T);
  // the launches the wrapper routes here; anything else is refused
  if (h % 2 != 0 || c * sizeof(T) % 16 != 0 || !aligned16(x) || !aligned16(y) || w < 1 ||
      k < 1 || grid < 1 || pairs < 1 || pairs >= (1ll << 31) - k || stage_bytes > STAGE_BYTES ||
      stage_limit != STAGE_BYTES)
    return (int)cudaErrorInvalidValue;
  auto kernel = maxpool2_sm90_kernel<T>;
  // allow this instantiation a full ring, once per device
  static unsigned allowed = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(allowed >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BAR_BYTES + STAGES * STAGE_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1u << dev;
  }
  const size_t smem = BAR_BYTES + STAGES * stage_bytes;
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const uint8_t*>(x), static_cast<uint4*>(y), w,
                                     (int)(c * sizeof(T) / 16), k, (int)pairs);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// The group design of the backward: one launch for the pools of a
// multigrid layer.
//
// The member table. The wrapper (cuda_pool.py::_group_plan) fills one
// Table a launch and it travels by value as a __grid_constant__ kernel
// parameter: no device allocation, no host-to-device copy. Member j has
// items[j] work items, one per lane of one pooled pixel: V = 16/sizeof(T)
// channels where C*sizeof(T) % 16 == 0 and its four pointers are 16-byte
// aligned (vec = 1), else one channel (vec = 0), so lane widths may differ
// within a group. An item's index is its lane's index in y and g, item =
// ((n*OH + oh)*OW + ow)*lanes + lane.
//
// Work. A tile is per_thread * THREADS consecutive items of one member;
// tile0[j] is the prefix sum of the earlier members' tiles, so a block
// finds the member of its tile by a scan of at most MAX_MEMBERS prefix
// sums, and a tile never straddles two members (the lane width and the
// shape are uniform over a block). Blocks walk the tiles blockIdx.x,
// + gridDim.x, ...; the wrapper sizes the grid from the card's SMs, so a
// group of tiny members still spreads over the SMs (per_thread 1) and a
// large one runs in one resident wave (per_thread MAX_ITEMS). Index
// math is 32-bit: the wrapper refuses a member whose x has 2^31 lanes or
// more, and launch_group() checks the table again.
//
// Loads before stores. Thread t of a tile takes items base + k*THREADS
// (k < per_thread; a warp's lanes are contiguous in y, g and each window
// corner of x) and issues every load of them first, y, g and up to four
// x lanes an item, with the streaming hint (ld.global.cs: each byte is
// read once), then computes and stores dx. The selection runs on 32-bit
// words (two bf16 a word) with the first-tie flags as bits of one
// register, so two items' 48 words stay in registers. No bulk-copy ring:
// the streaming part already runs near the card's rate one thread a lane.
namespace group {

constexpr int MAX_MEMBERS = 8;
constexpr int THREADS = 256;
constexpr int MAX_ITEMS = 2;
// blocks an SM: the launch bounds leave a thread 128 registers, so that
// two items' loads (48 words) stay in registers (at 3 blocks, 85
// registers, the bf16 kernels spilled and a batch-128 R-MG-34 step's
// pool backward took 0.886 ms against 0.769 at 2 on an H100 SXM at
// 700 W: probe_pool_bwd.py); the wrapper sizes the grid to this many
// blocks an SM (cuda_pool.py::GROUP_BLOCKS_PER_SM)
constexpr int MIN_BLOCKS = 2;

// one tensor of the group; field order and types are mirrored by
// cuda_pool.py::_Member
struct Member {
  const void* x;
  const void* y;
  const void* g;
  void* dx;
  int n, h, w, c;  // x's shape (NHWC); y, g (n, oh, ow, c); dx like x
  int oh, ow;
  int lanes;  // lanes a pixel: c / V, or c where vec is 0
  int vec;    // 1: a lane is V = 16/sizeof(T) channels; 0: one channel
  int items;  // n * oh * ow * lanes
  int tile0;  // the member's first tile
};

// mirrored by cuda_pool.py::_Table
struct Table {
  Member m[MAX_MEMBERS];
  int count;       // members, 1..MAX_MEMBERS
  int tiles;       // every member's tiles
  int per_thread;  // items a thread in a tile, 1..MAX_ITEMS
};

// A lane as L 32-bit words: a 16-byte lane is 4 words (4 f32 or 8 bf16
// values, the low half of a word first); a one-element lane 1 word (a
// bf16 value in its low half).
template <int L>
struct Lane {
  uint32_t w[L];
};

template <bool BF16, int L>
struct Io {
  static constexpr int BYTES = L == 4 ? 16 : BF16 ? 2 : 4;
  // lane i of base, read once: the streaming hint
  __device__ static __forceinline__ Lane<L> load(const void* base, uint32_t i) {
    const char* p = static_cast<const char*>(base) + (size_t)i * BYTES;
    Lane<L> r;
    if constexpr (L == 4) {
      const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
      r.w[0] = u.x, r.w[1] = u.y, r.w[2] = u.z, r.w[3] = u.w;
    } else if constexpr (BF16) {
      r.w[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
    } else {
      r.w[0] = __ldcs(reinterpret_cast<const unsigned*>(p));
    }
    return r;
  }
  __device__ static __forceinline__ void store(void* base, uint32_t i, const Lane<L>& v) {
    char* p = static_cast<char*>(base) + (size_t)i * BYTES;
    if constexpr (L == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
    else if constexpr (BF16)
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)v.w[0];
    else
      *reinterpret_cast<unsigned*>(p) = v.w[0];
  }
};

// One word of a corner's dx: each element g where x equals y as a float
// (NaN never does; -0 equals 0) and, under FIRST, no earlier corner of the
// window took it (bit `bit` of `taken`, and bit + 1 for a word's high
// bf16), else +0.
template <bool BF16, bool FIRST>
__device__ __forceinline__ uint32_t select_word(uint32_t x, uint32_t y, uint32_t g,
                                                uint32_t& taken, int bit) {
  if constexpr (BF16) {
    bool lo = __uint_as_float(x << 16) == __uint_as_float(y << 16);
    bool hi = __uint_as_float(x & 0xffff0000u) == __uint_as_float(y & 0xffff0000u);
    if constexpr (FIRST) {
      lo = lo && !(taken >> bit & 1u);
      hi = hi && !(taken >> (bit + 1) & 1u);
      taken |= (uint32_t)lo << bit | (uint32_t)hi << (bit + 1);
    }
    return (lo ? g & 0xffffu : 0u) | (hi ? g & 0xffff0000u : 0u);
  } else {
    bool hit = __uint_as_float(x) == __uint_as_float(y);
    if constexpr (FIRST) {
      hit = hit && !(taken >> bit & 1u);
      taken |= (uint32_t)hit << bit;
    }
    return hit ? g : 0u;
  }
}

// the items of one tile that thread threadIdx.x owns: base + k*THREADS
template <bool BF16, int L, bool FIRST>
__device__ __forceinline__ void tile(const Member& m, uint32_t base, int per_thread) {
  using IO = Io<BF16, L>;
  const uint32_t lanes = m.lanes, row = (uint32_t)m.w * lanes;  // x lanes a row
  Lane<L> yv[MAX_ITEMS], gv[MAX_ITEMS], xv[MAX_ITEMS][4];
  uint32_t x0[MAX_ITEMS];
  bool ok[MAX_ITEMS], right[MAX_ITEMS], down[MAX_ITEMS];
#pragma unroll
  for (int k = 0; k < MAX_ITEMS; ++k) {
    const uint32_t item = base + k * THREADS;
    ok[k] = k < per_thread && item < (uint32_t)m.items;
    right[k] = down[k] = false;
    x0[k] = 0;
    if (ok[k]) {
      const uint32_t lane = item % lanes;
      uint32_t t = item / lanes;
      const uint32_t ow = t % m.ow;
      t /= m.ow;
      const uint32_t oh = t % m.oh, n = t / m.oh;
      x0[k] = ((n * m.h + 2 * oh) * m.w + 2 * ow) * lanes + lane;
      right[k] = 2 * ow + 1 < (uint32_t)m.w;
      down[k] = 2 * oh + 1 < (uint32_t)m.h;
      yv[k] = IO::load(m.y, item);
      gv[k] = IO::load(m.g, item);
      xv[k][0] = IO::load(m.x, x0[k]);
      if (right[k]) xv[k][1] = IO::load(m.x, x0[k] + lanes);
      if (down[k]) xv[k][2] = IO::load(m.x, x0[k] + row);
      if (right[k] && down[k]) xv[k][3] = IO::load(m.x, x0[k] + row + lanes);
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_ITEMS; ++k) {
    if (!ok[k]) continue;
    uint32_t taken = 0;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {  // row-major window order
      const bool a = corner >= 2, b = corner % 2;
      if ((b && !right[k]) || (a && !down[k])) continue;  // clipped edge window
      Lane<L> out;
#pragma unroll
      for (int i = 0; i < L; ++i)
        out.w[i] = select_word<BF16, FIRST>(xv[k][corner].w[i], yv[k].w[i], gv[k].w[i], taken,
                                            BF16 ? 2 * i : i);
      IO::store(m.dx, x0[k] + (a ? row : 0) + (b ? lanes : 0), out);
    }
  }
}

template <bool BF16, bool FIRST>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
maxpool2_bwd_group_kernel(const __grid_constant__ Table t) {
  for (int tl = blockIdx.x; tl < t.tiles; tl += gridDim.x) {
    int j = 0;
#pragma unroll
    for (int k = 1; k < MAX_MEMBERS; ++k)
      if (k < t.count && tl >= t.m[k].tile0) j = k;
    const Member& m = t.m[j];
    const uint32_t base = (uint32_t)(tl - m.tile0) * (uint32_t)(t.per_thread * THREADS) + threadIdx.x;
    if (m.vec)
      tile<BF16, 4, FIRST>(m, base, t.per_thread);
    else
      tile<BF16, 1, FIRST>(m, base, t.per_thread);
  }
}

// the launches the wrapper plans; anything else is refused
bool valid(const Table& t, int grid, int elem_bytes) {
  if (t.count < 1 || t.count > MAX_MEMBERS || t.per_thread < 1 || t.per_thread > MAX_ITEMS ||
      grid < 1)
    return false;
  const long long tile_items = (long long)t.per_thread * THREADS;
  long long tiles = 0;
  for (int j = 0; j < t.count; ++j) {
    const Member& m = t.m[j];
    const int v = m.vec ? 16 / elem_bytes : 1;
    const long long items = (long long)m.n * m.oh * m.ow * m.lanes;
    const long long x_lanes = (long long)m.n * m.h * m.w * m.lanes;
    if (m.n < 1 || m.h < 1 || m.w < 1 || m.c < 1 || m.oh != (m.h + 1) / 2 ||
        m.ow != (m.w + 1) / 2 || (long long)m.lanes * v != m.c || items != m.items ||
        x_lanes >= (1ll << 31) || m.tile0 != tiles ||
        (m.vec && !(aligned16(m.x) && aligned16(m.y) && aligned16(m.g) && aligned16(m.dx))))
      return false;
    tiles += (items + tile_items - 1) / tile_items;
  }
  return tiles == t.tiles && tiles < (1ll << 31);
}

template <bool BF16, bool FIRST>
int launch_group(const Table& t, int grid, cudaStream_t s) {
  if (!valid(t, grid, BF16 ? 2 : 4)) return (int)cudaErrorInvalidValue;
  maxpool2_bwd_group_kernel<BF16, FIRST><<<grid, THREADS, 0, s>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace group

}  // namespace

extern "C" int mg_maxpool2(const void* x, void* y, int n, int h, int w, int c, int is_bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, n, h, w, c, s) : launch<float>(x, y, n, h, w, c, s);
}

// The sm90 design of mg_maxpool2, plus the planner's k (row pairs a
// chunk), grid and the stage limit it planned for: refuses, with
// cudaErrorInvalidValue, any launch the wrapper would not route here
extern "C" int mg_maxpool2_sm90(const void* x, void* y, int n, int h, int w, int c, int k,
                                int grid, int stage_limit, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? sm90::launch<__nv_bfloat16>(x, y, n, h, w, c, k, grid, stage_limit, s)
                 : sm90::launch<float>(x, y, n, h, w, c, k, grid, stage_limit, s);
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


// The group design: one launch for table->count tensors (the table of
// cuda_pool.py::_group_plan, passed by address and copied into the
// kernel's parameters; table_bytes is the caller's sizeof, refused unless
// it is this file's), under one tie rule and one dtype, on `grid` blocks.
// Refuses, with cudaErrorInvalidValue, a table the wrapper would not make.
extern "C" int mg_maxpool2_bwd_group(const void* table, int table_bytes, int grid, int first_only,
                                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table == nullptr || table_bytes != (int)sizeof(group::Table))
    return (int)cudaErrorInvalidValue;
  const group::Table& t = *static_cast<const group::Table*>(table);
  if (is_bf16)
    return first_only ? group::launch_group<true, true>(t, grid, s)
                      : group::launch_group<true, false>(t, grid, s);
  return first_only ? group::launch_group<false, true>(t, grid, s)
                    : group::launch_group<false, false>(t, grid, s);
}
