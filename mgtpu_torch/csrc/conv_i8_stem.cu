// The `stem` design of the int8 conv (conv_i8.cu has the other designs
// and the epilogue's contract): the convs on few input channels, Ci < 16
// with at most 160 taps x channels (k * k * Ci <= 160), Co = 16, 32 or
// 64 (the channel tile is Co). The zoo's stems: R-MG-34's and PR-MG's
// 7x7/2/p3 on 3 channels (147), cifar/prnmg's 3x3/1/p1 on 3 (27) and
// unmg's on 1 (9). Replaces no TPU kernel (see conv_i8.cu).
//
// What bounds it: bytes. A 7x7/2 stem at 128x224x224x3 -> 64 writes
// 205.5 MB of bf16 and reads 19.3 MB: 0.067 ms at 3.35 TB/s, against
// 0.015 ms of int8 products at 1,979 TOP/s. The `simple` design took
// 0.79 ms there: it gathered every A byte from device memory with four
// bounds checks, every block re-gathered and transposed the weight, its
// channel tile was 64 at any Co, and its epilogue wrote 4-byte pairs.
//
// The design:
// - Persistent blocks (as many as fit the SMs), each walking tiles of
//   128 output pixels, consecutive in (oh, ow) order within one image.
// - K: a kernel row's k * Ci taps x channels are contiguous bytes of an
//   input row, so slot kh * run + kw * Ci + c (run = k * Ci rounded up to
//   4; the weight is 0 in the padding) puts every 4-slot group of the A
//   operand in one input row: kh * pitch + 4q - kh * run bytes past the
//   pixel's base in the patch (the plan's offsets, in registers). One A
//   register is then two aligned shared-memory words and a funnel shift,
//   whatever the alignment. 7x7 on 3 channels: 7 x 24 = 168 slots, six
//   k32 steps.
// - Each block stages the weight once, in wgmma's K-major layout without
//   swizzle (core matrices of 8 channels x 16 slots).
// - A tile's input patch (whole input rows of its output rows) comes by
//   one bulk copy a row (TMA's cp.async.bulk, issued by one thread,
//   completing on the buffer's mbarrier), double-buffered: the next
//   tile's rows land while this tile multiplies. x may start at any byte
//   (a member of the quantizer's group output; a 56-px row of 3 channels
//   is 168 bytes): each row's copy is aligned down and up to 16 bytes,
//   and the patch's pitch is congruent to the row's bytes mod 16, so that
//   every row's data lands at one offset `lead + (its address % 16)`
//   fixed for the tile, which the pixel bases add. Once the rows landed,
//   what taps read outside x (the conv's zero padding, where the copies
//   brought the neighbours' bytes) is zeroed.
// - wgmma m64nCo k32 s8 -> s32 with A from registers: 8 warps of 16
//   pixels x Co channels, two warpgroups of 64 pixels; the B operand read
//   from shared memory by the tensor cores. (Tried on the H100 and not
//   faster at R-MG-34's first stem: mma.sync with ldmatrix B fragments,
//   3 blocks an SM, warps of 32 pixels, four patch buffers, the steps'
//   products as straight-line code, the bf16 rounding in integer ops.
//   Where the time goes: probe_conv_i8_stem.py.)
// - A ninth warp issues the patches' bulk copies (the full and empty
//   mbarriers of each buffer); the 8 others compute.
// - The epilogue, warp by warp (no block barrier): the warp's 16 x Co
//   tile staged in shared memory (the part sum loaded there first),
//   finished there (bf16: each rounding of a channel pair in one
//   conversion, the int32 sums made floats without the conversion unit),
//   and written with 16-byte stores: Co is the whole row, so a warp's
//   outputs are one contiguous range of y.
// The sums are exact: the result equals the other designs' and the plain
// version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "conv_i8.cuh"
#include "sm90_async.cuh"

namespace {

using namespace mg_i8;
using namespace mg_async;  // the mbarrier and the bulk copy

constexpr int BM = 128;        // output pixels a tile
constexpr int CONSUMERS = 256;  // 8 warps x 16 pixels
constexpr int THREADS = CONSUMERS + 32;  // and one warp that issues the patches' copies
constexpr int MAX_SLOTS = 160;  // k * k * Ci: the convs the design takes
constexpr int MAX_STEPS = 7;    // k32 steps: k * round_up(k * Ci, 4) <= 160 + 3k, k <= 12

// The host's plan (mgtpu_torch/ops/cuda_conv_i8.py::_stem_plan, a ctypes
// structure of this layout), a function of (W, Ci, Co, k, s, p, the
// output's element bytes); the launch recomputes it and refuses a plan
// that differs.
struct StemPlan {
  int run;          // a kernel row's k * Ci bytes rounded up to 4: slot kh * run + kw * Ci + c
  int steps;        // k32 steps: ceil(k * run / 32)
  int lm, rm;       // bytes left and right of a row's data that taps read
  int pitch;        // bytes a patch row: W * Ci + a multiple of 16 >= max(lm, 16) + max(rm, 16)
  int lead;         // lm rounded up to 16: row 0's data sits at lead + (its address % 16)
  int rows;         // patch rows a tile at most: (output rows - 1) * s + k
  int patch_bytes;  // one patch buffer
  int smem;         // the block's dynamic shared memory
  // [step][t][2]: the patch offsets of slot groups 8 * step + t and
  // 8 * step + 4 + t (4 slots each), the A registers lane t of a warp loads
  uint16_t off[MAX_STEPS * 4 * 2];
};

StemPlan make_plan(int wd, int ci, int co, int k, int s, int p, int es) {
  StemPlan L{};
  const int ow = (wd + 2 * p - k) / s + 1, row = wd * ci;
  L.run = (k * ci + 3) / 4 * 4;
  L.steps = (k * L.run + 31) / 32;
  L.lm = p * ci;
  L.rm = ci * ((ow - 1) * s - p + k - wd > 0 ? (ow - 1) * s - p + k - wd : 0);
  const int l16 = L.lm > 16 ? L.lm : 16, r16 = L.rm > 16 ? L.rm : 16;
  L.pitch = row + (l16 + r16 + 15) / 16 * 16;
  L.lead = (L.lm + 15) / 16 * 16;
  int g = BM, b = ow;  // gcd(128, ow): tile starts sit at multiples of it within a row
  while (b) {
    const int t = g % b;
    g = b;
    b = t;
  }
  const int out_rows = (ow - g + BM - 1) / ow + 1;
  L.rows = (out_rows - 1) * s + k;
  L.patch_bytes = ((L.rows - 1) * L.pitch + L.lead + 15 + row + r16 + 15) / 16 * 16;
  L.smem = 2 * L.patch_bytes + BM * (co * es + 16) + co * 32 * L.steps + 8 * co + 32;
  for (int st = 0; st < L.steps; ++st)
    for (int t = 0; t < 4; ++t)
      for (int h = 0; h < 2; ++h) {
        const int q = 8 * st + 4 * h + t, kh = 4 * q / L.run;
        L.off[(st * 4 + t) * 2 + h] =
            static_cast<uint16_t>(kh < k ? kh * L.pitch + 4 * q - kh * L.run : 0);
      }
  return L;
}

// One tile: image n, output pixels q0 .. q1 - 1 of it (in oh * ow + ow
// order); its patch holds input rows ih0 .. ih0 + rows - 1, row r's data
// at r * pitch + c0; src0: where row ih0's bytes would start in device
// memory (rows above x only in arithmetic)
struct Tile {
  int n, q0, q1, oh0, ih0, rows, c0;
  uintptr_t src0;
};

struct Geo {
  int n, h, w, ci, co, k, s, p, pad_top, oh, ow, tiles_per_image;
  long long tap_stride;
};

__device__ __forceinline__ Tile tile_at(int t, const Geo& g, const StemPlan& L, uintptr_t xa) {
  Tile T;
  T.n = t / g.tiles_per_image;
  T.q0 = (t - T.n * g.tiles_per_image) * BM;
  T.q1 = min(T.q0 + BM, g.oh * g.ow);
  T.oh0 = T.q0 / g.ow;
  T.rows = ((T.q1 - 1) / g.ow - T.oh0) * g.s + g.k;
  T.ih0 = T.oh0 * g.s - g.pad_top;
  T.src0 = xa + static_cast<uintptr_t>((static_cast<long long>(T.n) * g.h + T.ih0) * g.w * g.ci);
  T.c0 = L.lead + static_cast<int>(T.src0 & 15);
  return T;
}

// One thread: the bulk copies of tile T's rows in x into buf, each row's
// bytes aligned down and up to 16 (on 16-byte boundaries in buf too: the
// plan's pitch = W * Ci mod 16 and its lead = 0 mod 16), completing on
// bar. The buffer's earlier generic accesses are ordered before them.
__device__ __forceinline__ void issue_patch(const Tile& T, uint8_t* buf, uint64_t* bar,
                                            const Geo& g, const StemPlan& L) {
  const int bytes = g.w * g.ci;
  const int r0 = max(0, -T.ih0), r1 = min(T.rows, g.h - T.ih0);
  uint32_t total = 0;
  for (int r = r0; r < r1; ++r) {
    const uintptr_t src = T.src0 + static_cast<uintptr_t>(r) * bytes;
    total += static_cast<uint32_t>((src + bytes + 15) / 16 * 16 - src / 16 * 16);
  }
  fence_async_smem();
  bar_expect_tx(saddr(bar), total);
  for (int r = r0; r < r1; ++r) {
    const uintptr_t src = T.src0 + static_cast<uintptr_t>(r) * bytes;
    const uintptr_t first = src & ~static_cast<uintptr_t>(15);
    const uint32_t len = static_cast<uint32_t>((src + bytes + 15 - first) / 16 * 16);
    load_1d(saddr(buf + r * L.pitch + T.c0 - (src - first)), reinterpret_cast<const void*>(first),
            len, saddr(bar));
  }
}

// Once tile T's copies landed: zero what taps read outside x, the rows
// above and below it and each row's left and right margins (the copies
// brought the neighbouring bytes there)
__device__ __forceinline__ void zero_outside(const Tile& T, uint8_t* buf, const Geo& g,
                                             const StemPlan& L, int warp, int lane) {
  const int bytes = g.w * g.ci;
  for (int r = warp; r < T.rows; r += CONSUMERS / 32) {
    uint8_t* row = buf + r * L.pitch + T.c0;
    const int ih = T.ih0 + r;
    if (ih < 0 || ih >= g.h) {
      for (int i = lane; i < L.lm + bytes + L.rm; i += 32) row[i - L.lm] = 0;
    } else {
      for (int i = lane; i < L.lm; i += 32) row[i - L.lm] = 0;
      for (int i = lane; i < L.rm; i += 32) row[bytes + i] = 0;
    }
  }
}

// the 4 patch bytes at byte a of buf (any alignment), as one A register
// (the first byte lowest): two aligned words, funnel-shifted
__device__ __forceinline__ uint32_t word_at(const uint8_t* buf, int a) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(buf + (a & ~3));
  return __funnelshift_r(p[0], p[1], (a & 3) * 8);
}

// float(a) exactly for |a| < 2^22 (a stem's sums: at most 160 products of
// at most 2^14), without the int-to-float conversion (a quarter-rate
// instruction): 1.5 * 2^23 + a as a float's bits, less 1.5 * 2^23
__device__ __forceinline__ float small_int_float(int a) {
  return __int_as_float(0x4B400000 + a) - 12582912.f;
}

// two floats rounded to bf16 (nearest even) in one conversion, packed a low
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float lo_f(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// finish() of two adjacent bf16 outputs, each rounding of the pair one
// conversion: a0, a1 their sums, v their dequant factors, prev the part
// sum's packed pair, b the biases already rounded to bf16. Bit for bit
// finish()'s: the same operations in the same order; the ReLU after the
// last rounding (a negative that rounds to -0 stays -0, NaN stays NaN).
__device__ __forceinline__ uint32_t finish_bf16x2(int a0, int a1, float v0, float v1,
                                                  uint32_t prev, float b0, float b1, bool has_in,
                                                  bool has_bias, int relu) {
  uint32_t t = bf16x2(__fmul_rn(small_int_float(a0), v0), __fmul_rn(small_int_float(a1), v1));
  if (has_in) t = bf16x2(__fadd_rn(lo_f(prev), lo_f(t)), __fadd_rn(hi_f(prev), hi_f(t)));
  if (has_bias) t = bf16x2(__fadd_rn(lo_f(t), b0), __fadd_rn(hi_f(t), b1));
  if (relu) {
    const uint32_t lo = lo_f(t) < 0.f ? 0u : t & 0xffffu;
    const uint32_t hi = hi_f(t) < 0.f ? 0u : t >> 16;
    t = lo | hi << 16;
  }
  return t;
}

// d += a (64 x 32 s8, this warp's 16 rows in registers, as mma.sync's
// m16n8k32 A fragment) * B (32 x BN s8, K-major in shared memory at
// descriptor b); s32 accumulators, d[4j + q] as mma.sync's n8 tile j
template <int BN>
__device__ __forceinline__ void wgmma_rs(int (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(int (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// ES: the output's element bytes (4: s32 or f32; 2: bf16); BN = Co.
// Warp 8 issues the patches' copies (full[b]: buffer b's rows landed;
// empty[b]: the 8 consumer warps are done with it); warps 0-7 multiply
// and finish, synchronizing among themselves on named barrier 1.
template <int BN, int ES>
__global__ void __launch_bounds__(THREADS, 2)
    conv_i8_stem_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epi e,
                        void* y, int out, Geo g, const __grid_constant__ StemPlan L) {
  constexpr int SP = BN * ES + 16;  // staging pitch: a warp's 8 rows on distinct banks
  constexpr int ROW = BN * ES;      // bytes an output pixel
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* patch = smem;  // two buffers of L.patch_bytes
  uint8_t* stg = smem + 2 * L.patch_bytes;
  const int K = 32 * L.steps;
  // the weight in wgmma's K-major layout without swizzle: core matrices of
  // 8 channels x 16 slots (128 bytes, a channel's 16 slots a row); core
  // matrix (channels 8n.., slots 16kc..) at (n * K / 16 + kc) * 128: 128
  // bytes apart along K (the descriptor's leading offset), 8 * K along
  // the channels (its stride offset)
  int8_t* ws = reinterpret_cast<int8_t*>(stg + BM * SP);
  float* vb = reinterpret_cast<float*>(ws + BN * K);  // dequant factors, then biases
  uint64_t* full = reinterpret_cast<uint64_t*>(vb + 2 * BN);
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int tiles = g.n * g.tiles_per_image;  // < 2^31: the launch checks
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      bar_init(saddr(full + b), 1);
      bar_init(saddr(empty + b), CONSUMERS / 32);
    }
    bar_init_fence();
  }
  __syncthreads();
  if (warp == CONSUMERS / 32) {  // the producer: its first lane walks the block's tiles
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        if (it >= 2) bar_wait(saddr(empty + (it & 1)), ((it >> 1) - 1) & 1);
        issue_patch(tile_at(tile, g, L, xa), patch + (it & 1) * L.patch_bytes, full + (it & 1),
                    g, L);
      }
    }
    return;
  }

  // once a block: the weight, slot kh * run + kw * Ci + c of channel co
  // (zero past a kernel row's k * Ci and past k rows; its HWIO bytes
  // loaded 8 at a time, then stored), the dequant factors and the biases
  // (rounded to bf16 for a bf16 output), this lane's patch offsets
  const int kc = g.k * g.ci;
  for (int i0 = tid; i0 < BN * K; i0 += 8 * CONSUMERS) {
    int8_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * CONSUMERS, slot = i / BN, co = i % BN;  // co fastest: coalesced
      const int kh = slot / L.run, r = slot - kh * L.run;
      v[u] = 0;
      if (i < BN * K && kh < g.k && r < kc) {
        const int kw = r / g.ci, c = r - kw * g.ci;
        v[u] = w[(kh * g.k + kw) * g.tap_stride + static_cast<long long>(c) * g.co + co];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * CONSUMERS;
      const int co = i % BN, slot = i / BN;
      if (i < BN * K)
        ws[((co >> 3) * (K / 16) + (slot >> 4)) * 128 + (co & 7) * 16 + (slot & 15)] = v[u];
    }
  }
  if (out != OUT_S32)
    for (int i = tid; i < BN; i += CONSUMERS) {
      vb[i] = __fmul_rn(__ldg(e.sx), __ldg(e.scale + i));
      const float b = e.bias != nullptr ? __ldg(e.bias + i) : 0.f;
      vb[BN + i] = out == OUT_BF16 ? bf16_round(b) : b;
    }
  const int gq = lane >> 2, t = lane & 3;
  uint32_t offs[MAX_STEPS];  // this lane's two group offsets a step, packed
#pragma unroll
  for (int st = 0; st < MAX_STEPS; ++st)
    offs[st] = st < L.steps ? L.off[(st * 4 + t) * 2] | static_cast<uint32_t>(
                                                           L.off[(st * 4 + t) * 2 + 1]) << 16
                            : 0u;

  const bool has_in = e.y_in != nullptr, has_bias = e.bias != nullptr;
  const bool vec_out = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const bool vec_in = reinterpret_cast<uintptr_t>(e.y_in) % 16 == 0;
  uint8_t* wstg = stg + warp * 16 * SP;  // this warp's 16 rows of the staged tile
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    uint8_t* buf = patch + (it & 1) * L.patch_bytes;
    const Tile T = tile_at(tile, g, L, xa);
    bar_wait(saddr(full + (it & 1)), (it >> 1) & 1);
    zero_outside(T, buf, g, L, warp, lane);
    // the patch is whole (and the weight staged, the first time); each
    // warp's copy-out of its last tile is done
    named_sync(1, CONSUMERS);

    // this thread's two pixels: tile rows 16 * warp + gq and + 8
    int base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = T.q0 + 16 * warp + gq + 8 * h;
      base[h] = T.c0;
      if (q < T.q1) {
        const int oh = q / g.ow, ow = q - oh * g.ow;
        base[h] += (oh - T.oh0) * g.s * L.pitch + (ow * g.s - g.p) * g.ci;
      }
    }
    // the A fragments of every step, then one wgmma a step (this warp's
    // 16 rows of its warpgroup's 64)
    uint32_t a[MAX_STEPS][4];
#pragma unroll
    for (int st = 0; st < MAX_STEPS; ++st) {
      if (st >= L.steps) break;
      const int lo = offs[st] & 0xffff, hi = offs[st] >> 16;
      a[st][0] = word_at(buf, base[0] + lo);
      a[st][1] = word_at(buf, base[1] + lo);
      a[st][2] = word_at(buf, base[0] + hi);
      a[st][3] = word_at(buf, base[1] + hi);
    }
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_regs(acc);
    mma_fence();
#pragma unroll
    for (int st = 0; st < MAX_STEPS; ++st) {
      if (st >= L.steps) break;
      // slots 32 st..: core matrices 2 st and 2 st + 1 along K
      wgmma_rs<BN>(acc, a[st], gmma_desc(saddr(ws) + 256 * st, 128, 8 * K, 0));
    }
    mma_commit();
    mma_wait<0>();
    fence_regs(acc);
    // done with the buffer: order this warp's generic accesses to it before
    // the producer's next copies into it, then release it
    fence_async_smem();
    __syncwarp();
    if (lane == 0) bar_arrive(saddr(empty + (it & 1)));

    // the epilogue, warp by warp: its 16 pixels' outputs are one
    // contiguous range of y (rows past the tile's end are finished in the
    // staging tile and not written)
    const int rows = max(0, min(16, T.q1 - T.q0 - 16 * warp));
    const long long m0 = static_cast<long long>(T.n) * g.oh * g.ow + T.q0 + 16 * warp;
    if (has_in) {
      copy_rows(wstg, SP, const_cast<uint8_t*>(static_cast<const uint8_t*>(e.y_in)) + m0 * ROW,
                ROW, rows, ROW, vec_in, false, lane, 32);
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      float v0 = 0.f, v1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (out != OUT_S32) {
        const float2 v = *reinterpret_cast<const float2*>(vb + c);
        const float2 b = *reinterpret_cast<const float2*>(vb + BN + c);
        v0 = v.x, v1 = v.y, b0 = b.x, b1 = b.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint8_t* p = wstg + (gq + 8 * h) * SP + c * ES;
        if (out == OUT_BF16) {
          uint32_t* q = reinterpret_cast<uint32_t*>(p);
          *q = finish_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], v0, v1,
                             has_in ? *q : 0u, b0, b1, has_in, has_bias, e.relu);
        } else {
          finish_pair(p, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], out, v0, v1, b0, b1, e);
        }
      }
    }
    __syncwarp();
    copy_rows(wstg, SP, static_cast<uint8_t*>(y) + m0 * ROW, ROW, rows, ROW, vec_out, true, lane,
              32);
  }
}

template <int BN, int ES>
int launch_cfg(const int8_t* x, const int8_t* w, const Epi& e, void* y, int out, const Geo& g,
               const StemPlan& L, cudaStream_t stream) {
  auto kernel = conv_i8_stem_kernel<BN, ES>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  // allow this instantiation a block's whole shared memory, once per device
  static unsigned allowed = 0;
  if (!(allowed >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed |= 1u << dev;
  }
  // blocks an SM at this shared memory, kept for the last size asked
  static int last_smem = -1, last_per_sm = 0;
  if (L.smem != last_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last_per_sm, kernel, THREADS, L.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_smem = L.smem;
  }
  if (last_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = static_cast<long long>(g.n) * g.tiles_per_image;
  const long long cap = static_cast<long long>(last_per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(tiles < cap ? tiles : cap);
  kernel<<<grid, THREADS, L.smem, stream>>>(x, w, e, y, out, g, L);
  return static_cast<int>(cudaGetLastError());
}

template <int ES>
int launch_es(const int8_t* x, const int8_t* w, const Epi& e, void* y, int out, const Geo& g,
              const StemPlan& L, cudaStream_t stream) {
  switch (g.co) {
    case 16:
      return launch_cfg<16, ES>(x, w, e, y, out, g, L, stream);
    case 32:
      return launch_cfg<32, ES>(x, w, e, y, out, g, L, stream);
    default:
      return launch_cfg<64, ES>(x, w, e, y, out, g, L, stream);
  }
}

}  // namespace

// The stem design: the arguments of mg_conv_i8 (w the HWIO slice, taps
// w_tap_stride elements apart), then the plan (a StemPlan, plan_bytes
// its size) the host made for this shape; returns cudaErrorInvalidValue
// for what the design does not take (Ci >= 16, k * k * Ci > 160, Co not
// 16, 32 or 64) and for a plan that is not the one make_plan gives.
extern "C" int mg_conv_i8_stem(const void* x, const void* w, const void* sx, const void* scale,
                               const void* y_in, const void* bias, void* y, int n, int h,
                               int wd, int ci, int co, int k, int s, int p,
                               long long w_tap_stride, int out_kind, int relu, int pad_top,
                               int pad_bottom, const void* plan, int plan_bytes, void* stream) {
  const Epi e{static_cast<const float*>(sx), static_cast<const float*>(scale), y_in,
              static_cast<const float*>(bias), relu};
  if (bad_args(e, y, n, h, wd, ci, co, k, s, p, pad_top, pad_bottom, out_kind) || ci >= 16 ||
      k * k * ci > MAX_SLOTS || (co != 16 && co != 32 && co != 64) ||
      plan_bytes != static_cast<int>(sizeof(StemPlan)))
    return cudaErrorInvalidValue;
  const int es = out_kind == OUT_BF16 ? 2 : 4;
  const StemPlan L = make_plan(wd, ci, co, k, s, p, es);
  if (std::memcmp(&L, plan, sizeof(StemPlan)) != 0 || L.smem > 227 * 1024 ||
      (k - 1) * L.pitch + L.run > 65535)  // the offsets are 16-bit
    return cudaErrorInvalidValue;
  const int oh = (h + pad_top + pad_bottom - k) / s + 1, ow = (wd + 2 * p - k) / s + 1;
  const Geo g{n, h, wd, ci, co, k, s, p, pad_top, oh, ow, (oh * ow + BM - 1) / BM, w_tap_stride};
  if (static_cast<long long>(n) * g.tiles_per_image >= (1ll << 31)) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  return es == 2 ? launch_es<2>(xp, wp, e, y, out_kind, g, L, st)
                 : launch_es<4>(xp, wp, e, y, out_kind, g, L, st);
}
