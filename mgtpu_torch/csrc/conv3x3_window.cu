// The window design of the 3x3, stride 1, pad 1 NHWC convolutions
// mg_conv3x3 and mg_conv3x3_bn_relu_in (see conv3x3.cu's head for the
// function, the per-side H padding and the other two designs): bf16 and
// f32, any Ci and Co, weight slices (taps w_tap_stride elements apart),
// pad_top / pad_bottom 0 or 1. It takes every launch that
// mgtpu_torch/ops/cuda_conv.py::_route does not send to sm90: bf16 with
// Ci or Co not a multiple of 64, and all of f32. f32 has two branches:
// route "window_tf32" (TF32 tensor cores) where
// torch.backends.cudnn.allow_tf32 is True, PyTorch's own switch for
// convs, and Co >= 8 and the weights fit; route "window" (exact FMAs on
// the CUDA cores) for the rest, every f32 launch among them when the flag
// is False.
//
// Replaces: mgtpu/ops/pallas_conv.py::conv3x3 (as mg_conv3x3_window) and
// pallas_conv.py::conv3x3_bn_relu_in (as mg_conv3x3_bn_relu_in_window),
// at those shapes, in place of the first design, tile (conv3x3.cu).
//
// Bound on this card: at the narrow bf16 shapes (Ci, Co of 1 to 128 on 7x7
// to 64x64 grids) a launch moves a few MB and does a few GFLOP: it is
// bound by latency and by its bytes, not by the tensor cores. The f32
// saliency forward's convs (3,368 images of 64x64): on the FMA branch by
// the f32 rate outside the tensor cores (67 TFLOP/s); on the TF32 branch
// 64x64x64->64 does about 151 FLOP a byte of x and y, on TF32's ridge of
// ~148 (495 TFLOP/s over 3.35 TB/s), so both bounds meet there, and
// wgmma at N = 64 reads 4 KB of shared memory a 64x64x8 product, about
// the 128 bytes a cycle an SM has at TF32's rate; Ci = 1 stems are bound
// by the bytes of y, and Co = 1 stays on the FMA branch (an n8 tile would
// compute 7 zero columns of 8).
//
// What tile did and what this design does instead:
//   - tile gathered A again for every tap from device memory, in one
//     synchronous shared-memory stage. Here a block owns a tile of TI
//     images x TH output rows x TW columns (at most 128 pixels) and loads
//     its input window, TI x (TH + 2) x (TW + 2) pixels of Ci channels,
//     into shared memory once, with 16-byte cp.async where Ci and x allow
//     (element loads otherwise). Positions outside x are zero: that is
//     the padding; the window's first row is h0 - pad_top, so halo rows
//     are loaded. The 9 taps are shifted views of the window. The
//     prologue (bn_relu, as tile computes it) is applied to the window
//     once, in place, where a position lies in x: padding stays 0.
//   - Blocks are persistent over the tiles of one output-channel slice
//     (blockIdx.y); in bf16 and TF32 the window has two stages where they
//     fit, so a block loads its next tile while it computes this one, and
//     the weight slice (9 x Ci x BN) stays in shared memory for the
//     block's life. Where it does not fit, Ci is cut into chunks of KC
//     channels: in bf16 each stage holds a window chunk and its 9 x KC x
//     BN weights; in TF32 the weights of all chunks stay and the stages
//     hold window chunks.
//   - Tiles are sized to the shape (the host plan,
//     mgtpu_torch/ops/cuda_conv.py::_window_plan, picks TI, TH, TW, BN,
//     KC, the stages and the grid, and passes the shared-memory bytes,
//     which this file recomputes and refuses if they differ):
//       bf16: mma.sync m16n8k16 (f32 accumulators) fed by ldmatrix from
//         the window and the weights; 4 warps, each two m16 row tiles of
//         the block's 128 pixels and all BN = 8, 16, 32 or 64 channels
//         (Co = 16 or 32 computes no zero columns). K is walked densely,
//         16 channels of one tap a step; for Ci < 16 (1, 3, 8, 10) the
//         taps are packed, K = 9*Ci slots in steps of 16, the A fragments
//         gathered through a table of slot offsets (as conv_i8's simple
//         design packs its K walk).
//       TF32 (f32 operands, route window_tf32), Ci >= 8: wgmma
//         m64nBNk8 .tf32 (f32 accumulators). Two warpgroups a block share
//         one copy of the weights and walk tiles of their own through
//         their own window stages, so that one's products run while the
//         other waits for its window, rounds it or stores a tile (one
//         warpgroup an SM ran 64x64x64->64 at 12.1 ms, two at 7.9). A
//         tile is the bf16 branch's 128 output pixels cut into two m64
//         units of 8 rows x 8 columns of one image (8 columns by 16
//         rows, or two images of 8 rows; pixels past the image are
//         computed on zeros and not stored). The window chunk lands by one TMA box as kc / 4
//         planes of 16 bytes a slot (a 5-D map of x: 4 channels, W, H, N,
//         the planes), so 8 pixels of a unit's row are one 128-byte core
//         matrix of wgmma's K-major A without swizzle: a tap's A is the
//         window's address shifted by the tap, core matrices sw slots
//         apart, planes slots x 16 bytes apart. The weights of all chunks
//         stay for the block's life in the same K-major planes (output
//         channels x 16 bytes). Every operand is rounded to TF32 once
//         (cvt.rna: to nearest, ties away from zero) as it lands: the
//         weights on their way through registers, each window chunk in
//         place after its copies land (and after the prologue). A unit
//         of work (tile, chunk) sends all its taps' and 8-channel
//         steps' products at once; while they run the warpgroup's next
//         window is rounded; 1 to 3 stages a warpgroup by the plan. The
//         route sends it only x that TMA takes (Ci a multiple of 4, x on
//         16 bytes).
//       TF32, Ci < 8 (the 1-channel stems): mma.sync m16n8k8 .tf32 with
//         the bf16 branch's packed K walk (K = 9*Ci slots in steps of 8,
//         A gathered through the slot table by 32-bit loads, B by
//         ldmatrix on b16 pairs from K-major rows of an odd number of
//         16-byte units); the window rounded in place once it lands.
//       f32 (FMA): FMAs on the CUDA cores (no TF32): each thread an 8x8, 8x4,
//         4x4, 2x4 or 1x1 (pixels x channels) register tile by BN = 64,
//         32, 16, 8 or 1, 16-byte shared-memory reads of 4 channels of A
//         and of B. The weights stream by tap, two stages of KC x BN, or
//         where all 9 taps take at most 48 KB they stay for the block's
//         life; the window has one stage (the 2-4 blocks an SM overlap
//         loads with math). Each output is one fmaf chain from its bias, taps outer,
//         channels inner, as tile computes it: where Ci <= 64 (one chunk)
//         the result equals tile's bit for bit (channel padding adds
//         fmaf(0, 0, acc) in both).
//   - The epilogue from registers: the accumulators start at the bias in
//     registers; the running part sum y_in, where given, added in f32
//     (read by the same threads, at the same places and widths, as y is
//     written: 4, 8 or 16 bytes a thread); ReLU (NaN stays NaN);
//     per-channel sums by warp shuffles into a per-block (2, BN) sum in
//     shared memory, flushed with one
//     atomicAdd per channel per block at the end (the order of the
//     atomics varies from run to run, as tile's does); y stored from
//     registers, 4 bytes (bf16 pairs), 8 bytes (TF32 pairs) or 16 bytes
//     (f32 FMA) a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_async.cuh"

namespace {

using mg_async::saddr;

constexpr int THREADS = 128;     // 4 warps
constexpr int MAX_TPX = 128;     // output pixels a tile
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory on the H100
constexpr int F32_RESIDENT = 49152;  // f32: the 9 taps' weights stay in shared memory up to this
// the branches, as the launch's `kind` names them
constexpr int KIND_F32 = 0, KIND_BF16 = 1, KIND_TF32 = 2;

// The launch's shape and tiling, computed on the host
struct Geo {
  int n, h, w, ci, co, hin, pad_top;
  long long wts;       // elements between taps of the weight (slice)
  int ti, th, tw;      // the tile: images, output rows, columns
  int tiles_h, tiles_w, ptiles;
  int sh, sw, slots;   // the window: (th + 2) x (tw + 2) slots an image, ti images
  int tpx;             // ti * th * tw
};

__host__ __device__ inline int up16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int up128(int v) { return (v + 127) & ~127; }

// Shared-memory layout of a block; mirrored by cuda_conv.py::_window_smem
struct Layout {
  int packed;        // bf16 with Ci < 16, TF32 with Ci < 8: the taps packed into the K walk
  int resident;      // f32: all 9 taps' weights kept (one chunk, at most F32_RESIDENT)
  int kc;            // channels of a chunk (packed: Ci)
  int cp;            // elements a window slot holds (kc + padding)
  int chunks;        // ceil(Ci / kc), Ci rounded up to 16 (bf16), 8 (TF32) or 4 (f32)
  int rows;          // weight rows of a chunk (bf16: 9 * kc, packed: 9 * Ci
                     // rounded up to 16; f32: kc, one tap); TF32: K, the
                     // weights' slots of all chunks (9 * Ci rounded up to 8
                     // packed, 9 * Ci8 dense, Ci8 = Ci rounded up to 8)
  int bnp;           // elements a weight row holds (bn + padding); TF32: a
                     // K-major row (one output channel) of rows + padding
  int win_bytes, w_bytes, stage_bytes;  // f32: w_bytes is one tap's
  int off_w, off_win, off_koff, off_stats, smem;
};

__host__ __device__ inline Layout make_layout(int kind, int ci, int bn, int kc, int stages,
                                              int slots) {
  Layout L{};
  if (kind == KIND_TF32) {
    L.packed = ci < 8;
    L.kc = L.packed ? ci : kc;
    L.chunks = L.packed ? 1 : ((ci + 7) / 8 * 8 + kc - 1) / kc;
    L.rows = L.packed ? (9 * ci + 7) / 8 * 8 : 9 * ((ci + 7) / 8 * 8);
    // packed (mma.sync): slots of Ci f32, and K-major weight rows of rows +
    // 4 f32, an odd number of 16-byte units (rows is a multiple of 8), so
    // ldmatrix's 8 rows fall on 8 bank groups; dense (wgmma, no swizzle):
    // the window chunk and the weights as planes of 4 channels (slots x 16
    // bytes, bn x 16 bytes), 128-byte core matrices
    L.cp = L.packed ? ci : kc;
    L.bnp = L.packed ? L.rows + 4 : L.rows;
    // the weights of all chunks stay for the block's life; the stages
    // hold window chunks (dense: each of two warpgroups its own, on 128
    // bytes, TMA's destinations); then the packed K table or the dense
    // stages' TMA barriers
    L.win_bytes = L.packed ? up16(slots * L.cp * 4) : up128(slots * L.cp * 4);
    L.w_bytes = L.packed ? up16(bn * L.bnp * 4) : up128(bn * L.bnp * 4);
    L.off_w = 0;
    L.off_win = L.w_bytes;
    L.stage_bytes = L.win_bytes;
    const int groups = L.packed ? 1 : 2;  // dense: two warpgroups, stages each
    int end = L.off_win + groups * stages * L.stage_bytes;
    L.off_koff = end;
    end += L.packed ? L.rows * 4 : 8 * groups * stages;
    L.off_stats = end;
    L.smem = end + 2 * bn * 4 + (L.packed ? 0 : 128);
  } else if (kind == KIND_BF16) {
    L.packed = ci < 16;
    L.kc = L.packed ? ci : kc;
    // ldmatrix reads 16-byte rows: a slot of cp/8 (odd) 16-byte units puts
    // 8 neighbouring pixels' rows on 8 different bank groups
    L.cp = L.packed ? ci : kc + 8;
    L.chunks = L.packed ? 1 : ((ci + 15) / 16 * 16 + kc - 1) / kc;
    L.rows = L.packed ? (9 * ci + 15) / 16 * 16 : 9 * kc;
    L.bnp = (bn / 8) % 2 == 0 ? bn + 8 : bn;
    L.win_bytes = up16(slots * L.cp * 2);
    L.w_bytes = up16(L.rows * L.bnp * 2);
    // one chunk: the weights stay for the block's life and the windows
    // take the stages; several: a stage holds a window chunk and its weights
    if (L.chunks == 1) {
      L.off_w = 0;
      L.off_win = L.w_bytes;
      L.stage_bytes = L.win_bytes;
    } else {
      L.off_win = 0;
      L.off_w = L.win_bytes;
      L.stage_bytes = L.win_bytes + L.w_bytes;
    }
    int end = (L.chunks == 1 ? L.w_bytes : 0) + stages * L.stage_bytes;
    L.off_koff = end;
    end += L.packed ? L.rows * 4 : 0;
    L.off_stats = end;
    L.smem = end + 2 * bn * 4;
  } else {
    const int ci4 = (ci + 3) / 4 * 4;
    L.kc = kc;
    // 16-byte reads of 4 channels: cp/4 odd puts neighbouring pixels on
    // different bank groups
    L.cp = (kc / 4) % 2 == 0 ? kc + 4 : kc;
    L.chunks = (ci4 + kc - 1) / kc;
    L.rows = kc;
    L.bnp = bn;
    L.win_bytes = up16(slots * L.cp * 4);
    L.w_bytes = up16(kc * bn * 4);
    L.resident = L.chunks == 1 && 9 * L.w_bytes <= F32_RESIDENT;
    L.stage_bytes = L.win_bytes;
    L.off_win = 0;
    L.off_w = L.win_bytes;  // the 9 taps, or two tap stages
    L.off_stats = L.win_bytes + (L.resident ? 9 : 2) * L.w_bytes;
    L.smem = L.off_stats + 2 * bn * 4;
  }
  return L;
}

// ------------------------------------------------------------ helpers

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  // ok false: 16 zero bytes, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// BN-apply + ReLU of the prologue, as conv3x3.cu's bn_relu: a product,
// then a sum (no fused multiply-add); NaN stays NaN
__device__ __forceinline__ float bn_relu(float v, const float* scale, const float* shift, int c) {
  v = __fadd_rn(__fmul_rn(v, __ldg(scale + c)), __ldg(shift + c));
  return v < 0.f ? 0.f : v;
}

// the first tile of the block's walk: (first image, first output row,
// first column) of tile t
__device__ __forceinline__ void origin(const Geo& g, int t, int& img0, int& h0, int& w0) {
  w0 = t % g.tiles_w * g.tw;
  h0 = t / g.tiles_w % g.tiles_h * g.th;
  img0 = t / (g.tiles_w * g.tiles_h) * g.ti;
}

// Walks the (window slot, group) pairs i = threadIdx.x, + THREADS, ...
// of a window of `per` groups (16-byte chunks or elements) a slot, the
// slot's position kept by increments: no division in the loop
struct SlotWalk {
  int per, ds, dg;       // groups a slot; slots and groups a step of THREADS
  int g, s, ii, r, col;  // the group, its slot, and the slot's image, row, column
  // tid: the thread's index among the THREADS that walk the window
  __device__ SlotWalk(const Geo& geo, int per_, int tid = threadIdx.x) : per(per_) {
    ds = THREADS / per;
    dg = THREADS % per;
    g = tid % per;
    s = tid / per;
    col = s % geo.sw;
    r = s / geo.sw % geo.sh;
    ii = s / (geo.sw * geo.sh);
  }
  __device__ __forceinline__ void next(const Geo& geo) {
    g += dg;
    int d = ds;
    if (g >= per) {
      g -= per;
      ++d;
    }
    s += d;
    col += d;
    while (col >= geo.sw) {
      col -= geo.sw;
      if (++r == geo.sh) {
        r = 0;
        ++ii;
      }
    }
  }
  // the pixel of x at this slot of the tile at (img0, h0, w0), or -1
  // where it lies outside x (padding, or past the last image)
  __device__ __forceinline__ long long src(const Geo& geo, int img0, int h0, int w0) const {
    const int img = img0 + ii, hi = h0 - geo.pad_top + r, wi = w0 - 1 + col;
    if (img >= geo.n || hi < 0 || hi >= geo.hin || wi < 0 || wi >= geo.w) return -1;
    return ((long long)img * geo.hin + hi) * geo.w + wi;
  }
};

// the window slot of tile pixel q (its tap (0, 0) position); 0 past the tile
__device__ __forceinline__ int slot_of(const Geo& g, int q) {
  if (q >= g.tpx) return 0;
  const int per = g.th * g.tw;
  const int ii = q / per, r = q % per / g.tw, c = q % g.tw;
  return (ii * g.sh + r) * g.sw + c;
}

// Tile pixel q's place in any tile (image, row, column from the tile's
// origin), computed once a block; img -1 past the tile
struct Place {
  int img, h, w;
  __device__ Place(const Geo& g, int q) {
    const int per = g.th * g.tw;
    img = q < g.tpx ? q / per : -1;
    h = q % per / g.tw;
    w = q % g.tw;
  }
  // the output pixel (index into y's pixels) in the tile at (img0, h0,
  // w0), or -1
  __device__ __forceinline__ long long out(const Geo& g, int img0, int h0, int w0) const {
    const int i = img0 + img, r = h0 + h, c = w0 + w;
    if (img < 0 || i >= g.n || r >= g.h || c >= g.w) return -1;
    return ((long long)i * g.h + r) * g.w + c;
  }
};

// The running part sum y_in at output pixel m, channels n and n + 1 (0
// past Co; n even), in f32: where the mma.sync epilogues store y's pair
__device__ __forceinline__ float2 part_sum2(const __nv_bfloat16* y_in, long long m, int n,
                                            int co) {
  const __nv_bfloat16* r = y_in + m * co;
  if (co % 2 == 0)
    return n < co ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r + n))
                  : make_float2(0.f, 0.f);
  return make_float2(n < co ? __bfloat162float(r[n]) : 0.f,
                     n + 1 < co ? __bfloat162float(r[n + 1]) : 0.f);
}
__device__ __forceinline__ float2 part_sum2(const float* y_in, long long m, int n, int co) {
  const float* r = y_in + m * co;
  if (co % 2 == 0) return n < co ? *reinterpret_cast<const float2*>(r + n) : make_float2(0.f, 0.f);
  return make_float2(n < co ? r[n] : 0.f, n + 1 < co ? r[n + 1] : 0.f);
}

// Channels c0 .. c0 + kc of the window of the tile at (img0, h0, w0)
// into win (g.slots x cp): zero outside x and at channels >= Ci. vec:
// 16-byte cp.async (kc, Ci and x's channel rows multiples of 16 bytes);
// otherwise element by element, synchronously.
template <typename T>
__device__ void load_window(T* win, const T* __restrict__ x, const Geo& g, int img0, int h0,
                            int w0, int c0, int kc, int cp, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int per = vec ? kc / E : kc, total = g.slots * per;
  SlotWalk it(g, per);
  for (int i = threadIdx.x; i < total; i += THREADS, it.next(g)) {
    const int c = vec ? it.g * E : it.g;
    const long long p = c0 + c < g.ci ? it.src(g, img0, h0, w0) : -1;
    if (vec)
      cp16(saddr(win + it.s * cp + c), p >= 0 ? x + p * g.ci + c0 + c : x, p >= 0);
    else
      win[it.s * cp + c] = p >= 0 ? x[p * g.ci + c0 + c] : from_f32<T>(0.f);
  }
}

// The prologue on a landed window chunk, in place: bn_relu at the
// positions in x (halo rows included) and channels < Ci; padding stays 0
template <typename T>
__device__ void apply_prologue(T* win, const Geo& g, const float* __restrict__ scale,
                               const float* __restrict__ shift, int img0, int h0, int w0, int c0,
                               int kc, int cp) {
  constexpr int E = 16 / sizeof(T);
  const bool grouped = kc % E == 0 && g.ci % E == 0;  // 16-byte groups, one position test each
  const int n = grouped ? E : 1, per = kc / n, total = g.slots * per;
  SlotWalk it(g, per);
  for (int i = threadIdx.x; i < total; i += THREADS, it.next(g)) {
    const int c = it.g * n;
    if (c0 + c >= g.ci || it.src(g, img0, h0, w0) < 0) continue;
    T* v = win + it.s * cp + c;
    for (int e = 0; e < n; ++e) v[e] = from_f32<T>(bn_relu(to_f32(v[e]), scale, shift, c0 + c + e));
  }
}

// ----------------------------------------------------------------- bf16

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
// d += a * b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragments of all NT n8 tiles for K rows row0 .. row0 + 15 of the
// (rows x bnp) weight tile at shared address wa: ldmatrix.trans of the
// HWIO rows (n contiguous) gives mma's column-major B
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], uint32_t wa, int row0, int bnp,
                                       int lane) {
  const int row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  if (NT == 1) {
    uint32_t r[2];
    ldsm_x2_t(r, wa + row * bnp * 2);
    b[0][0] = r[0];
    b[0][1] = r[1];
  } else {
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t r[4];
      ldsm_x4_t(r, wa + (row * bnp + 16 * jj + 8 * (lane >> 4)) * 2);
      b[2 * jj][0] = r[0];
      b[2 * jj][1] = r[1];
      b[2 * jj + 1][0] = r[2];
      b[2 * jj + 1][1] = r[3];
    }
  }
}

// two bf16 of a packed row (offsets oa, ob; -1: a slot past 9*Ci, zero)
__device__ __forceinline__ uint32_t pack2(const uint16_t* row, int oa, int ob) {
  const uint32_t lo = oa >= 0 ? row[oa] : 0u, hi = ob >= 0 ? row[ob] : 0u;
  return lo | hi << 16;
}

// Weight rows of a chunk into wsm (rows x bnp), columns n0 .. n0 + bn:
// dense rows tap * kc + c (channel c0 + c of the tap), packed rows the
// slots tap * Ci + c; zero past Ci, past 9*Ci and past Co. A thread keeps
// one column group (bn / 8 groups of 8, or bn columns, divide THREADS)
// and walks the rows by increments.
__device__ void load_w_bf16(__nv_bfloat16* wsm, const __nv_bfloat16* __restrict__ w,
                            const Geo& g, const Layout& L, int c0, int n0, int bn, bool vec) {
  const int per = vec ? bn / 8 : bn, step = THREADS / per;
  const int n = (threadIdx.x % per) * (vec ? 8 : 1);
  const int kc = L.packed ? g.ci : L.kc;  // rows a tap
  int row = threadIdx.x / per, tap = row / kc, c = row % kc;
  for (; row < L.rows; row += step) {
    const int ch = L.packed ? c : c0 + c;
    const bool ok = (L.packed ? row < 9 * g.ci : ch < g.ci) && n0 + n < g.co;
    const long long o = tap * g.wts + (long long)ch * g.co + n0 + n;
    if (vec)
      cp16(saddr(wsm + row * L.bnp + n), ok ? w + o : w, ok);
    else
      wsm[row * L.bnp + n] = ok ? w[o] : __float2bfloat16(0.f);
    for (c += step; c >= kc; c -= kc) ++tap;
  }
}

template <int NT, bool PACKED>
__global__ void __launch_bounds__(THREADS)
conv3x3_window_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ scale,
                    const float* __restrict__ shift, const __nv_bfloat16* y_in,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ stats, const Geo g,
                    const int kc, const int stages, const int relu, const int with_stats,
                    const int vec_x, const int vec_w) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = make_layout(KIND_BF16, g.ci, BN, kc, stages, g.slots);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * BN;
  float* ssum = reinterpret_cast<float*>(smem + L.off_stats);  // (2, BN): this block's stats
  int* koff = reinterpret_cast<int*>(smem + L.off_koff);       // packed: slot offsets of K
  auto win_at = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L.off_win + s * L.stage_bytes);
  };
  auto w_at = [&](int s) {
    const int off = L.off_w + (L.chunks == 1 ? 0 : s * L.stage_bytes);
    return reinterpret_cast<__nv_bfloat16*>(smem + off);
  };

  for (int i = tid; i < 2 * BN; i += THREADS) ssum[i] = 0.f;
  if (PACKED) {
    // K slot k = tap * Ci + c: the element offset of its tap's shift and
    // channel from a pixel's (0, 0) slot
    for (int k = tid; k < L.rows; k += THREADS) {
      const int tap = k / g.ci;
      koff[k] = k < 9 * g.ci ? (tap / 3 * g.sw + tap % 3) * L.cp + k % g.ci : -1;
    }
  }
  if ((int)blockIdx.x >= g.ptiles) return;

  // the loads of unit (tile t, chunk) into stage s, as one group
  auto issue = [&](int t, int chunk, int s) {
    int img0, h0, w0;
    origin(g, t, img0, h0, w0);
    load_window(win_at(s), x, g, img0, h0, w0, chunk * L.kc, L.kc, L.cp, vec_x);
    if (L.chunks > 1) load_w_bf16(w_at(s), w, g, L, chunk * L.kc, n0, BN, vec_w);
    cp_commit();
  };
  if (L.chunks == 1) load_w_bf16(w_at(0), w, g, L, 0, n0, BN, vec_w);
  issue(blockIdx.x, 0, 0);

  const int mtiles = (g.tpx + 15) / 16;
  const int ci16 = (g.ci + 15) / 16 * 16;
  const int gq = lane >> 2, t4 = lane & 3;
  // this lane's A rows in each of its warp's m16 tiles warp and warp + 4
  // (dense, ldmatrix's row lane % 16; packed, rows gq and gq + 8), and the
  // places of its output rows gq and gq + 8: the same in every tile
  int as[2][2];
  const Place out[2][2] = {{Place(g, warp * 16 + gq), Place(g, warp * 16 + gq + 8)},
                           {Place(g, (warp + 4) * 16 + gq), Place(g, (warp + 4) * 16 + gq + 8)}};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q0 = (warp + 4 * i) * 16;
    as[i][0] = slot_of(g, PACKED ? q0 + gq : q0 + (lane & 15));
    as[i][1] = slot_of(g, q0 + gq + 8);
  }
  int u = 0;  // units (tile, chunk) this block has computed
  for (int t = blockIdx.x; t < g.ptiles; t += gridDim.x) {
    int img0, h0, w0;
    origin(g, t, img0, h0, w0);
    float acc[2][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
      const float b0 = n < g.co ? __ldg(bias + n) : 0.f;
      const float b1 = n + 1 < g.co ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][j][0] = acc[i][j][2] = b0;
        acc[i][j][1] = acc[i][j][3] = b1;
      }
    }

    for (int chunk = 0; chunk < L.chunks; ++chunk, ++u) {
      // the next unit: this tile's next chunk, or the next tile's first
      int nt = t, nc = chunk + 1;
      if (nc == L.chunks) {
        nt = t + gridDim.x;
        nc = 0;
      }
      const bool more = nt < g.ptiles;
      const int s = stages == 2 ? (u & 1) : 0;
      if (stages == 2 && more) {
        issue(nt, nc, s ^ 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      if (scale != nullptr) {
        apply_prologue(win_at(s), g, scale, shift, img0, h0, w0, chunk * L.kc, L.kc, L.cp);
        __syncthreads();
      }
      const uint32_t wa = saddr(w_at(s)), aa = saddr(win_at(s));
      if (PACKED) {
        const uint16_t* win = reinterpret_cast<const uint16_t*>(win_at(s));
        for (int k = 0; k < L.rows; k += 16) {
          uint32_t b[NT][2];
          load_b<NT>(b, wa, k, L.bnp, lane);
          const int kk = k + 2 * t4;
          const int o0 = koff[kk], o1 = koff[kk + 1], o2 = koff[kk + 8], o3 = koff[kk + 9];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (warp + 4 * i >= mtiles) continue;
            const uint16_t* r0 = win + as[i][0] * L.cp;
            const uint16_t* r1 = win + as[i][1] * L.cp;
            const uint32_t a[4] = {pack2(r0, o0, o1), pack2(r1, o0, o1), pack2(r0, o2, o3),
                                   pack2(r1, o2, o3)};
#pragma unroll
            for (int j = 0; j < NT; ++j) mma16816(acc[i][j], a, b[j]);
          }
        }
      } else {
        // the chunk's steps (tap, 16 channels), the next step's fragments
        // loaded while this step's products run
        const int kcc = min(L.kc, ci16 - chunk * L.kc);
        const int steps = 9 * (kcc / 16);
        int tap = 0, k = 0, shift_px = 0;
        uint32_t b0[NT][2], b1[NT][2], a0[2][4], a1[2][4];
        auto load = [&](uint32_t (&b)[NT][2], uint32_t (&a)[2][4]) {
          load_b<NT>(b, wa, tap * L.kc + k, L.bnp, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (warp + 4 * i < mtiles)
              ldsm_x4(a[i], aa + ((as[i][0] + shift_px) * L.cp + k + 8 * (lane >> 4)) * 2);
        };
        auto advance = [&]() {
          k += 16;
          if (k == kcc) {
            k = 0;
            ++tap;
            shift_px = tap / 3 * g.sw + tap % 3;
          }
        };
        auto product = [&](const uint32_t (&b)[NT][2], const uint32_t (&a)[2][4]) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (warp + 4 * i < mtiles)
#pragma unroll
              for (int j = 0; j < NT; ++j) mma16816(acc[i][j], a[i], b[j]);
        };
        load(b0, a0);
        for (int st = 0; st < steps; st += 2) {
          advance();
          if (st + 1 < steps) load(b1, a1);
          product(b0, a0);
          if (st + 1 == steps) break;
          advance();
          if (st + 2 < steps) load(b0, a0);
          product(b1, a1);
        }
      }
      __syncthreads();  // the stage is free
      if (stages == 1 && more) issue(nt, nc, 0);
    }

    // epilogue: rows gq and gq + 8 of each m16 tile, channels 8j + 2t4, +1.
    // The part sum first: every load sent before any add and none behind a
    // branch (a row past the tile reads pixel 0 and adds nothing), so the
    // tile waits on memory once, not once a row
    if (y_in != nullptr) {
      float2 f[2][2][NT];
      bool ok[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long m = out[i][half].out(g, img0, h0, w0);
          ok[i][half] = warp + 4 * i < mtiles && m >= 0;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            f[i][half][j] = part_sum2(y_in, ok[i][half] ? m : 0, n0 + 8 * j + 2 * t4, g.co);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[i][j][2 * half] += ok[i][half] ? f[i][half][j].x : 0.f;
            acc[i][j][2 * half + 1] += ok[i][half] ? f[i][half][j].y : 0.f;
          }
    }
    float ps[NT][2], pq[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) ps[j][0] = ps[j][1] = pq[j][0] = pq[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (warp + 4 * i >= mtiles) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = out[i][half].out(g, img0, h0, w0);
        if (m < 0) continue;
        __nv_bfloat16* yr = y + m * g.co;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + 8 * j + 2 * t4;
          float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
          if (relu) {
            v0 = v0 < 0.f ? 0.f : v0;
            v1 = v1 < 0.f ? 0.f : v1;
          }
          if (n + 1 < g.co && g.co % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(yr + n) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < g.co) yr[n] = __float2bfloat16(v0);
            if (n + 1 < g.co) yr[n + 1] = __float2bfloat16(v1);
          }
          if (n < g.co) {
            ps[j][0] += v0;
            pq[j][0] += v0 * v0;
          }
          if (n + 1 < g.co) {
            ps[j][1] += v1;
            pq[j][1] += v1 * v1;
          }
        }
      }
    }
    if (with_stats) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s0 = ps[j][e], q0 = pq[j][e];
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            q0 += __shfl_xor_sync(0xffffffffu, q0, off);
          }
          if (gq == 0 && n0 + 8 * j + 2 * t4 + e < g.co) {
            atomicAdd(ssum + 8 * j + 2 * t4 + e, s0);
            atomicAdd(ssum + BN + 8 * j + 2 * t4 + e, q0);
          }
        }
      }
    }
  }
  if (with_stats) {
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += THREADS)
      if (n0 + i % BN < g.co) atomicAdd(stats + i / BN * g.co + n0 + i % BN, ssum[i]);
  }
}

// ------------------------------------------------------------------ f32

// Rows c0 .. c0 + kc of tap `tap` into wb (kc x bn), columns n0 .. n0 + bn;
// zero past Ci and past Co
__device__ void load_w_f32(float* wb, const float* __restrict__ w, const Geo& g, int kc, int c0,
                           int tap, int n0, int bn, bool vec) {
  const float* wt = w + tap * g.wts;
  if (vec) {
    const int per = bn / 4, total = kc * per;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int row = i / per, n = i % per * 4;
      const bool ok = c0 + row < g.ci && n0 + n < g.co;
      cp16(saddr(wb + row * bn + n), ok ? wt + (long long)(c0 + row) * g.co + n0 + n : w, ok);
    }
  } else {
    const int total = kc * bn;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int row = i / bn, n = i % bn;
      wb[i] = c0 + row < g.ci && n0 + n < g.co ? wt[(long long)(c0 + row) * g.co + n0 + n] : 0.f;
    }
  }
}

// A thread computes PM pixels x PN channels; LN lanes of a warp share a
// pixel group and split the channels, LM = 32 / LN pixel groups a warp:
// pixels (warp * PM + j) * LM + lane / LN, channels (PN >= 4) v / 4 * 4 *
// LN + lane % LN * 4 + v % 4 of the BN = PN * LN (PN == 1: BN = 1)
template <int PM, int PN, int LN>
__global__ void __launch_bounds__(THREADS)
conv3x3_window_f32(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ scale,
                   const float* __restrict__ shift, const float* y_in, float* __restrict__ y,
                   float* __restrict__ stats, const Geo g, const int kc, const int relu,
                   const int with_stats, const int vec_x, const int vec_w) {
  constexpr int LM = 32 / LN, BN = PN * LN;
  static_assert(PN == 1 ? LN == 1 : PN % 4 == 0, "B is read 4 channels at a time");
  static_assert(4 * PM * LM == MAX_TPX, "a block covers a tile of 128 pixels");
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = make_layout(KIND_F32, g.ci, BN, kc, 1, g.slots);
  float* win = reinterpret_cast<float*>(smem + L.off_win);
  float* ssum = reinterpret_cast<float*>(smem + L.off_stats);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pg = lane / LN, cg = lane % LN, n0 = blockIdx.y * BN;
  const int ci4 = (g.ci + 3) & ~3;
  auto wbuf = [&](int s) { return reinterpret_cast<float*>(smem + L.off_w + s * L.w_bytes); };
  auto chan = [&](int v) { return PN == 1 ? n0 : n0 + v / 4 * 4 * LN + cg * 4 + v % 4; };

  for (int i = tid; i < 2 * BN; i += THREADS) ssum[i] = 0.f;

  for (int t = blockIdx.x; t < g.ptiles; t += gridDim.x) {
    int img0, h0, w0;
    origin(g, t, img0, h0, w0);
    int slot[PM];
#pragma unroll
    for (int j = 0; j < PM; ++j) slot[j] = slot_of(g, (warp * PM + j) * LM + pg);
    float acc[PM][PN];
#pragma unroll
    for (int v = 0; v < PN; ++v) {
      const float b0 = chan(v) < g.co ? __ldg(bias + chan(v)) : 0.f;
#pragma unroll
      for (int j = 0; j < PM; ++j) acc[j][v] = b0;
    }

    for (int chunk = 0; chunk < L.chunks; ++chunk) {
      const int c0 = chunk * kc, kcc = min(kc, ci4 - c0);
      __syncthreads();  // the window and the tap stages are free
      load_window(win, x, g, img0, h0, w0, c0, kc, L.cp, vec_x);
      if (!L.resident) {
        load_w_f32(wbuf(0), w, g, kc, c0, 0, n0, BN, vec_w);
      } else if (t == (int)blockIdx.x) {  // the block's first tile: all 9 taps, once
        for (int tap = 0; tap < 9; ++tap) load_w_f32(wbuf(tap), w, g, kc, 0, tap, n0, BN, vec_w);
      }
      cp_commit();
      for (int tap = 0; tap < 9; ++tap) {
        if (L.resident) {
          if (tap == 0) {
            cp_wait<0>();
            __syncthreads();
          }
        } else {
          if (tap < 8) {
            load_w_f32(wbuf((tap + 1) & 1), w, g, kc, c0, tap + 1, n0, BN, vec_w);
            cp_commit();
            cp_wait<1>();
          } else {
            cp_wait<0>();
          }
          __syncthreads();
        }
        if (tap == 0 && scale != nullptr) {
          apply_prologue(win, g, scale, shift, img0, h0, w0, c0, kc, L.cp);
          __syncthreads();
        }
        const float* wb = wbuf(L.resident ? tap : tap & 1);
        const int shift_px = tap / 3 * g.sw + tap % 3;
        const float* ap[PM];
#pragma unroll
        for (int j = 0; j < PM; ++j) ap[j] = win + (slot[j] + shift_px) * L.cp;
        // one fmaf chain an output: channels in order within the tap
        for (int c = 0; c < kcc; c += 4) {
          float4 a[PM];
#pragma unroll
          for (int j = 0; j < PM; ++j) a[j] = *reinterpret_cast<const float4*>(ap[j] + c);
          if constexpr (PN == 1) {
            const float4 bv = *reinterpret_cast<const float4*>(wb + c);
#pragma unroll
            for (int j = 0; j < PM; ++j) {
              acc[j][0] = fmaf(a[j].x, bv.x, acc[j][0]);
              acc[j][0] = fmaf(a[j].y, bv.y, acc[j][0]);
              acc[j][0] = fmaf(a[j].z, bv.z, acc[j][0]);
              acc[j][0] = fmaf(a[j].w, bv.w, acc[j][0]);
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float b[PN];
#pragma unroll
              for (int gi = 0; gi < PN / 4; ++gi) {
                const float4 bv =
                    *reinterpret_cast<const float4*>(wb + (c + kk) * BN + gi * 4 * LN + cg * 4);
                b[4 * gi] = bv.x;
                b[4 * gi + 1] = bv.y;
                b[4 * gi + 2] = bv.z;
                b[4 * gi + 3] = bv.w;
              }
#pragma unroll
              for (int j = 0; j < PM; ++j) {
                const float av = kk == 0 ? a[j].x : kk == 1 ? a[j].y : kk == 2 ? a[j].z : a[j].w;
#pragma unroll
                for (int v = 0; v < PN; ++v) acc[j][v] = fmaf(av, b[v], acc[j][v]);
              }
            }
          }
        }
        if (!L.resident) __syncthreads();  // this tap's stage is free
      }
    }

    // epilogue. The part sum first, 16 bytes a load where y's stores are:
    // every load sent before any add and none behind a branch (a pixel
    // past the tile reads pixel 0 and adds nothing), so the tile waits on
    // memory once, not once a pixel
    if (y_in != nullptr) {
#pragma unroll
      for (int j = 0; j < PM; ++j) {
        const long long m = Place(g, (warp * PM + j) * LM + pg).out(g, img0, h0, w0);
        const bool ok = m >= 0;
        const float* yi = y_in + (ok ? m : 0) * g.co;
        if constexpr (PN >= 4) {
          if (g.co % 4 == 0) {
#pragma unroll
            for (int gi = 0; gi < PN / 4; ++gi) {
              const float4 f = ok && chan(4 * gi) < g.co
                                   ? *reinterpret_cast<const float4*>(yi + chan(4 * gi))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
              acc[j][4 * gi] += f.x;
              acc[j][4 * gi + 1] += f.y;
              acc[j][4 * gi + 2] += f.z;
              acc[j][4 * gi + 3] += f.w;
            }
            continue;
          }
        }
#pragma unroll
        for (int v = 0; v < PN; ++v) acc[j][v] += ok && chan(v) < g.co ? yi[chan(v)] : 0.f;
      }
    }
    float ps[PN], pq[PN];
#pragma unroll
    for (int v = 0; v < PN; ++v) ps[v] = pq[v] = 0.f;
#pragma unroll
    for (int j = 0; j < PM; ++j) {
      const long long m = Place(g, (warp * PM + j) * LM + pg).out(g, img0, h0, w0);
      if (m < 0) continue;
      float* yr = y + m * g.co;
#pragma unroll
      for (int v = 0; v < PN; ++v) {
        float val = acc[j][v];
        if (relu) val = val < 0.f ? 0.f : val;
        acc[j][v] = val;
        if (chan(v) < g.co) {
          ps[v] += val;
          pq[v] += val * val;
        }
      }
      if constexpr (PN >= 4) {
        if (g.co % 4 == 0) {
#pragma unroll
          for (int gi = 0; gi < PN / 4; ++gi)
            if (chan(4 * gi) < g.co)
              *reinterpret_cast<float4*>(yr + chan(4 * gi)) =
                  make_float4(acc[j][4 * gi], acc[j][4 * gi + 1], acc[j][4 * gi + 2],
                              acc[j][4 * gi + 3]);
          continue;
        }
      }
#pragma unroll
      for (int v = 0; v < PN; ++v)
        if (chan(v) < g.co) yr[chan(v)] = acc[j][v];
    }
    if (with_stats) {
#pragma unroll
      for (int v = 0; v < PN; ++v) {
        float s0 = ps[v], q0 = pq[v];
#pragma unroll
        for (int off = LN; off < 32; off *= 2) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          q0 += __shfl_xor_sync(0xffffffffu, q0, off);
        }
        if (pg == 0 && chan(v) < g.co) {
          atomicAdd(ssum + chan(v) - n0, s0);
          atomicAdd(ssum + BN + chan(v) - n0, q0);
        }
      }
    }
  }
  if (with_stats) {
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += THREADS)
      if (n0 + i % BN < g.co) atomicAdd(stats + i / BN * g.co + n0 + i % BN, ssum[i]);
  }
}

// ----------------------------------------------------------------- TF32

using mg_async::fence_async_smem;
using mg_async::fence_regs;
using mg_async::gmma_desc;
using mg_async::mma_commit;
using mg_async::mma_fence;
using mg_async::mma_wait;

// v rounded to TF32 (10 mantissa bits; to nearest, ties away from zero),
// in f32's format
__device__ __forceinline__ float tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}
__device__ __forceinline__ float4 tf32(float4 v) {
  return make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
}

// The weights of all chunks into wsm, columns n0 .. n0 + bn, rounded to
// TF32; K slot k is tap * Ci8 + c (dense) or tap * Ci + c (packed),
// channel c of the tap; zero past Ci, past 9*Ci (packed) and past Co.
// Packed: K-major rows of L.bnp (one an output channel); dense: rows / 4
// planes of bn x 4 f32 (slot k of channel n at (k / 4 * bn + n) * 4 + k %
// 4), wgmma's K-major B without swizzle. A thread keeps one column (bn
// divides THREADS), walks its slots by increments and loads four before
// it stores them; every thread of the block takes part.
__device__ void load_w_tf32(float* wsm, const float* __restrict__ w, const Geo& g,
                            const Layout& L, int n0, int bn) {
  const int step = blockDim.x / bn, n = threadIdx.x % bn;
  const int per = L.packed ? g.ci : (g.ci + 7) / 8 * 8;  // slots a tap
  const bool col = n0 + n < g.co;
  int k = threadIdx.x / bn, tap = k / per, c = k % per;
  while (k < L.rows) {
    float v[4];
    int ks[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ks[u] = k;
      const bool ok = col && k < L.rows && tap < 9 && c < g.ci;
      v[u] = ok ? __ldg(w + tap * g.wts + (long long)c * g.co + n0 + n) : 0.f;
      k += step;
      for (c += step; c >= per; c -= per) ++tap;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (ks[u] >= L.rows) continue;
      const int at = L.packed ? n * L.bnp + ks[u] : ((ks[u] >> 2) * bn + n) * 4 + (ks[u] & 3);
      wsm[at] = tf32(v[u]);
    }
  }
}

// ------------------------------------------- TF32, dense K (Ci >= 8): wgmma

// One TMA load of a 5-D tiled map's box at (c0, .., c4), completing on bar
__device__ __forceinline__ void load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A landed window chunk (the planes) made the product's operand, in place:
// the prologue's bn_relu where a slot lies in x and a channel is below Ci
// (scale given; padding stays 0), then every element rounded to TF32, by
// the THREADS of one warpgroup (tid among them); neighbouring threads
// take neighbouring slots of a plane (no bank conflicts)
__device__ void prep_window(float* win, const Geo& g, const float* __restrict__ scale,
                            const float* __restrict__ shift, int img0, int h0, int w0, int c0,
                            int kc, int tid) {
  float4* p = reinterpret_cast<float4*>(win);
  if (scale == nullptr) {
    for (int i = tid; i < g.slots * kc / 4; i += THREADS) p[i] = tf32(p[i]);
    return;
  }
  for (int pl = 0; pl < kc / 4; ++pl) {
    const int c = c0 + 4 * pl;
    SlotWalk it(g, 1, tid);
    for (int s = tid; s < g.slots; s += THREADS, it.next(g)) {
      float4 v = p[pl * g.slots + s];
      if (it.src(g, img0, h0, w0) >= 0) {
        if (c < g.ci) v.x = bn_relu(v.x, scale, shift, c);
        if (c + 1 < g.ci) v.y = bn_relu(v.y, scale, shift, c + 1);
        if (c + 2 < g.ci) v.z = bn_relu(v.z, scale, shift, c + 2);
        if (c + 3 < g.ci) v.w = bn_relu(v.w, scale, shift, c + 3);
      }
      p[pl * g.slots + s] = tf32(v);
    }
  }
}

// d (this warp's 16 rows of an m64 x BN f32 tile, as mma.sync's n8 tiles:
// d[4j + q]) += A * B: m64nBNk8 in TF32, A and B K-major in shared memory
// without swizzle (descriptors a and b)
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}

// The epilogue shared by the TF32 kernels: output rows gq and gq + 8 of
// this warp's m16 tiles warp and warp + 4 (the m64 products' units 0 and
// 1), channels 8j + 2t4 and + 1 of acc[i][4j + q], as mma.sync lays them
template <int NT>
__device__ __forceinline__ void epilogue_tf32(float (&acc)[2][4 * NT], const Place (&out)[2][2],
                                              const Geo& g, int img0, int h0, int w0, int n0,
                                              int mtiles, int relu, int with_stats,
                                              const float* y_in, float* y, float* ssum) {
  constexpr int BN = 8 * NT;
  const int warp = threadIdx.x % THREADS / 32, lane = threadIdx.x % 32, gq = lane >> 2;
  const int t4 = lane & 3;
  if (y_in != nullptr) {  // the part sum first, as the bf16 kernel's: one wait on memory
    float2 f[2][2][NT];
    bool ok[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = out[i][half].out(g, img0, h0, w0);
        ok[i][half] = warp + 4 * i < mtiles && m >= 0;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          f[i][half][j] = part_sum2(y_in, ok[i][half] ? m : 0, n0 + 8 * j + 2 * t4, g.co);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[i][4 * j + 2 * half] += ok[i][half] ? f[i][half][j].x : 0.f;
          acc[i][4 * j + 2 * half + 1] += ok[i][half] ? f[i][half][j].y : 0.f;
        }
  }
  float ps[NT][2], pq[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) ps[j][0] = ps[j][1] = pq[j][0] = pq[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (warp + 4 * i >= mtiles) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = out[i][half].out(g, img0, h0, w0);
      if (m < 0) continue;
      float* yr = y + m * g.co;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        float v0 = acc[i][4 * j + 2 * half], v1 = acc[i][4 * j + 2 * half + 1];
        if (relu) {
          v0 = v0 < 0.f ? 0.f : v0;
          v1 = v1 < 0.f ? 0.f : v1;
        }
        if (n + 1 < g.co && g.co % 2 == 0) {
          *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
        } else {
          if (n < g.co) yr[n] = v0;
          if (n + 1 < g.co) yr[n + 1] = v1;
        }
        if (n < g.co) {
          ps[j][0] += v0;
          pq[j][0] += v0 * v0;
        }
        if (n + 1 < g.co) {
          ps[j][1] += v1;
          pq[j][1] += v1 * v1;
        }
      }
    }
  }
  if (!with_stats) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s0 = ps[j][e], q0 = pq[j][e];
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      }
      if (gq == 0 && n0 + 8 * j + 2 * t4 + e < g.co) {
        atomicAdd(ssum + 8 * j + 2 * t4 + e, s0);
        atomicAdd(ssum + BN + 8 * j + 2 * t4 + e, q0);
      }
    }
  }
}

// The tile is one or two m64 units of 8 rows x 8 columns of one image
// (tw = 8; th 8 or 16, ti 1 or 2; rows and columns past the image are
// computed on zeros and not stored), so each 8 pixels of a unit are one
// window row: a unit's A is 8 core matrices sw slots apart (the stride
// offset), each plane of 4 channels slots * 16 bytes from the next (the
// leading offset). Two warpgroups share the block's weights and walk
// tiles of their own (warpgroup k of block b: tiles 2b + k, + 2 gridDim.x,
// ...), each through its own `stages` window stages, so that one's
// products run while the other waits for its window, rounds it or stores
// a tile. A warpgroup's units of work (tile, chunk): the window chunk
// lands in its stage (one TMA box, 4 channels x the window's columns x
// rows x images x kc / 4 planes), is made the operand in place, and every
// tap's and 8-channel step's m64nBNk8 products go out at once; while they
// run, its next unit's window is made the operand; when they are done the
// stage is sent for the unit `stages` on, and a finished tile's epilogue
// runs while those copies fly.
template <int NT>
__global__ void __launch_bounds__(2 * THREADS, 1)
conv3x3_window_f32_tc(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, const float* __restrict__ scale,
                      const float* __restrict__ shift, const float* y_in,
                      float* __restrict__ y, float* __restrict__ stats, const Geo g,
                      const int kc, const int stages, const int relu, const int with_stats,
                      const __grid_constant__ CUtensorMap xmap) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // TMA's destinations on 128 bytes (the layout keeps 128 bytes for this)
  uint8_t* smem = smem_raw + ((128 - (saddr(smem_raw) & 127)) & 127);
  const Layout L = make_layout(KIND_TF32, g.ci, BN, kc, stages, g.slots);
  const int wg = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;  // warpgroup, its thread
  const int warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * BN;
  const int ci8 = (g.ci + 7) / 8 * 8;
  float* wsm = reinterpret_cast<float*>(smem + L.off_w);
  float* ssum = reinterpret_cast<float*>(smem + L.off_stats);  // (2, BN): this block's stats
  // this warpgroup's stage barriers (s landed) and stages
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.off_koff) + wg * stages;
  auto win_at = [&](int v) {  // unit v's stage
    return reinterpret_cast<float*>(smem + L.off_win + (wg * stages + v % stages) * L.stage_bytes);
  };
  auto wg_sync = [&]() { mg_async::named_sync(1 + wg, THREADS); };

  for (int i = threadIdx.x; i < 2 * BN; i += blockDim.x) ssum[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * stages; ++s) mg_async::bar_init(saddr(full - wg * stages + s), 1);
    mg_async::bar_init_fence();
  }
  __syncthreads();
  // this warpgroup's units of work: (tile, chunk), tiles vb, vb + 2 gridDim.x, ...
  const int vb = 2 * blockIdx.x + wg, vgrid = 2 * gridDim.x;
  const int units = vb < g.ptiles ? L.chunks * ((g.ptiles - vb + vgrid - 1) / vgrid) : 0;
  auto unit = [&](int v, int& img0, int& h0, int& w0) {
    origin(g, vb + v / L.chunks * vgrid, img0, h0, w0);
    return v % L.chunks;
  };
  auto fetch = [&](int v) {  // unit v's window chunk into its stage
    if (tid != 0) return;
    int img0, h0, w0;
    const int c0 = unit(v, img0, h0, w0) * L.kc;
    const uint32_t bar = saddr(full + v % stages);
    mg_async::bar_expect_tx(bar, g.slots * L.kc * 4);
    load_5d(saddr(win_at(v)), &xmap, bar, 0, w0 - 1, h0 - g.pad_top, img0, c0 / 4);
  };
  // unit v's window landed (its stage's fill v / stages), seen by every
  // thread of the warpgroup, then made the operand for wgmma's proxy
  auto prep = [&](int v) {
    mg_async::bar_wait(saddr(full + v % stages), v / stages & 1);
    wg_sync();
    int img0, h0, w0;
    const int c0 = unit(v, img0, h0, w0) * L.kc;
    prep_window(win_at(v), g, scale, shift, img0, h0, w0, c0, L.kc, tid);
    fence_async_smem();
  };
  for (int v = 0; v < stages && v < units; ++v) fetch(v);
  load_w_tf32(wsm, w, g, L, n0, BN);  // while the first windows' copies fly
  fence_async_smem();
  __syncthreads();  // the weights are everyone's
  if (units > 0) {
    prep(0);
    wg_sync();
  }

  const int mtiles = (g.tpx + 15) / 16, t4 = lane & 3, gq = lane >> 2;
  const int m64 = (g.tpx + 63) / 64;                        // m64 units a tile: 1 or 2
  const int abase[2] = {slot_of(g, 0), slot_of(g, 64)};  // each unit's first slot
  const Place out[2][2] = {{Place(g, warp * 16 + gq), Place(g, warp * 16 + gq + 8)},
                           {Place(g, (warp + 4) * 16 + gq), Place(g, (warp + 4) * 16 + gq + 8)}};
  const uint32_t wa = saddr(wsm);
  float acc[2][4 * NT];
  for (int v = 0; v < units; ++v) {
    int img0, h0, w0;
    const int chunk = unit(v, img0, h0, w0);
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        const float b0 = n < g.co ? __ldg(bias + n) : 0.f;
        const float b1 = n + 1 < g.co ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][4 * j] = acc[i][4 * j + 2] = b0;
          acc[i][4 * j + 1] = acc[i][4 * j + 3] = b1;
        }
      }
    }
    // the unit's products, on its stage
    const uint32_t aa = saddr(win_at(v));
    const int kcc = min(L.kc, ci8 - chunk * L.kc);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    mma_fence();
    for (int tap = 0; tap < 9; ++tap) {
      const int shift_px = tap / 3 * g.sw + tap % 3;
      for (int k = 0; k < kcc; k += 8) {
        const uint64_t db =
            gmma_desc(wa + (tap * ci8 + chunk * L.kc + k) / 4 * BN * 16, BN * 16, 128, 0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (i < m64)
            wgmma_tf32<BN>(acc[i],
                           gmma_desc(aa + ((k / 4) * g.slots + abase[i] + shift_px) * 16,
                                     g.slots * 16, g.sw * 16, 0),
                           db);
      }
    }
    mma_commit();
    if (stages > 1 && v + 1 < units) prep(v + 1);  // while they run
    mma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wg_sync();  // every warp is done with this stage; the next operand is everyone's
    if (v + stages < units) fetch(v + stages);
    if (chunk == L.chunks - 1)  // while the copies just sent for fly
      epilogue_tf32<NT>(acc, out, g, img0, h0, w0, n0, mtiles, relu, with_stats, y_in, y,
                        ssum);
    if (stages == 1 && v + 1 < units) {
      prep(v + 1);
      wg_sync();
    }
  }
  if (with_stats) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * BN; i += blockDim.x)
      if (n0 + i % BN < g.co) atomicAdd(stats + i / BN * g.co + n0 + i % BN, ssum[i]);
  }
}

// ----------------------------------- TF32, packed K (Ci < 8): mma.sync

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
// d += a * b: m16n8k8, tf32 in, f32 accumulate
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragments of all NT n8 tiles for K slots k .. k + 7 of the K-major
// weight rows (BN rows of bnp f32) at shared address wa: ldmatrix on b16
// pairs of 8 rows (output channels) x 16 bytes (4 slots) gives each thread
// the f32 at row lane / 4, slot lane % 4: b0, and from the matrix 4 slots
// on, b1
template <int NT>
__device__ __forceinline__ void load_b_tf32(uint32_t (&b)[NT][2], uint32_t wa, int k, int bnp,
                                            int lane) {
  const int col = k + 4 * ((lane >> 3) & 1);
  if (NT == 1) {
    ldsm_x2(b[0], wa + ((lane & 7) * bnp + col) * 4);
  } else {
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t r[4];
      ldsm_x4(r, wa + ((16 * jj + 8 * (lane >> 4) + (lane & 7)) * bnp + col) * 4);
      b[2 * jj][0] = r[0];
      b[2 * jj][1] = r[1];
      b[2 * jj + 1][0] = r[2];
      b[2 * jj + 1][1] = r[3];
    }
  }
}

// The 1-7 channel stems: the window as slots of Ci f32, rounded in place
// once its copies land; K = 9 * Ci slots in steps of 8 through the slot
// table (the bf16 branch's packed walk), A gathered by 32-bit loads
template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_window_f32_tc_packed(const float* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ bias, const float* __restrict__ scale,
                             const float* __restrict__ shift, const float* y_in,
                             float* __restrict__ y, float* __restrict__ stats, const Geo g,
                             const int kc, const int stages, const int relu,
                             const int with_stats, const int vec_x) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = make_layout(KIND_TF32, g.ci, BN, kc, stages, g.slots);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * BN;
  float* wsm = reinterpret_cast<float*>(smem + L.off_w);
  float* ssum = reinterpret_cast<float*>(smem + L.off_stats);  // (2, BN): this block's stats
  int* koff = reinterpret_cast<int*>(smem + L.off_koff);       // slot offsets of K
  auto win_at = [&](int s) { return reinterpret_cast<float*>(smem + L.off_win + s * L.stage_bytes); };

  for (int i = tid; i < 2 * BN; i += THREADS) ssum[i] = 0.f;
  for (int k = tid; k < L.rows; k += THREADS) {
    const int tap = k / g.ci;
    koff[k] = k < 9 * g.ci ? (tap / 3 * g.sw + tap % 3) * L.cp + k % g.ci : -1;
  }
  if ((int)blockIdx.x >= g.ptiles) return;

  auto fetch = [&](int t, int s) {  // tile t's window into stage s, as one group
    int img0, h0, w0;
    origin(g, t, img0, h0, w0);
    load_window(win_at(s), x, g, img0, h0, w0, 0, L.kc, L.cp, vec_x);
    cp_commit();
  };
  fetch(blockIdx.x, 0);
  load_w_tf32(wsm, w, g, L, n0, BN);  // while the first window's copies fly

  const int mtiles = (g.tpx + 15) / 16;
  const int gq = lane >> 2, t4 = lane & 3;
  // this lane's A rows gq and gq + 8 in its warp's m16 tiles warp and
  // warp + 4, and the places of its output rows
  int as[2][2];
  const Place out[2][2] = {{Place(g, warp * 16 + gq), Place(g, warp * 16 + gq + 8)},
                           {Place(g, (warp + 4) * 16 + gq), Place(g, (warp + 4) * 16 + gq + 8)}};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    as[i][0] = slot_of(g, (warp + 4 * i) * 16 + gq);
    as[i][1] = slot_of(g, (warp + 4 * i) * 16 + gq + 8);
  }
  int u = 0;  // tiles this block has computed
  for (int t = blockIdx.x; t < g.ptiles; t += gridDim.x, ++u) {
    int img0, h0, w0;
    origin(g, t, img0, h0, w0);
    float acc[2][4 * NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
      const float b0 = n < g.co ? __ldg(bias + n) : 0.f;
      const float b1 = n + 1 < g.co ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][4 * j] = acc[i][4 * j + 2] = b0;
        acc[i][4 * j + 1] = acc[i][4 * j + 3] = b1;
      }
    }
    const int nt = t + gridDim.x;
    const int s = stages == 2 ? (u & 1) : 0;
    if (stages == 2 && nt < g.ptiles) {
      fetch(nt, s ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this stage's window (and, first, the weights) landed
    float* win = win_at(s);
    if (scale != nullptr) {
      apply_prologue(win, g, scale, shift, img0, h0, w0, 0, L.kc, L.cp);
      __syncthreads();
    }
    float4* p4 = reinterpret_cast<float4*>(win);
    for (int i = tid; i < L.win_bytes / 16; i += THREADS) p4[i] = tf32(p4[i]);
    __syncthreads();
    const uint32_t wa = saddr(wsm);
    const uint32_t* wn = reinterpret_cast<const uint32_t*>(win);
    for (int k = 0; k < L.rows; k += 8) {
      uint32_t b[NT][2];
      load_b_tf32<NT>(b, wa, k, L.bnp, lane);
      const int o0 = koff[k + t4], o1 = koff[k + t4 + 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (warp + 4 * i >= mtiles) continue;
        const uint32_t* r0 = wn + as[i][0] * L.cp;
        const uint32_t* r1 = wn + as[i][1] * L.cp;
        const uint32_t a[4] = {o0 >= 0 ? r0[o0] : 0u, o0 >= 0 ? r1[o0] : 0u,
                               o1 >= 0 ? r0[o1] : 0u, o1 >= 0 ? r1[o1] : 0u};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float(&d)[4] = *reinterpret_cast<float(*)[4]>(&acc[i][4 * j]);
          mma1688(d, a, b[j]);
        }
      }
    }
    __syncthreads();  // the stage is free
    if (stages == 1 && nt < g.ptiles) fetch(nt, 0);
    epilogue_tf32<NT>(acc, out, g, img0, h0, w0, n0, mtiles, relu, with_stats, y_in, y,
                        ssum);
  }
  if (with_stats) {
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += THREADS)
      if (n0 + i % BN < g.co) atomicAdd(stats + i / BN * g.co + n0 + i % BN, ssum[i]);
  }
}

// ----------------------------------------------------------------- host

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// allow `kernel` the card's largest dynamic shared memory and carveout, once a device
template <typename K>
cudaError_t allow(K kernel, unsigned& allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (allowed >> dev & 1) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  // all of L1 as shared memory, so that the plan's blocks an SM fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) allowed |= 1u << dev;
  return err;
}

struct Args {
  const void *x, *w, *b, *scale, *shift, *y_in;
  void *y, *stats;
  Geo g;
  int kc, stages, relu, with_stats, vec_x, vec_w;
  dim3 grid;
  int smem;
  cudaStream_t s;
  CUtensorMap xmap;  // TF32 dense: x as the TMA map of its windows
};

template <int NT, bool PACKED>
int run_bf16(const Args& a) {
  static unsigned allowed = 0;
  auto kernel = conv3x3_window_bf16<NT, PACKED>;
  cudaError_t err = allow(kernel, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid, THREADS, a.smem, a.s>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const __nv_bfloat16*>(a.w),
      static_cast<const float*>(a.b), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.shift), static_cast<const __nv_bfloat16*>(a.y_in),
      static_cast<__nv_bfloat16*>(a.y),
      static_cast<float*>(a.stats), a.g, a.kc, a.stages, a.relu, a.with_stats, a.vec_x, a.vec_w);
  return (int)cudaGetLastError();
}

template <int NT>
int run_tf32(const Args& a) {
  static unsigned allowed = 0;
  auto kernel = conv3x3_window_f32_tc<NT>;
  cudaError_t err = allow(kernel, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid, 2 * THREADS, a.smem, a.s>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w),
      static_cast<const float*>(a.b), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.shift), static_cast<const float*>(a.y_in),
      static_cast<float*>(a.y), static_cast<float*>(a.stats),
      a.g, a.kc, a.stages, a.relu, a.with_stats, a.xmap);
  return (int)cudaGetLastError();
}

template <int NT>
int run_tf32_packed(const Args& a) {
  static unsigned allowed = 0;
  auto kernel = conv3x3_window_f32_tc_packed<NT>;
  cudaError_t err = allow(kernel, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid, THREADS, a.smem, a.s>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w),
      static_cast<const float*>(a.b), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.shift), static_cast<const float*>(a.y_in),
      static_cast<float*>(a.y), static_cast<float*>(a.stats),
      a.g, a.kc, a.stages, a.relu, a.with_stats, a.vec_x);
  return (int)cudaGetLastError();
}

// TF32 dense: x as a 5-D tiled map (4 channels, W, Hin, N, Ci / 4 planes;
// the planes 16 bytes apart) whose box is one window chunk in the planes'
// layout; zero fill outside x is the padding. Needs Ci % 4 == 0 and x on
// 16 bytes (cuda_conv._route sends no other f32 launch with Ci >= 8 to
// this branch); false where it cannot be had.
bool window_map(CUtensorMap* map, const void* x, const Geo& g, int kc) {
  using mg_async::EncodeTiled;
  static const auto tiled =
      reinterpret_cast<EncodeTiled>(mg_async::driver_fn("cuTensorMapEncodeTiled"));
  if (!tiled || g.ci % 4 != 0 || !aligned16(x)) return false;
  const cuuint64_t c = g.ci;
  const cuuint64_t dim[5] = {4, (cuuint64_t)g.w, (cuuint64_t)g.hin, (cuuint64_t)g.n, c / 4};
  const cuuint64_t stride[4] = {4 * c, 4 * c * g.w, 4 * c * g.w * g.hin, 16};
  const cuuint32_t box[5] = {4, (cuuint32_t)g.sw, (cuuint32_t)g.sh, (cuuint32_t)g.ti,
                             (cuuint32_t)(kc / 4)};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(x), dim, stride, box,
               ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int PM, int PN, int LN>
int run_f32(const Args& a) {
  static unsigned allowed = 0;
  auto kernel = conv3x3_window_f32<PM, PN, LN>;
  cudaError_t err = allow(kernel, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid, THREADS, a.smem, a.s>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w),
      static_cast<const float*>(a.b), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.shift), static_cast<const float*>(a.y_in),
      static_cast<float*>(a.y), static_cast<float*>(a.stats),
      a.g, a.kc, a.relu, a.with_stats, a.vec_x, a.vec_w);
  return (int)cudaGetLastError();
}

// The plan (ti, th, tw, bn, kc, stages, grid_x, smem) comes from
// cuda_conv.py::_window_plan; anything this file would not run as
// planned is refused with cudaErrorInvalidValue. kind: KIND_F32 (f32 on
// FMAs), KIND_BF16, KIND_TF32 (f32 on TF32 tensor cores)
int launch(const void* x, const void* w, const void* b, const void* scale, const void* shift,
           const void* y_in, void* y, void* stats, int n, int h, int wd, int ci, int co,
           long long w_tap_stride, int relu, int with_stats, int kind, int pad_top,
           int pad_bottom, int ti, int th, int tw, int bn, int kc, int stages, int grid_x,
           int smem, cudaStream_t s) {
  const int bad = (int)cudaErrorInvalidValue;
  if (pad_top < 0 || pad_top > 1 || pad_bottom < 0 || pad_bottom > 1) return bad;
  // y_in is read as y is written, up to 16 bytes a thread
  if (!aligned16(y_in)) return bad;
  if (n < 1 || h < 1 || wd < 1 || ci < 1 || co < 1 || (long long)n * h * wd >= (1ll << 31))
    return bad;
  if (kind == KIND_TF32 && ci >= 8) {
    // wgmma's tile: one or two m64 units of 8 x 8 pixels of one image
    if (tw != 8 || (th != 8 && th != 16) || ti < 1 || ti * th > 16 || grid_x < 1) return bad;
  } else if (ti < 1 || th < 1 || tw < 1 || th > h || tw > wd || ti > n ||
             ti * th * tw > MAX_TPX || (ti > 1 && (th != h || tw != wd)) || grid_x < 1) {
    return bad;
  }
  if (kind == KIND_BF16) {
    if ((bn != 8 && bn != 16 && bn != 32 && bn != 64) || (stages != 1 && stages != 2)) return bad;
    if (ci < 16 ? kc != ci : (kc < 16 || kc % 16 != 0)) return bad;
  } else if (kind == KIND_TF32) {
    if ((bn != 8 && bn != 16 && bn != 32 && bn != 64) || stages < 1 || stages > (ci < 8 ? 2 : 3))
      return bad;
    if (ci < 8 ? kc != ci : (kc < 8 || kc % 8 != 0)) return bad;
  } else if (kind == KIND_F32) {
    if ((bn != 1 && bn != 8 && bn != 16 && bn != 32 && bn != 64) || stages != 1 || kc < 4 ||
        kc % 4 != 0)
      return bad;
  } else {
    return bad;
  }
  Args a{};
  Geo& g = a.g;
  g.n = n;
  g.h = h;
  g.w = wd;
  g.ci = ci;
  g.co = co;
  g.hin = h + (1 - pad_top) + (1 - pad_bottom);
  g.pad_top = pad_top;
  g.wts = w_tap_stride;
  g.ti = ti;
  g.th = th;
  g.tw = tw;
  g.tiles_h = (h + th - 1) / th;
  g.tiles_w = (wd + tw - 1) / tw;
  g.ptiles = (n + ti - 1) / ti * g.tiles_h * g.tiles_w;
  g.sh = th + 2;
  g.sw = tw + 2;
  g.slots = ti * g.sh * g.sw;
  g.tpx = ti * th * tw;
  const Layout L = make_layout(kind, ci, bn, kc, stages, g.slots);
  if (L.smem != smem || smem > SMEM_MAX || grid_x > g.ptiles) return bad;
  a.x = x;
  a.w = w;
  a.b = b;
  a.scale = scale;
  a.shift = shift;
  a.y_in = y_in;
  a.y = y;
  a.stats = stats;
  a.kc = kc;
  a.stages = stages;
  a.relu = relu;
  a.with_stats = with_stats;
  const int E = kind == KIND_BF16 ? 8 : 4;  // elements of 16 bytes
  a.vec_x = aligned16(x) && ci % E == 0 ? 1 : 0;  // every channel row on 16 bytes
  a.vec_w = aligned16(w) && co % E == 0 && w_tap_stride % E == 0 && bn % E == 0 ? 1 : 0;
  a.grid = dim3((unsigned)grid_x, (unsigned)((co + bn - 1) / bn));
  a.smem = smem;
  a.s = s;
  if (kind == KIND_TF32 && ci < 8) {
    switch (bn) {
      case 8: return run_tf32_packed<1>(a);
      case 16: return run_tf32_packed<2>(a);
      case 32: return run_tf32_packed<4>(a);
      default: return run_tf32_packed<8>(a);
    }
  }
  if (kind == KIND_TF32) {
    if (!window_map(&a.xmap, x, g, kc)) return bad;
    switch (bn) {
      case 8: return run_tf32<1>(a);
      case 16: return run_tf32<2>(a);
      case 32: return run_tf32<4>(a);
      default: return run_tf32<8>(a);
    }
  }
  if (kind == KIND_BF16) {
    const bool packed = ci < 16;
    switch (bn) {
      case 8: return packed ? run_bf16<1, true>(a) : run_bf16<1, false>(a);
      case 16: return packed ? run_bf16<2, true>(a) : run_bf16<2, false>(a);
      case 32: return packed ? run_bf16<4, true>(a) : run_bf16<4, false>(a);
      default: return packed ? run_bf16<8, true>(a) : run_bf16<8, false>(a);
    }
  }
  switch (bn) {
    case 1: return run_f32<1, 1, 1>(a);
    case 8: return run_f32<2, 4, 2>(a);
    case 16: return run_f32<4, 4, 4>(a);
    case 32: return run_f32<8, 4, 8>(a);
    default: return run_f32<8, 8, 8>(a);
  }
}

}  // namespace

// The window design of mg_conv3x3 (conv3x3.cu): its arguments (is_bf16
// there, here the branch's kind: 0 f32 FMA, 1 bf16, 2 f32 on TF32; y_in
// null or on 16 bytes), then the plan of cuda_conv.py::_window_plan (tile
// images, rows, columns; output channels a block; input channels a chunk;
// window stages; blocks along the tiles; the dynamic shared memory it
// computed)
extern "C" int mg_conv3x3_window(const void* x, const void* w, const void* b, const void* y_in,
                                 void* y, void* stats, int n, int h, int wd, int ci, int co,
                                 long long w_tap_stride, int relu, int with_stats, int kind,
                                 int pad_top, int pad_bottom, int ti, int th, int tw, int bn,
                                 int kc, int stages, int grid_x, int smem, void* stream) {
  return launch(x, w, b, nullptr, nullptr, y_in, y, stats, n, h, wd, ci, co, w_tap_stride, relu,
                with_stats, kind, pad_top, pad_bottom, ti, th, tw, bn, kc, stages, grid_x, smem,
                static_cast<cudaStream_t>(stream));
}

// The window design of mg_conv3x3_bn_relu_in (the same plan arguments)
extern "C" int mg_conv3x3_bn_relu_in_window(const void* x, const void* w, const void* b,
                                            const void* scale, const void* shift, void* y,
                                            void* stats, int n, int h, int wd, int ci, int co,
                                            long long w_tap_stride, int relu, int with_stats,
                                            int kind, int pad_top, int pad_bottom, int ti,
                                            int th, int tw, int bn, int kc, int stages,
                                            int grid_x, int smem, void* stream) {
  return launch(x, w, b, scale, shift, nullptr, y, stats, n, h, wd, ci, co, w_tap_stride, relu,
                with_stats, kind, pad_top, pad_bottom, ti, th, tw, bn, kc, stages, grid_x, smem,
                static_cast<cudaStream_t>(stream));
}
