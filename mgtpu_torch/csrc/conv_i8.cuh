// What the int8 conv's designs share (conv_i8.cu, conv_i8_stem.cu,
// conv_i8_1x1.cu): the epilogue's operands and its rounding, the
// argument checks, mma.sync's int8 product and ldmatrix, and the row
// copies between a staged tile in shared memory and device memory. Header only: every device function is inlined into the kernel
// that calls it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mg_i8 {

enum Out { OUT_S32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

// The epilogue's operands: sx (one f32 in device memory: the activation
// scale) and scale (Co,) f32 give the dequant vector sx * scale[co];
// y_in (the running part sum, in the output type; may be y itself) and
// bias (Co,) f32 may be null; relu is 0 or 1
struct Epi {
  const float* sx;
  const float* scale;
  const void* y_in;
  const float* bias;
  int relu;
};

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One output element from its int32 sum, its dequant factor v = sx *
// scale[co], the running part sum prev and the bias b (f32, unrounded),
// rounded as torch computes the int8 layers' sequence
// (mgtpu_torch/nn.py::_int8_part, _int8_parts):
//   yy = (acc.float() * (sx * scale)).to(dtype)   one rounded product each,
//                                                  then one rounding to dtype
//   y  = y_in + yy                                 an add in f32, rounded to dtype
//   y  = y + bias.to(dtype)                        the bias rounded first
//   y  = relu(y)                                   exact; NaN stays NaN
__device__ __forceinline__ float finish(int acc, float v, float prev, float b, bool bf,
                                        bool has_in, bool has_bias, int relu) {
  float t = __fmul_rn(__int2float_rn(acc), v);
  if (bf) t = bf16_round(t);
  if (has_in) {
    t = __fadd_rn(prev, t);
    if (bf) t = bf16_round(t);
  }
  if (has_bias) {
    t = __fadd_rn(t, bf ? bf16_round(b) : b);
    if (bf) t = bf16_round(t);
  }
  return relu && t < 0.f ? 0.f : t;
}

// What every design refuses: a bad shape, an epilogue operand missing
// for a dequantized output or given for an int32 one, y or y_in not
// aligned for 8-byte stores
inline bool bad_args(const Epi& e, const void* y, int n, int h, int wd, int ci, int co, int k,
                     int s, int p, int pad_top, int pad_bottom, int out_kind) {
  const bool deq = out_kind == OUT_F32 || out_kind == OUT_BF16;
  return n <= 0 || h <= 0 || wd <= 0 || ci <= 0 || co <= 0 || k <= 0 || s <= 0 || p < 0 ||
         pad_top < 0 || pad_top > p || pad_bottom < 0 || pad_bottom > p ||
         h + pad_top + pad_bottom < k || wd + 2 * p < k || (!deq && out_kind != OUT_S32) ||
         (deq && (e.sx == nullptr || e.scale == nullptr)) ||
         (!deq && (e.y_in != nullptr || e.bias != nullptr || e.relu)) ||
         (e.relu != 0 && e.relu != 1) || !aligned(y, 8) || !aligned(e.y_in, 8);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows of a staged tile and rows of a device-memory matrix, in 16-byte
// chunks (vec16: both sides on 16-byte boundaries) or 8-byte ones: rows
// r < rows of `bytes` bytes, pitch sp in shared memory and gp in device
// memory; the threads 0..threads-1 of the block share the chunks.
// to_global: stg -> g, else g -> stg. bytes, sp and gp are multiples of 16.
__device__ __forceinline__ void copy_rows(uint8_t* stg, int sp, uint8_t* g, long long gp,
                                          int rows, int bytes, bool vec16, bool to_global,
                                          int tid, int threads) {
  if (vec16) {
    const int cpr = bytes / 16;
    for (int i = tid; i < rows * cpr; i += threads) {
      const int r = i / cpr, q = i - r * cpr;
      uint4* s = reinterpret_cast<uint4*>(stg + r * sp + 16 * q);
      uint4* d = reinterpret_cast<uint4*>(g + r * gp + 16 * q);
      if (to_global)
        *d = *s;
      else
        *s = *d;
    }
  } else {
    const int cpr = bytes / 8;
    for (int i = tid; i < rows * cpr; i += threads) {
      const int r = i / cpr, q = i - r * cpr;
      uint2* s = reinterpret_cast<uint2*>(stg + r * sp + 8 * q);
      uint2* d = reinterpret_cast<uint2*>(g + r * gp + 8 * q);
      if (to_global)
        *d = *s;
      else
        *s = *d;
    }
  }
}

// Two adjacent channels (c, c + 1) of one row of a staged tile, at p:
// the int32 sums as they are, or finished over the part sum the tile
// holds there (v, b: the two channels' dequant factors and biases)
__device__ __forceinline__ void finish_pair(uint8_t* p, int a0, int a1, int out, float v0,
                                            float v1, float b0, float b1, const Epi& e) {
  const bool has_in = e.y_in != nullptr, has_bias = e.bias != nullptr;
  if (out == OUT_S32) {
    *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
  } else if (out == OUT_BF16) {  // the finished values are bf16 values: the conversion is exact
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

}  // namespace mg_i8
