"""int8 x int8 -> int32 NHWC convolutions: the CUDA kernel's wrappers and
their plain versions.

The JAX package's int8 serving conv, `mgtpu/ops/quant.py::conv_i8`, is
``lax.conv_general_dilated`` on int8 NHWC/HWIO operands with an int32
result, which XLA lowers; it calls no Pallas kernel. PyTorch has no int8
convolution on CUDA, so the port has its own kernel,
`mgtpu_torch/csrc/conv_i8.cu` (``mg_conv_i8``: an implicit GEMM on the
int8 tensor cores), with an optional fused dequant epilogue, which the
int8 layers of `mgtpu_torch.nn` use: ``cast(float(acc) * v[co])`` in
f32 or bf16.
CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise. There is one design, so the kernel counts no route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mgtpu_torch import kernels
from mgtpu_torch.ops.resample import nchw, nhwc

# output dtype -> the kernel's out_kind
_OUT_KINDS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    """Output extent of a k-tap, zero-padded conv along a side of n."""
    return (n + 2 * pad - k) // stride + 1


def conv_i8_plain(x8, w8, stride: int, pad: int, v=None, dtype=torch.int32):
    """``F.conv2d`` in float64 on the int8 values, converted to int32.
    Exact: every product is at most 127^2 and every sum (at most 7*7*512
    taps of them here) far below 2^53, so no order of summation rounds.
    The round before the conversion only guards against a library
    algorithm that is not a plain sum of products. With ``v`` (Co,) f32,
    the dequant ``cast(float(acc) * v, dtype)``: the JAX layers'
    ``(acc.astype(f32) * (sx * scale)).astype(dtype)``."""
    y = F.conv2d(nchw(x8).double(), w8.permute(3, 2, 0, 1).double(), stride=stride,
                 padding=pad)
    acc = nhwc(y.round()).to(torch.int32)
    return acc if v is None else (acc.float() * v).to(dtype)


def _check(x8, w8, stride, pad, v=None):
    """Raise unless the CUDA kernel takes these operands."""
    if x8.device.type != "cuda":
        raise ValueError(f"conv_i8: unsupported device {x8.device}")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"conv_i8: needs int8 x and w, got {x8.dtype}, {w8.dtype}")
    if x8.dim() != 4 or not x8.is_contiguous():
        raise ValueError(f"conv_i8: needs a contiguous NHWC x, got shape {tuple(x8.shape)} "
                         f"strides {x8.stride()}")
    n, h, w, ci = x8.shape
    if w8.dim() != 4 or w8.shape[0] != w8.shape[1] or w8.shape[2] != ci:
        raise ValueError(f"conv_i8: w shape {tuple(w8.shape)} is not (k, k, {ci}, Co)")
    k, co = w8.shape[0], w8.shape[3]
    # rows of (ci, co) contiguous per tap; taps evenly spaced: a dense HWIO
    # weight or its slice along the input channels
    if not (w8.stride(3) == 1 and w8.stride(2) == co and w8.stride(0) == k * w8.stride(1)):
        raise ValueError(f"conv_i8: w strides {w8.stride()} are not an HWIO input-channel slice")
    if stride < 1 or pad < 0 or min(out_size(h, k, stride, pad), out_size(w, k, stride, pad)) < 1:
        raise ValueError(f"conv_i8: stride {stride}, pad {pad} and a {k}x{k} kernel leave no "
                         f"output of a {h}x{w} map")
    if v is not None and (v.dtype != torch.float32 or v.shape != (co,) or not v.is_contiguous()):
        raise ValueError(f"conv_i8: v must be a contiguous f32 ({co},) tensor, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if any(t.device != x8.device for t in (w8, *(() if v is None else (v,)))):
        raise ValueError("conv_i8: all operands must be on one device")


def _launch(x8, w8, stride, pad, v, out_dtype):
    n, h, w, ci = x8.shape
    k, co = w8.shape[0], w8.shape[3]
    y = torch.empty((n, out_size(h, k, stride, pad), out_size(w, k, stride, pad), co),
                    dtype=out_dtype, device=x8.device)
    if y.numel():
        kernels.launch("conv_i8", "mg_conv_i8", x8.device, x8.data_ptr(), w8.data_ptr(),
                       0 if v is None else v.data_ptr(), y.data_ptr(), n, h, w, ci, co, k, stride,
                       pad, w8.stride(1), _OUT_KINDS[out_dtype])
    return y


def conv_i8(x8, w8, stride: int, pad: int, v=None, dtype=torch.int32):
    """x8 (N, H, W, Ci) int8 NHWC, w8 (k, k, Ci, Co) int8 HWIO (or its
    slice along Ci) -> (N, OH, OW, Co) int32 sums of the conv with
    ``stride`` and zero padding ``pad``; with ``v`` (Co,) f32 and
    ``dtype`` f32 or bf16, their dequant ``cast(float(acc) * v, dtype)``
    in the same launch (the kernel's epilogue rounds as the plain
    version does: the two are equal bit for bit). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if (v is None) != (dtype == torch.int32) or dtype not in _OUT_KINDS:
        raise TypeError(f"conv_i8: out dtype {dtype} with v {'absent' if v is None else 'given'}")
    if x8.device.type == "cpu":
        return conv_i8_plain(x8, w8, stride, pad, v, dtype)
    _check(x8, w8, stride, pad, v)
    return _launch(x8, w8, stride, pad, v, dtype)
