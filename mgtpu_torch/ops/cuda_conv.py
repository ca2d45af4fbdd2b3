"""3x3/s1/p1 NHWC convs with a bias, optional ReLU and an optional
per-channel (sum, sum of squares) epilogue: the CUDA kernels' wrappers,
their plain versions, and the autograd Functions around them.

Ports of `mgtpu/ops/pallas_conv.py::conv3x3` (its ``rows`` and ``slab``
variants compute the same function) and ``conv3x3_bn_relu_in`` (the
BatchNorm-apply + ReLU prologue); the signatures drop ``variant``,
``th`` and ``interpret``. Both kernels are in
`mgtpu_torch/csrc/conv3x3.cu`, each in two designs: ``sm90`` (TMA and
wgmma, for bf16 with Ci and Co multiples of 64: the large shapes) and
``tile`` (WMMA or FMA tiles: everything else). :func:`_route` picks one
from dtype, shape and alignment alone; it is not a fallback, and a
launch that fails raises.

The backward of both is cuDNN's dgrad and wgrad (``convolution_backward``
on the ``channels_last`` views) plus elementwise reductions: the JAX
package has no Pallas backward for these convs (XLA differentiates
them), so there is no TPU kernel to port there. The stats output is not
differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mgtpu_torch import kernels
from mgtpu_torch.ops.resample import nchw, nhwc

_DTYPES = (torch.float32, torch.bfloat16)
_AXES = (0, 1, 2)  # every axis of an NHWC tensor but its channels


def _stats(y, co, with_stats):
    if not with_stats:
        return torch.zeros((2, co), dtype=torch.float32, device=y.device)
    yf = y.float()
    return torch.stack([yf.sum(dim=_AXES), (yf * yf).sum(dim=_AXES)])


def conv3x3_plain(x, w, b, *, relu_out=False, with_stats=True):
    """Stock-torch version, the same formula as ``xla_conv3x3``:
    y = conv(x, w) + b in ``x.dtype`` [ReLU]; stats (2, Co) f32 of y."""
    y = nhwc(F.conv2d(nchw(x), w.permute(3, 2, 0, 1), b.to(x.dtype), padding=1))
    y = y.contiguous()
    if relu_out:
        y = torch.relu(y)
    return y, _stats(y, w.shape[3], with_stats)


def bn_relu_plain(x, scale, shift):
    """relu(x * scale + shift) computed in f32 and rounded to x.dtype:
    the normalized input of ``conv3x3_bn_relu_in``."""
    return torch.relu(x.float() * scale + shift).to(x.dtype)


def conv3x3_bn_relu_in_plain(x, w, b, scale, shift, *, relu_out=False, with_stats=True):
    """Stock-torch version, the same formula as ``xla_conv3x3_bn_relu_in``:
    conv3x3_plain of the normalized input. Its zero padding is added
    after the normalization, so pad positions stay 0."""
    return conv3x3_plain(bn_relu_plain(x, scale, shift), w, b, relu_out=relu_out,
                         with_stats=with_stats)


def _check(name, x, w, b, vectors=()):
    """Raise unless the CUDA kernel takes these operands."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not in {_DTYPES}")
    if w.dtype != x.dtype or b.dtype != torch.float32:
        raise TypeError(f"{name}: needs w in x.dtype ({x.dtype}) and an f32 bias, "
                        f"got w {w.dtype}, b {b.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous NHWC x, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    ci = x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"{name}: w shape {tuple(w.shape)} is not (3, 3, {ci}, Co)")
    co = w.shape[3]
    # rows of (ci, co) contiguous per tap; taps evenly spaced: a dense HWIO
    # weight or its slice along the input channels
    if not (w.stride(3) == 1 and w.stride(2) == co and w.stride(0) == 3 * w.stride(1)):
        raise ValueError(f"{name}: w strides {w.stride()} are not an HWIO "
                         f"input-channel slice")
    if b.shape != (co,) or not b.is_contiguous():
        raise ValueError(f"{name}: b shape {tuple(b.shape)} is not ({co},)")
    for vname, v in vectors:
        if v.dtype != torch.float32 or v.shape != (ci,) or not v.is_contiguous():
            raise ValueError(f"{name}: {vname} must be a contiguous f32 ({ci},) tensor, got "
                             f"{tuple(v.shape)} {v.dtype}")
    if any(t.device != x.device for t in (w, b, *(v for _, v in vectors))):
        raise ValueError(f"{name}: all operands must be on one device")


def _route(x, w):
    """The design a CUDA launch of these operands takes: "sm90" (TMA and
    wgmma) for bf16 with Ci and Co multiples of 64 (one 128-byte
    swizzled row of the tiles), at most 2048 (the block keeps per-channel
    sums and the prologue's scale and shift in shared memory), and x and
    w on 16-byte boundaries (TMA's rule); "tile" for everything else. A
    fixed function of dtype, shape and alignment: a launch on either
    route that fails raises."""
    ci, co = x.shape[3], w.shape[3]
    if (x.dtype == torch.bfloat16 and ci % 64 == 0 and co % 64 == 0 and max(ci, co) <= 2048
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "sm90"
    return "tile"


def _launch(kernel, route, x, w, b, vectors, relu_out, with_stats):
    n, h, wd, ci = x.shape
    co = w.shape[3]
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    stats = torch.zeros((2, co), dtype=torch.float32, device=x.device)
    if y.numel():
        entry = "mg_" + kernel + ("_sm90" if route == "sm90" else "")
        kernels.launch(kernel, entry, x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                       *(v.data_ptr() for v in vectors), y.data_ptr(), stats.data_ptr(), n, h,
                       wd, ci, co, w.stride(1), int(relu_out), int(with_stats),
                       int(x.dtype == torch.bfloat16), route=route)
    return y, stats


def conv3x3_forward(x, w, b, *, relu_out=False, with_stats=True):
    """The forward alone: CPU tensors take the plain version; CUDA
    tensors launch the kernel (the design :func:`_route` picks) or
    raise."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu_out=relu_out, with_stats=with_stats)
    _check("conv3x3", x, w, b)
    return _launch("conv3x3", _route(x, w), x, w, b, (), relu_out, with_stats)


def conv3x3_bn_relu_in_forward(x, w, b, scale, shift, *, relu_out=False, with_stats=True):
    """The forward alone: CPU tensors take the plain version; CUDA
    tensors launch the kernel (the design :func:`_route` picks) or
    raise."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_in_plain(x, w, b, scale, shift, relu_out=relu_out,
                                        with_stats=with_stats)
    _check("conv3x3_bn_relu_in", x, w, b, (("scale", scale), ("shift", shift)))
    return _launch("conv3x3_bn_relu_in", _route(x, w), x, w, b, (scale, shift), relu_out,
                   with_stats)


def _tile_forward(x, w, b, scale=None, shift=None, *, relu_out=False, with_stats=True):
    """The forward of conv3x3 (or of conv3x3_bn_relu_in, given scale and
    shift) through the tile design at any shape, on CUDA tensors.
    Private: only for holding the two designs against each other and
    timing them at one shape (chip_smoke.py, tests/test_torch_cuda.py)."""
    if scale is None:
        _check("conv3x3", x, w, b)
        return _launch("conv3x3", "tile", x, w, b, (), relu_out, with_stats)
    _check("conv3x3_bn_relu_in", x, w, b, (("scale", scale), ("shift", shift)))
    return _launch("conv3x3_bn_relu_in", "tile", x, w, b, (scale, shift), relu_out, with_stats)


def _conv_grads(gy, x, w, need_x, need_w):
    """(dx, dw) of y = conv3x3(x, w) for the NHWC cotangent gy: cuDNN
    dgrad and wgrad on the channels_last views (the CPU's conv backward
    on a CPU tensor). Each is None where not needed."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        nchw(gy.contiguous()), nchw(x), w.permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1],
        False, [0, 0], 1, [need_x, need_w, False])
    return (nhwc(dx) if need_x else None), (dw.permute(2, 3, 1, 0) if need_w else None)


def _relu_out_grad(gy, y, relu_out):
    return gy * (y > 0) if relu_out else gy


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, relu_out, with_stats):
        y, stats = conv3x3_forward(x, w, b, relu_out=relu_out, with_stats=with_stats)
        ctx.relu_out = relu_out
        ctx.save_for_backward(x, w, y if relu_out else None)
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, gy, _gstats):
        x, w, y = ctx.saved_tensors
        gy = _relu_out_grad(gy, y, ctx.relu_out)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw = _conv_grads(gy, x, w, need_x, need_w)
        db = gy.float().sum(dim=_AXES) if need_b else None
        return dx, dw, db, None, None


class _Conv3x3BnReluIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, scale, shift, relu_out, with_stats):
        y, stats = conv3x3_bn_relu_in_forward(x, w, b, scale, shift, relu_out=relu_out,
                                              with_stats=with_stats)
        ctx.relu_out = relu_out
        # the normalized input is recomputed in the backward, not kept
        ctx.save_for_backward(x, w, scale, shift, y if relu_out else None)
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, gy, _gstats):
        x, w, scale, shift, y = ctx.saved_tensors
        gy = _relu_out_grad(gy, y, ctx.relu_out)
        need_x, need_w, need_b, need_scale, need_shift = ctx.needs_input_grad[:5]
        z = x.float() * scale + shift
        xn = torch.relu(z).to(x.dtype)
        need_z = need_x or need_scale or need_shift
        dxn, dw = _conv_grads(gy, xn, w, need_z, need_w)
        dx = dscale = dshift = None
        if need_z:
            dz = dxn.float() * (z > 0)
            dx = (dz * scale).to(x.dtype) if need_x else None
            dscale = (dz * x.float()).sum(dim=_AXES) if need_scale else None
            dshift = dz.sum(dim=_AXES) if need_shift else None
        db = gy.float().sum(dim=_AXES) if need_b else None
        return dx, dw, db, dscale, dshift, None, None


def conv3x3(x, w, b, *, relu_out=False, with_stats=True):
    """x (N, H, W, Ci) NHWC; w (3, 3, Ci, Co) HWIO; b (Co,) f32.
    Returns (y (N, H, W, Co) in x.dtype, stats (2, Co) f32, zeros when
    ``with_stats`` is False). The f32 accumulator starts at the bias;
    stats sum the f32 values after the ReLU and before the cast.

    ``w`` may be a slice of a wider HWIO weight along its input
    channels (a view), as the multigrid exchange passes it.
    Differentiable in x, w and b (not through stats). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    return _Conv3x3.apply(x, w, b, relu_out, with_stats)


def conv3x3_bn_relu_in(x, w, b, scale, shift, *, relu_out=False, with_stats=True):
    """conv3x3(relu(x * scale + shift), w, b) with the conv's zero
    padding kept: pad positions are not activations, so they stay 0
    even where relu(shift) > 0. ``scale`` and ``shift`` are contiguous
    f32 (Ci,) tensors (a BatchNorm's batch scale and shift). The
    normalized input is rounded to x.dtype before the conv and never
    stored. Differentiable in x, w, b, scale and shift (not through
    stats). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    return _Conv3x3BnReluIn.apply(x, w, b, scale, shift, relu_out, with_stats)
