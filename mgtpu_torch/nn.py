"""Layer library of the port (counterpart of `mgtpu/nn.py`).

Layers are ``nn.Module``s that serve the eval forward. Layouts follow
the JAX package at every public function: activations are NHWC and conv
weights HWIO, so the tests compare like with like and
`mgtpu_torch.utils.bridge` copies weights without transposing them.

``compute_dtype`` follows the JAX ``dtype=`` rules: conv weights and
activations are cast to it; ``Dense`` accumulates in f32 and adds an
f32 bias; eval BatchNorm computes in f32. Parameters are f32 masters,
drawn on the CPU from an explicit ``torch.Generator`` and then moved to
``device``, so a seed gives the same weights on every device.

Only the eval forward is ported: a BatchNorm in training mode raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mgtpu_torch.ops.resample import nchw, nhwc, upsample_nearest2

TRAIN_NOT_PORTED = ("training is not ported yet (ROADMAP Queue 1 item 4, the "
                    "training step); call .eval() to serve")


def cast_to(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    if dtype is None or x.dtype == dtype:
        return x
    return x.to(dtype)


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def conv2d_nhwc(x, w, stride: int = 1, pad: int = 0):
    """NHWC x, HWIO w -> NHWC conv (stock cuDNN / CPU conv)."""
    return nhwc(F.conv2d(nchw(x), w.permute(3, 2, 0, 1), stride=stride, padding=pad))


class Conv(nn.Module):
    """2D convolution with a bias, NHWC/HWIO, MSR (fan-out) init: std =
    sqrt(2 / (k*k*c_out)), zero bias. The int8 serving branch of the
    JAX layer is not ported."""

    def __init__(self, c_in, c_out, k=3, stride=1, pad=None, compute_dtype=None,
                 device=None, generator=None):
        super().__init__()
        self.c_in, self.c_out, self.k, self.stride = c_in, c_out, k, stride
        self.pad = (0 if k == 1 else 1) if pad is None else pad
        self.compute_dtype = compute_dtype
        w = math.sqrt(2.0 / (k * k * c_out)) * torch.randn((k, k, c_in, c_out),
                                                           generator=_generator(generator))
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(torch.zeros(c_out, device=device))

    def forward(self, x):
        y = conv2d_nhwc(cast_to(x, self.compute_dtype),
                        cast_to(self.w, self.compute_dtype), self.stride, self.pad)
        return y + self.b.to(y.dtype)


class BatchNorm(nn.Module):
    """Spatial batch norm, eval mode: normalizes with the running stats
    in f32 and returns ``x.dtype``. After `mgtpu_torch.ops.fold` folds it
    into the preceding conv, its parameters and stats are gone (the JAX
    package's empty-dict marker) and it is the identity."""

    def __init__(self, c, eps=1e-5, device=None):
        super().__init__()
        self.c, self.eps = c, eps
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    @property
    def folded(self) -> bool:
        return self.scale is None

    def drop_folded(self) -> None:
        """Mark as folded: remove the parameters and stats."""
        self.scale = self.bias = self.mean = self.var = None

    def forward(self, x):
        if self.training:
            raise NotImplementedError(f"BatchNorm: {TRAIN_NOT_PORTED}")
        if self.folded:
            return x
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        y = x.float() * inv + (self.bias - self.mean * inv)
        return y.to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout; the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        return F.dropout(x, self.rate, training=True)


class Dense(nn.Module):
    """Linear layer, (c_in, c_out) weight, torch-default uniform init,
    zero bias. Accumulates in f32 and adds the f32 bias."""

    def __init__(self, c_in, c_out, compute_dtype=None, device=None, generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        s = 1.0 / math.sqrt(c_in)
        w = (torch.rand((c_in, c_out), generator=_generator(generator)) * 2 - 1) * s
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(torch.zeros(c_out, device=device))

    def forward(self, x):
        # products of compute_dtype values are exact in f32: an f32
        # matmul of the cast operands is the f32-accumulating dot
        x = cast_to(x, self.compute_dtype).float()
        w = cast_to(self.w, self.compute_dtype).float()
        return torch.matmul(x, w) + self.b


class Sequential(nn.Module):
    """Composes layers; the JAX tree keys them '0', '1', ..."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ConvBN(nn.Module):
    """Conv -> BN [-> ReLU]. The JAX layer's dropout option is not
    ported: no ported model uses it."""

    def __init__(self, c_in, c_out, k=3, stride=1, relu=True, eps=1e-5,
                 compute_dtype=None, device=None, generator=None):
        super().__init__()
        self.k, self.relu = k, relu
        self.conv = Conv(c_in, c_out, k, stride, compute_dtype=compute_dtype,
                         device=device, generator=generator)
        self.bn = BatchNorm(c_out, eps=eps, device=device)

    def _tail(self, y):
        y = self.bn(y)
        return torch.relu(y) if self.relu else y

    def forward(self, x):
        return self._tail(self.conv(x))

    def apply_parts(self, parts):
        """Fused-exchange path: the conv of the channel concat of
        ``parts`` (a list of ``(kind, tensor)`` from
        `mgtpu_torch.ops.mg.exchange_parts`) without building the concat,
        as the sum of one conv per part over its slice of the weight's
        input channels. Each part goes one of three ways:

          * a 3x3/s1/p1 conv of a "same" or "down" part (or of an "up"
            part materialized for an odd partner): one launch of the
            `conv3x3` kernel; the first launch carries the conv bias;
          * an exact-2x "up" part under a 3x3 conv: `_conv_up3`, the
            upsample folded into a stride-2 transposed conv;
          * a k=1 "up" part: the conv at coarse resolution, then the
            upsample of the result.

        Other convs go to the stock conv on the materialized part."""
        from mgtpu_torch.ops.cuda_conv import conv3x3
        from mgtpu_torch.ops.mg import materialize_part

        conv = self.conv
        dt = conv.compute_dtype
        w = conv.w
        is3x3 = self.k == 3 and conv.stride == 1 and conv.pad == 1
        oh = ow = None
        for kind, xp in parts:
            if kind != "up":
                oh, ow = xp.shape[1], xp.shape[2]
        bias = conv.b
        y = None
        ofs = 0
        for kind, xp in parts:
            c = xp.shape[-1]
            ws = cast_to(w[:, :, ofs:ofs + c, :], dt)
            ofs += c
            xp = cast_to(xp, dt)
            exact2x = kind == "up" and (oh, ow) == (2 * xp.shape[1], 2 * xp.shape[2])
            if exact2x and is3x3:
                yy = _conv_up3(xp, ws, oh, ow)
            elif kind == "up" and self.k == 1 and conv.stride == 1 and conv.pad == 0:
                yy = upsample_nearest2(conv2d_nhwc(xp, ws), oh, ow)
            else:
                xp = materialize_part(kind, xp, oh, ow)
                if is3x3:
                    b = torch.zeros(ws.shape[3], device=xp.device) if bias is None else bias
                    bias = None
                    yy, _ = conv3x3(xp, ws, b, with_stats=False)
                else:
                    yy = conv2d_nhwc(xp, ws, conv.stride, conv.pad)
            y = yy if y is None else y + yy
        if ofs != w.shape[2]:
            raise ValueError(f"parts carry {ofs} channels, the conv takes {w.shape[2]}")
        if bias is not None:  # no conv3x3 launch took it
            y = y + bias.to(y.dtype)
        return self._tail(y)


def _conv_up3(xp, ws, oh: int, ow: int):
    """conv3x3(nearest_up2(xp), ws, pad=1) without the upsampled tensor:
    the JAX version's stride-2 lhs-dilated conv with the 4x4 kernel
    K[u, v] = sum_{a, b in {0, 1}} W[u-a, v-b] is a stride-2, padding-1
    transposed conv with K flipped in space and its in/out channels
    swapped. Exact-2x only: (oh, ow) == (2h, 2w)."""
    if (oh, ow) != (2 * xp.shape[1], 2 * xp.shape[2]):
        raise ValueError(f"_conv_up3 needs an exact 2x output, got {(oh, ow)} "
                         f"for input {tuple(xp.shape[1:3])}")
    ci, co = ws.shape[2], ws.shape[3]
    k4 = torch.zeros((4, 4, ci, co), dtype=ws.dtype, device=ws.device)
    for a in (0, 1):
        for b in (0, 1):
            k4[a:a + 3, b:b + 3] += ws
    wt = k4.flip(0, 1).permute(2, 3, 0, 1)  # (Ci, Co, 4, 4)
    return nhwc(F.conv_transpose2d(nchw(xp), wt, stride=2, padding=1))


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
