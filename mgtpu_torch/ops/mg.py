"""Multigrid ops on feature pyramids (counterpart of `mgtpu/ops/mg.py`).

A pyramid is a tuple of NHWC tensors, finest scale first; scale i+1 has
half the spatial extent of scale i. Only the fused-exchange formulation
is ported: each exchange conv takes its scale's parts through
`ConvBN.apply_parts` and the resample-concat is never built. Every block
runs in eval mode (serving) and in train mode (the training step).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mgtpu_torch.nn import ConvBN
from mgtpu_torch.ops.cuda_conv import bn_relu_plain
from mgtpu_torch.ops.resample import maxpool, maxpool2_ceil, avgpool, upsample_nearest2

Pyramid = tuple


def pyramid_widths_after_exchange(widths: Sequence[int]) -> list[int]:
    """Channel counts after the exchange: c[i-1] + c[i] + c[i+1]."""
    n = len(widths)
    out = []
    for i in range(n):
        c = widths[i]
        if i > 0:
            c += widths[i - 1]
        if i + 1 < n:
            c += widths[i + 1]
        out.append(c)
    return out


def exchange_parts(pyr: Pyramid, i: int, same=None):
    """The i-th scale's exchange inputs as a list of ``(kind, tensor)``,
    in the concat order {maxpool2(finer), self, coarser}. The coarser
    neighbour is passed raw (kind "up") so the conv can fold its
    nearest upsample. ``same`` replaces ``pyr[i]`` as the "same" part
    (an un-normalized ``(y_raw, scale, shift)``, see
    `ConvBN.conv_parts`)."""
    n = len(pyr)
    parts = []
    if i > 0:
        parts.append(("down", maxpool2_ceil(pyr[i - 1])))
    parts.append(("same", pyr[i] if same is None else same))
    if i + 1 < n:
        parts.append(("up", pyr[i + 1]))
    return parts


def materialize_part(kind: str, xp, oh: int, ow: int):
    """Resolve an exchange part to its fine-resolution tensor."""
    if kind == "up":
        return upsample_nearest2(xp, oh, ow)
    return xp


class MgStem7x7(nn.Module):
    """ImageNet input stem: per scale, avgpool(2^i) -> Conv7x7/2 pad 3 ->
    BN -> ReLU -> MaxPool3x3/2 pad 1. 224 -> 56/28/14."""

    def __init__(self, widths, c_in=3, compute_dtype=None, device=None, generator=None):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvBN(c_in, w, k=7, stride=2, relu=True, compute_dtype=compute_dtype,
                   device=device, generator=generator)
            for w in widths)
        for c in self.convs:
            c.conv.pad = 3
        self.out_widths = list(widths)

    def forward(self, x):
        out = []
        xi = x
        for i, conv in enumerate(self.convs):
            if i > 0:  # progressive dyadic pyramid (== avgpool(2^i) of x)
                xi = avgpool(xi, 2)
            out.append(maxpool(conv(xi), 3, 2, 1))
        return tuple(out)


class MgResidual(nn.Module):
    """Residual multigrid layer, per scale:

        y = relu( shortcut(x) + ConvBN(xc( ConvBNReLU(xc(x)) )) )

    with xc the exchange. Shortcut types: A zero-pads channels when
    widening and is the identity otherwise; B uses a 1x1 ConvBN when the
    widths differ; C always does. Narrowing under A also takes a 1x1
    ConvBN. The JAX layer's dropout, its final_relu=False variant and its
    materialized (non-fused) exchange are not ported."""

    def __init__(self, in_widths, out_widths, kernels=None, shortcut_type="A",
                 compute_dtype=None, device=None, generator=None):
        super().__init__()
        n = len(in_widths)
        if len(out_widths) != n:
            raise ValueError(f"{len(in_widths)} input scales, {len(out_widths)} output")
        ks = list(kernels) if kernels is not None else [3] * n
        self.in_widths, self.out_widths = list(in_widths), list(out_widths)
        kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
        mixed1 = pyramid_widths_after_exchange(in_widths)
        mixed2 = pyramid_widths_after_exchange(out_widths)
        self.stage1 = nn.ModuleList(
            ConvBN(mixed1[i], out_widths[i], ks[i], relu=True, **kw) for i in range(n))
        self.stage2 = nn.ModuleList(
            ConvBN(mixed2[i], out_widths[i], ks[i], relu=False, **kw) for i in range(n))
        # scale index -> 1x1 ConvBN; scales not in here are identity / zero-pad
        self.shortcuts = nn.ModuleDict({
            str(i): ConvBN(cin, cout, k=1, relu=False, **kw)
            for i, (cin, cout) in enumerate(zip(in_widths, out_widths))
            if shortcut_type == "C" or (cin != cout and (shortcut_type == "B" or cin > cout))
        })

    @staticmethod
    def _stage(layers, pyr):
        return tuple(layer.apply_parts(exchange_parts(pyr, i))
                     for i, layer in enumerate(layers))

    def _train_stages(self, pyr):
        """Both stages in train mode. Stage 1 stops at each scale's raw
        part sum y1 and its BN's batch (scale, shift); stage 2 takes its
        same-scale part un-normalized, so the `conv3x3_bn_relu_in`
        kernel applies relu(bn(y1)) as it reads. relu(bn(y1)) is built
        only for the neighbours' down and up parts: nowhere in a
        single-scale block."""
        n = len(pyr)
        raw = [layer.conv_parts(exchange_parts(pyr, i)) for i, layer in enumerate(self.stage1)]
        affine = [layer.bn.batch_affine(y) for layer, y in zip(self.stage1, raw)]
        act = tuple(bn_relu_plain(y, *a) if n > 1 else None for y, a in zip(raw, affine))
        return tuple(layer._tail(layer.conv_parts(exchange_parts(act, i, (raw[i], *affine[i]))))
                     for i, layer in enumerate(self.stage2))

    def forward(self, pyr):
        if self.training:
            h = self._train_stages(pyr)
        else:
            h = self._stage(self.stage2, self._stage(self.stage1, pyr))
        out = []
        for i, (x, y) in enumerate(zip(pyr, h)):
            cin, cout = self.in_widths[i], self.out_widths[i]
            if str(i) in self.shortcuts:
                short = self.shortcuts[str(i)](x)
            elif cin == cout:
                short = x
            else:  # zero-pad widen
                short = F.pad(x, (0, cout - cin))
            out.append(torch.relu(y + short.to(y.dtype)))
        return tuple(out)


class MgPool(nn.Module):
    """Block transition: mode "plain" max-pools (2x2/2, ceil) every
    scale; mode "concat" pools scales 0..n-2 and concatenates the
    untouched coarsest scale onto scale n-2, leaving n-1 scales."""

    def __init__(self, widths, mode="plain"):
        super().__init__()
        w = list(widths)
        if mode == "concat":
            if len(w) < 2:
                raise ValueError("concat pooling needs at least two scales")
            self.out_widths = w[:-2] + [w[-2] + w[-1]]
        elif mode == "plain":
            self.out_widths = w
        else:
            raise ValueError(f"MgPool mode {mode!r} is not ported (plain, concat)")
        self.mode = mode

    def forward(self, pyr):
        if self.mode == "concat":
            out = [maxpool2_ceil(x) for x in pyr[:-1]]
            out[-1] = torch.cat([out[-1], pyr[-1]], dim=-1)
            return tuple(out)
        return tuple(maxpool2_ceil(x) for x in pyr)
