"""Shared model heads, single-grid blocks, the pyramid network wrapper and
the multigrid assembly loops (counterpart of `mgtpu/models/common.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mgtpu_torch import trace
from mgtpu_torch.nn import ConvBN, Dense, Sequential
from mgtpu_torch.ops.mg import Layer, MgConv, MgConvInput, MgPool, MgResidual, PerScale, TailOp
from mgtpu_torch.ops.resample import avgpool, maxpool2_ceil
from mgtpu_torch.parallel import axis


class LogSoftmaxClassifier(nn.Module):
    """Pyramid scale ``scale`` (0, the finest, by default; -1 the
    coarsest) -> [AvgPool a x a] -> flatten (NHWC order) -> Dense ->
    log-softmax, computed in f32."""

    def __init__(self, c_in, n_classes, pool=0, scale=0, compute_dtype=None, device=None,
                 generator=None):
        super().__init__()
        self.pool, self.scale = pool, scale
        self.dense = Dense(c_in, n_classes, compute_dtype=compute_dtype,
                           device=device, generator=generator)

    def forward(self, pyr):
        x = axis.gather_h(pyr[self.scale])  # -spatial: whole rows (a no-op on the 7x7 grids)
        if self.pool:
            x = avgpool(x, self.pool, 1)
        y = self.dense(x.reshape(x.shape[0], -1))
        return torch.log_softmax(y.float(), dim=-1)


class SigmoidHead(nn.Module):
    """Pyramid scale ``scale`` -> sigmoid, computed in f32: the
    segmentation nets' per-pixel probabilities (under -spatial an
    H-slab's, which the step gathers before the loss)."""

    def __init__(self, scale=0):
        super().__init__()
        self.scale = scale

    def forward(self, pyr):
        return torch.sigmoid(pyr[self.scale].float())


class FlatClassifier(nn.Module):
    """One array (spatial 1x1) -> flatten (NHWC order) -> Dense ->
    log-softmax, computed in f32."""

    def __init__(self, c_in, n_classes, compute_dtype=None, device=None, generator=None):
        super().__init__()
        self.dense = Dense(c_in, n_classes, compute_dtype=compute_dtype,
                           device=device, generator=generator)

    def forward(self, x):
        x = axis.gather_h(x)
        return torch.log_softmax(self.dense(x.reshape(x.shape[0], -1)).float(), dim=-1)


class Pool2(nn.Module):
    """One array's 2x2/2 max pool in ceil mode (the hand-written kernel,
    through ``maxpool2_ceil``), as every net that has one sets it. (The
    JAX class's floor mode is given by no net.)"""

    def forward(self, x):
        return maxpool2_ceil(x)


class ResBlock(Layer):
    """Single-grid residual block: [drop] ConvBN-ReLU [drop] ConvBN, plus
    a shortcut, then ReLU. The shortcut zero-pads channels when
    widening, is the identity at equal widths, and a 1x1 ConvBN when
    narrowing or with ``shortcut_type`` "C" (always). Its forward is a
    span, ``ResBlock``, with its ``at`` (`mgtpu_torch.ops.mg.Layer`). In
    eval mode a second conv that `ConvBN.ends_in_kernel` adds the
    shortcut and applies the ReLU in its `conv3x3` launch."""

    jax_keys = {"c1": "conv1", "c2": "conv2", "sc": "shortcut"}

    def __init__(self, c_in, c_out, dropout=0.0, eps=1e-5, shortcut_type="",
                 compute_dtype=None, device=None, generator=None):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        kw = dict(eps=eps, compute_dtype=compute_dtype, device=device, generator=generator)
        self.conv1 = ConvBN(c_in, c_out, 3, relu=True, dropout=dropout, dropout_pos="before", **kw)
        self.conv2 = ConvBN(c_out, c_out, 3, relu=False, dropout=dropout, dropout_pos="before",
                            **kw)
        self.shortcut = (ConvBN(c_in, c_out, 1, relu=False, **kw)
                         if c_in > c_out or shortcut_type == "C" else None)

    def forward(self, x):
        with trace.span("ResBlock", self.at):
            h = self.conv1(x)
            return self.conv2.apply_parts([("same", h)], short=lambda: self._shortcut(x),
                                          relu=True)

    def _shortcut(self, x):
        if self.shortcut is not None:
            return self.shortcut(x)
        if self.c_in == self.c_out:
            return x
        return F.pad(x, (0, self.c_out - self.c_in))


class MgNet(nn.Module):
    """Pyramid network: the stem takes the image, body blocks map
    pyramid -> pyramid, the head maps pyramid -> output. The builders
    return it in eval mode (a trainer calls ``.train()``)."""

    def __init__(self, blocks):
        super().__init__()
        self.seq = Sequential(blocks)

    def forward(self, x):
        return self.seq(x)


def _pool_after(widths, kernels):
    # concat mode when the block's last kernel is 1
    return MgPool(widths, "concat" if kernels[-1] == 1 else "plain")


def build_plain_mg(blocks, n_layer, n_classes, eps=1e-3, compute_dtype=None, device=None,
                   generator=None) -> MgNet:
    """The plain multigrid assembly loop: per block, ``n_layer`` mg-conv
    layers (block 1's first is the input pyramid), then an MgPool. (The
    JAX loop's per-block dropouts are given by no net.)"""
    kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
    layers, widths = [], None
    for bi, (ws, ks) in enumerate(blocks):
        for li in range(n_layer):
            if bi == 0 and li == 0:
                layers.append(MgConvInput(ws, eps=eps, **kw))
            else:
                layers.append(MgConv(widths, ws, ks, eps=eps, **kw))
            widths = list(ws)
        layers.append(_pool_after(widths, ks))
        widths = layers[-1].out_widths
    layers.append(LogSoftmaxClassifier(widths[0], n_classes, **kw))
    return MgNet(layers).eval()


def build_residual_mg(blocks, n_layer, n_classes, dropouts=None, eps=1e-5, compute_dtype=None,
                      device=None, generator=None) -> MgNet:
    """The residual multigrid assembly loop: block 1's first layer is the
    input pyramid plus one residual layer at constant width; the others
    are residual layers; an MgPool after each block."""
    kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
    layers, widths = [], None
    for bi, (ws, ks) in enumerate(blocks):
        dr = (dropouts[bi] if dropouts else None) or 0.0
        for li in range(n_layer):
            if bi == 0 and li == 0:
                layers.append(MgConvInput(ws, eps=eps, **kw))
                layers.append(MgResidual(ws, ws, [3] * len(ws), eps=eps, dropout=dr, **kw))
            else:
                layers.append(MgResidual(widths, ws, ks, eps=eps, dropout=dr, **kw))
            widths = list(ws)
        layers.append(_pool_after(widths, ks))
        widths = layers[-1].out_widths
    layers.append(LogSoftmaxClassifier(widths[0], n_classes, **kw))
    return MgNet(layers).eval()


def build_pyramid_prefix(widths, n_layer, residual=False, eps=1e-3, c_in=3, compute_dtype=None,
                         device=None, generator=None) -> list:
    """The P-nets' progressive grid introduction: after the input
    pyramid of a ``c_in``-channel image, ``n_layer`` layers on the
    coarsest grid alone (a ConvBN-ReLU or a ResBlock), then ``n_layer``
    mg layers on the two coarsest, ..., then on all grids; finer grids
    pass through untouched."""
    kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
    n = len(widths)
    layers = [MgConvInput(widths, c_in=c_in, eps=eps, **kw)]
    for n_grid in range(1, n + 1):
        for _ in range(n_layer):
            if n_grid == 1:
                unit = (ResBlock(widths[-1], widths[-1], eps=eps, **kw) if residual
                        else ConvBN(widths[-1], widths[-1], 3, relu=True, eps=eps, **kw))
                layers.append(PerScale([None] * (n - 1) + [unit]))
            else:
                tail = list(widths[n - n_grid:])
                op = (MgResidual(tail, tail, [3] * n_grid, eps=eps, **kw) if residual
                      else MgConv(tail, tail, [3] * n_grid, eps=eps, **kw))
                layers.append(TailOp(n - n_grid, op, list(widths)))
    return layers
