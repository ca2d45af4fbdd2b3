"""Multigrid ops on feature pyramids (counterpart of `mgtpu/ops/mg.py`).

A pyramid is a tuple of NHWC tensors, finest scale first; scale i+1 has
half the spatial extent of scale i. Only the fused-exchange formulation
is ported: each exchange conv takes its scale's parts through
`ConvBN.apply_parts` and the resample-concat is never built. Every block
runs in eval mode (serving) and in train mode (the training step).
Under int8 a layer (the stems, `MgConv`, each stage of `MgResidual`)
quantizes all of its conv parts in one call (`nn.quantize_layer`: one
launch a layer on the card) before its first conv runs.

Each multigrid layer's forward is a span (`mgtpu_torch.trace`) under its
class's name, carrying the layer's position in the net (``at``, given by
`number_layers`, which numbers the single-grid `ResBlock`s with them).

Under -spatial (`mgtpu_torch.parallel.axis`) each scale is an H-slab or
whole by JAX's `constrain_spatial` rule of its height: the ops that
change a height (pools, strided convs, transposed convs) put their
outputs in that layout, and `exchange_parts` hands a conv its coarser
neighbour in the layout of its own scale, so no layer mixes the two.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mgtpu_torch import trace
from mgtpu_torch.nn import ConvBN, Dropout, UpConvBN, quantize_layer
from mgtpu_torch.ops.cuda_conv import bn_relu_plain
from mgtpu_torch.parallel import axis
from mgtpu_torch.ops.resample import (avgpool, maxpool, maxpool2_ceil, maxpool2_ceil_group,
                                     upsample_nearest2)

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


def pool_finer(pyr: Pyramid) -> tuple:
    """maxpool2_ceil of every scale but the coarsest, in one group: the
    exchange's down parts of a layer (scale i takes entry i - 1), whose
    backward is one launch on the card."""
    return maxpool2_ceil_group(pyr[:-1])


def exchange_parts(pyr: Pyramid, i: int, same=None, down=None):
    """The i-th scale's exchange inputs as a list of ``(kind, tensor)``,
    in the concat order {maxpool2(finer), self, coarser}. The coarser
    neighbour is passed raw (kind "up") so the conv can fold its
    nearest upsample. ``same`` replaces ``pyr[i]`` as the "same" part
    (an un-normalized ``(y_raw, scale, shift)``, see
    `ConvBN.conv_parts`). ``down`` is the layer's ``pool_finer(pyr)``,
    made once for all its scales; without it the finer scale is pooled
    alone. Under -spatial the coarser neighbour comes in the layout of
    scale i (an H-slab under a slab, whole under a whole tensor)."""
    n = len(pyr)
    parts = []
    if i > 0:
        parts.append(("down", maxpool2_ceil(pyr[i - 1]) if down is None else down[i - 1]))
    parts.append(("same", pyr[i] if same is None else same))
    if i + 1 < n:
        parts.append(("up", axis.aligned(pyr[i + 1], pyr[i])))
    return parts


def materialize_part(kind: str, xp, oh: int, ow: int):
    """Resolve an exchange part to its fine-resolution tensor (an H-slab's
    upsample: the fine slab)."""
    if kind == "up":
        g = axis.rows(xp)
        y = upsample_nearest2(xp, oh, ow)
        return y if g is None else axis.mark(y, 2 * g)
    return xp


class Layer(nn.Module):
    """A layer of the net whose forward is a span under its class's name,
    carrying ``at``, its position in the net (`number_layers`; None
    until then): each multigrid layer here, and the single-grid
    `models.common.ResBlock`."""

    at = None


class MgConvInput(Layer):
    """Input pyramid stem: scale i = avgpool(2^i) of the image (taken
    progressively, each scale the 2x2 average of the one before) followed
    by ConvBN-ReLU, a 3x3 conv of the ``c_in``-channel image on the
    kernel."""

    def __init__(self, widths, c_in=3, eps=1e-5, compute_dtype=None, device=None,
                 generator=None):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvBN(c_in, w, 3, relu=True, eps=eps, compute_dtype=compute_dtype, device=device,
                   generator=generator)
            for w in widths)
        self.out_widths = list(widths)

    def forward(self, x):
        with trace.span("MgConvInput", self.at):
            xs = [x]
            for _ in self.convs[1:]:
                xs.append(avgpool(xs[-1], 2))
            parts = quantize_layer(self.convs, [[("same", xi)] for xi in xs])
            return tuple(conv.apply_parts(p) for conv, p in zip(self.convs, parts))


class MgStem7x7(Layer):
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
        with trace.span("MgStem7x7", self.at):
            xs = [x]
            for _ in self.convs[1:]:  # progressive dyadic pyramid (== avgpool(2^i) of x)
                xs.append(avgpool(xs[-1], 2))
            parts = quantize_layer(self.convs, [[("same", xi)] for xi in xs])
            return tuple(maxpool(conv.apply_parts(p), 3, 2, 1)
                         for conv, p in zip(self.convs, parts))


class MgConv(Layer):
    """Plain multigrid conv layer: per scale, the exchange then ConvBN and
    (unless ``relu`` is False: the mnist nets' output layers) ReLU,
    through ``ConvBN.apply_parts``; ``dropout`` drops each exchange part
    before the conv (P-NMG's placement, the only one a net gives)."""

    def __init__(self, in_widths, out_widths, kernels=None, relu=True, eps=1e-5, dropout=0.0,
                 compute_dtype=None, device=None, generator=None):
        super().__init__()
        n = len(in_widths)
        if len(out_widths) != n:
            raise ValueError(f"{len(in_widths)} input scales, {len(out_widths)} output")
        ks = list(kernels) if kernels is not None else [3] * n
        mixed = pyramid_widths_after_exchange(in_widths)
        self.convs = nn.ModuleList(
            ConvBN(mixed[i], out_widths[i], ks[i], relu=relu, eps=eps, dropout=dropout,
                   dropout_pos="before", compute_dtype=compute_dtype, device=device,
                   generator=generator)
            for i in range(n))
        self.out_widths = list(out_widths)

    def forward(self, pyr):
        with trace.span("MgConv", self.at):
            down = pool_finer(pyr)
            parts = quantize_layer(self.convs, [exchange_parts(pyr, i, down=down)
                                                for i in range(len(self.convs))])
            return tuple(conv.apply_parts(p) for conv, p in zip(self.convs, parts))


class DropCoarsest(nn.Module):
    """Discard the coarsest grid without pooling: the mnist P-nets' grid
    drop inside a layer."""

    def __init__(self, widths):
        super().__init__()
        self.out_widths = list(widths)[:-1]

    def forward(self, pyr):
        return tuple(pyr[:-1])


class TailOp(nn.Module):
    """Pass the first ``n_pass`` scales through untouched and apply
    ``op`` to the remaining (coarser) ones: the pyramid prefix's
    plumbing."""

    def __init__(self, n_pass, op, widths):
        super().__init__()
        self.n_pass, self.op = n_pass, op
        self.out_widths = list(widths[:n_pass]) + list(op.out_widths)

    def forward(self, pyr):
        return tuple(pyr[:self.n_pass]) + tuple(self.op(pyr[self.n_pass:]))


class PerScale(nn.Module):
    """Apply the i-th layer to the i-th scale; None is the identity."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(nn.Identity() if layer is None else layer for layer in layers)

    def forward(self, pyr):
        return tuple(layer(x) for layer, x in zip(self.layers, pyr, strict=True))


class MgResidual(Layer):
    """Residual multigrid layer, per scale:

        y = relu( shortcut(x) + ConvBN(xc( ConvBNReLU(xc(x)) )) )

    with xc the exchange, and without the outer ReLU when ``final_relu``
    is False (prnmg.mnist's output layer). Shortcut types: A zero-pads
    channels when widening and is the identity otherwise; B uses a 1x1
    ConvBN when the widths differ; C always does. Narrowing under A also
    takes a 1x1 ConvBN. With ``dropout``, in train mode every part of
    each exchange is materialized at fine resolution and dropped with
    its own mask before its conv. The JAX layer's materialized
    (non-fused) exchange is not ported. In eval mode a stage-2 conv that
    `ConvBN.ends_in_kernel` takes the shortcut as the start of its part
    sum and the outer ReLU in its last `conv3x3` launch."""

    def __init__(self, in_widths, out_widths, kernels=None, eps=1e-5, dropout=0.0,
                 shortcut_type="A", final_relu=True, compute_dtype=None, device=None,
                 generator=None):
        super().__init__()
        n = len(in_widths)
        if len(out_widths) != n:
            raise ValueError(f"{len(in_widths)} input scales, {len(out_widths)} output")
        ks = list(kernels) if kernels is not None else [3] * n
        self.in_widths, self.out_widths = list(in_widths), list(out_widths)
        self.final_relu = final_relu
        kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
        mixed1 = pyramid_widths_after_exchange(in_widths)
        mixed2 = pyramid_widths_after_exchange(out_widths)
        self.stage1 = nn.ModuleList(
            ConvBN(mixed1[i], out_widths[i], ks[i], relu=True, eps=eps, **kw) for i in range(n))
        self.stage2 = nn.ModuleList(
            ConvBN(mixed2[i], out_widths[i], ks[i], relu=False, eps=eps, **kw) for i in range(n))
        # scale index -> 1x1 ConvBN; scales not in here are identity / zero-pad
        self.shortcuts = nn.ModuleDict({
            str(i): ConvBN(cin, cout, k=1, relu=False, eps=eps, **kw)
            for i, (cin, cout) in enumerate(zip(in_widths, out_widths))
            if shortcut_type == "C" or (cin != cout and (shortcut_type == "B" or cin > cout))
        })
        self.drop = Dropout(dropout, generator) if dropout > 0 else None

    def _stage(self, layers, pyr, shorts=None):
        """One stage's convs on ``pyr``; with ``shorts`` (stage 2, a
        function a scale that computes its shortcut), each scale's output
        joined with its shortcut (`ConvBN.apply_parts`)."""
        down = pool_finer(pyr)
        stage = []
        for i in range(len(layers)):
            parts = exchange_parts(pyr, i, down=down)
            if self.drop is not None and self.training:
                oh, ow = pyr[i].shape[1], pyr[i].shape[2]
                parts = [("same", self.drop(materialize_part(kind, xp, oh, ow)))
                         for kind, xp in parts]
            stage.append(parts)
        return tuple(layer.apply_parts(parts, short=None if shorts is None else shorts[i],
                                       relu=self.final_relu)
                     for i, (layer, parts) in enumerate(zip(layers,
                                                            quantize_layer(layers, stage))))

    def _shortcut(self, i, x):
        cin, cout = self.in_widths[i], self.out_widths[i]
        if str(i) in self.shortcuts:
            return self.shortcuts[str(i)](x)
        if cin == cout:
            return x
        return F.pad(x, (0, cout - cin))  # zero-pad widen

    def _train_stages(self, pyr):
        """Both stages in train mode. Stage 1 stops at each scale's raw
        part sum y1 and its BN's batch (scale, shift); stage 2 takes its
        same-scale part un-normalized, so the `conv3x3_bn_relu_in`
        kernel applies relu(bn(y1)) as it reads. relu(bn(y1)) is built
        only for the neighbours' down and up parts: nowhere in a
        single-scale block. Under -tensor y1 and (scale, shift) are
        gathered from their channel slices first."""
        n = len(pyr)
        down = pool_finer(pyr)
        raw = [layer.conv_parts(exchange_parts(pyr, i, down=down))
               for i, layer in enumerate(self.stage1)]
        affine = [layer.bn.batch_affine(y) for layer, y in zip(self.stage1, raw)]
        for i, layer in enumerate(self.stage1):
            tp = layer.conv.tp
            if tp is not None:  # -tensor: the channel slices put together
                raw[i] = axis.gather_c(raw[i], tp)
                affine[i] = tuple(axis.gather_c(v, tp) for v in affine[i])
        act = tuple(bn_relu_plain(y, *a) if n > 1 else None for y, a in zip(raw, affine))
        down = pool_finer(act)
        return tuple(layer._tail(layer.conv_parts(exchange_parts(act, i, (raw[i], *affine[i]),
                                                                 down)))
                     for i, layer in enumerate(self.stage2))

    def forward(self, pyr):
        with trace.span("MgResidual", self.at):
            if not self.training:
                shorts = [functools.partial(self._shortcut, i, x) for i, x in enumerate(pyr)]
                return self._stage(self.stage2, self._stage(self.stage1, pyr), shorts)
            if self.drop is None:
                h = self._train_stages(pyr)
            else:
                h = self._stage(self.stage2, self._stage(self.stage1, pyr))
            out = []
            for i, (x, y) in enumerate(zip(pyr, h)):
                z = y + self._shortcut(i, x).to(y.dtype)
                out.append(torch.relu(z) if self.final_relu else z)
            return tuple(out)


class MgPool(Layer):
    """Block transition: mode "plain" max-pools (2x2/2, ceil) every
    scale; mode "concat" pools scales 0..n-2 and concatenates the
    untouched coarsest scale onto scale n-2, leaving n-1 scales; mode
    "drop" pools scales 0..n-2 and drops the coarsest. The pools form one
    group (one backward launch on the card)."""

    def __init__(self, widths, mode="plain"):
        super().__init__()
        w = list(widths)
        if mode == "concat":
            if len(w) < 2:
                raise ValueError("concat pooling needs at least two scales")
            self.out_widths = w[:-2] + [w[-2] + w[-1]]
        elif mode == "drop":
            self.out_widths = w[:-1]
        elif mode == "plain":
            self.out_widths = w
        else:
            raise ValueError(f"MgPool mode {mode!r} is not plain, concat or drop")
        self.mode = mode

    def forward(self, pyr):
        with trace.span("MgPool", self.at):
            if self.mode == "plain":
                return maxpool2_ceil_group(pyr)
            out = list(pool_finer(pyr))
            if self.mode == "concat":
                out[-1] = torch.cat([out[-1], pyr[-1]], dim=-1)
            return tuple(out)


class MgUpConv(Layer):
    """Per scale, a 2x2/2 transposed conv, BN and ReLU (UpConvBN)."""

    def __init__(self, in_widths, out_widths, compute_dtype=None, device=None, generator=None):
        super().__init__()
        if len(in_widths) != len(out_widths):
            raise ValueError(f"{len(in_widths)} input scales, {len(out_widths)} output")
        self.ups = nn.ModuleList(
            UpConvBN(cin, cout, compute_dtype=compute_dtype, device=device, generator=generator)
            for cin, cout in zip(in_widths, out_widths))
        self.out_widths = list(out_widths)

    def forward(self, pyr):
        with trace.span("MgUpConv", self.at):
            return tuple(up(x) for up, x in zip(self.ups, pyr, strict=True))


def number_layers(model: nn.Module) -> None:
    """Give each `Layer` of ``model`` (the multigrid layers and the
    `ResBlock`s) its position in the net, 0, 1, ... in module order: the
    ``at`` its span carries."""
    for k, m in enumerate(m for m in model.modules() if isinstance(m, Layer)):
        m.at = k
