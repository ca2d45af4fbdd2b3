"""Fold eval-mode BatchNorm into the preceding conv (counterpart of
`mgtpu/ops/fold.py`):

    BN_eval(conv(x, W) + b) = conv(x, W * a) + ((b - mean) * a + beta)
    with a = gamma / sqrt(var + eps)        (per output channel)

The port folds in place: each ConvBN's conv (and each UpConvBN's
transposed conv: its HWIO weight has the output channel last too)
absorbs ``a`` and the BN drops its parameters and stats, which marks it
folded (the identity). A quantized conv (`mgtpu_torch.ops.quant`) folds
as the JAX package's does: its per-channel dequant ``scale`` absorbs
``a``; ``w8`` and the activation scales ``sx`` stay as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from mgtpu_torch.nn import ConvBN, UpConvBN


@torch.no_grad()
def _fold_convbn(layer: ConvBN | UpConvBN) -> None:
    bn, conv = layer.bn, layer.conv
    if bn.folded:
        return
    # the BN offset lands in the conv bias: a bias-less conv cannot take it
    if conv.b is None:
        raise ValueError("cannot fold BN into a bias-less Conv: no bias to absorb "
                         "the BN offset (beta - mean*a)")
    a = bn.scale * torch.rsqrt(bn.var + bn.eps)
    conv.b.copy_(bn.bias + (conv.b - bn.mean) * a)
    if getattr(conv, "quantized", False):  # a Conv; ConvTranspose stays float
        conv.scale.mul_(a)
    else:
        conv.w.mul_(a)  # HWIO: the output channel is the last axis
    bn.drop_folded()


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """Fold every ConvBN's and UpConvBN's BatchNorm into its conv, in
    place; returns ``model``. Folding twice is a no-op. Eval/serving
    only."""
    for m in model.modules():
        if isinstance(m, (ConvBN, UpConvBN)):
            _fold_convbn(m)
    return model
