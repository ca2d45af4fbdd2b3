"""The U-Net baseline for cluttered MNIST (counterpart of
`mgtpu/models/mnist_cluttered/unet.py`): a recursive U-Net of widths
{64, 128, 256, 512}, ConvBN-ReLU (eps 1e-3) 3x3 convs, a floor-mode
2x2/2 max pool down and a 2x2/2 UpConvBN up between levels, the skip
joined by a channel concat; head 1x1 ConvBN -> sigmoid in f32, 10
channels on mnist-seg or 1. BCE loss, log-linear LR rule."""

from __future__ import annotations

import torch
from torch import nn

from mgtpu_torch.models.mnist_cluttered import MnistNetSpec
from mgtpu_torch.nn import ConvBN, UpConvBN
from mgtpu_torch.ops.resample import maxpool2_floor

BLOCKS = [64, 128, 256, 512]


class UnetLevel(nn.Module):
    """Level ``depth`` (0-based) of the U-Net on ``c_in`` channels: conv1,
    then (but at the last level) the pool, the next level ``sub``, the
    concat and conv2; then ``up`` back to ``c_in`` channels, or at level 0
    the ``head``. Its JAX tree keys are its attributes' names."""

    jax_keys = {k: k for k in ("conv1", "sub", "conv2", "up", "head")}

    def __init__(self, depth, c_in, n_class, compute_dtype=None, device=None, generator=None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
        c = BLOCKS[depth]
        self.c_in = c_in
        self.conv1 = ConvBN(c_in, c, 3, relu=True, eps=1e-3, **kw)
        self.sub = self.conv2 = self.up = self.head = None
        if depth == len(BLOCKS) - 1:
            self.up = UpConvBN(c, c_in, **kw)
            return
        self.sub = UnetLevel(depth + 1, c, n_class, **kw)
        self.conv2 = ConvBN(c + self.sub.c_in, c, 3, relu=True, eps=1e-3, **kw)
        if depth > 0:
            self.up = UpConvBN(c, c_in, **kw)
        else:
            self.head = ConvBN(c, n_class, 1, relu=False, eps=1e-3, **kw)

    def forward(self, x):
        h = self.conv1(x)
        if self.sub is None:
            return self.up(h)
        h = self.conv2(torch.cat([h, self.sub(maxpool2_floor(h))], dim=-1))
        if self.up is not None:
            return self.up(h)
        return torch.sigmoid(self.head(h).float())


def build(n_class, compute_dtype=None, device=None, generator=None) -> UnetLevel:
    return UnetLevel(0, 1, n_class, compute_dtype=compute_dtype, device=device,
                     generator=generator).eval()


class UnetNet(MnistNetSpec):
    name = "mnist-cluttered/unet"
    dataset = "mnist-sca"

    def create_model(self, opt, compute_dtype=None, device=None, generator=None):
        return build(self.n_classes(opt), compute_dtype, device, generator)


NET = UnetNet()
