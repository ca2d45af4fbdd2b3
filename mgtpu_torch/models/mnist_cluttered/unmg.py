"""The multigrid U-Net for cluttered MNIST (counterpart of
`mgtpu/models/mnist_cluttered/unmg.py`): a recursive U-Net over
pyramids, blocks {64, 32, 16} -> {128, 64, 32} -> {256, 128} -> {512};
each level pools every scale (dropping the coarsest where its block says
so), and joins its pre-pool pyramid with the shorter pyramid of the
level below scale by scale (a channel concat where both have the scale);
per-scale 2x2/2 UpConvBN up; head a 1x1 mg-conv without ReLU to the
classes on every scale, then scale 0 -> sigmoid in f32. 3x3 mg-convs
with BN eps 1e-3. BCE loss, log-linear LR rule; test metrics loss and
mean IU at 0.5."""

from __future__ import annotations

import torch
from torch import nn

from mgtpu_torch.models.mnist_cluttered import MnistNetSpec
from mgtpu_torch.ops.mg import MgConv, MgConvInput, MgPool, MgUpConv
from mgtpu_torch.utils.metrics import mnist_iu

# (widths, whether the pool after the block drops the coarsest scale)
BLOCKS = [
    ([64, 32, 16], False),
    ([128, 64, 32], True),
    ([256, 128], True),
    ([512], None),
]


def _cadd(a, b):
    """Scale-wise sum of two width lists of different lengths."""
    n = max(len(a), len(b))
    return [(a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0) for i in range(n)]


class UnmgLevel(nn.Module):
    """Level ``depth`` (0-based) of the multigrid U-Net on a pyramid of
    ``in_widths`` (the image at level 0): conv1, then (but at the last
    level) the pool, the next level ``sub``, the ragged scale-wise
    concat and conv2; then ``up`` back to ``in_widths``, or at level 0
    the ``head``. Its JAX tree keys are its attributes' names (the pool
    has no parameters and no key)."""

    jax_keys = {k: k for k in ("conv1", "sub", "conv2", "up", "head")}

    def __init__(self, depth, in_widths, n_class, compute_dtype=None, device=None,
                 generator=None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
        ws, is_drop = BLOCKS[depth]
        self.out_widths = list(in_widths)
        self.pool = self.sub = self.conv2 = self.up = self.head = None
        if depth == len(BLOCKS) - 1:
            self.conv1 = MgConv(in_widths, ws, eps=1e-3, **kw)
            self.up = MgUpConv(ws, in_widths, **kw)
            return
        self.conv1 = (MgConvInput(ws, c_in=1, eps=1e-3, **kw) if depth == 0
                      else MgConv(in_widths, ws, eps=1e-3, **kw))
        self.pool = MgPool(ws, "drop" if is_drop else "plain")
        self.sub = UnmgLevel(depth + 1, self.pool.out_widths, n_class, **kw)
        self.conv2 = MgConv(_cadd(ws, self.sub.out_widths), ws, eps=1e-3, **kw)
        if depth > 0:
            self.up = MgUpConv(ws, in_widths, **kw)
        else:
            n = len(ws)
            self.head = MgConv(ws, [n_class] * n, [1] * n, relu=False, eps=1e-3, **kw)

    def forward(self, x):
        h = self.conv1(x)
        if self.sub is None:
            return self.up(h)
        below = self.sub(self.pool(h))
        h = self.conv2(tuple(torch.cat([hi, below[i]], dim=-1) if i < len(below) else hi
                             for i, hi in enumerate(h)))
        if self.up is not None:
            return self.up(h)
        return torch.sigmoid(self.head(h)[0].float())


def build(n_class, compute_dtype=None, device=None, generator=None) -> UnmgLevel:
    return UnmgLevel(0, [1, 1, 1], n_class, compute_dtype=compute_dtype, device=device,
                     generator=generator).eval()


class UnmgNet(MnistNetSpec):
    name = "mnist-cluttered/unmg"
    dataset = "mnist-seg"

    def create_model(self, opt, compute_dtype=None, device=None, generator=None):
        return build(self.n_classes(opt), compute_dtype, device, generator)

    def test_metrics(self, outputs, labels, loss):
        return {"loss": loss, "meanIU": mnist_iu(outputs, labels)}


NET = UnmgNet()
