"""R-MG-18/34, the residual multigrid network for ImageNet (counterpart
of `mgtpu/models/ilsvrc/rnmg.py`): a 7x7/2 + maxpool stem per scale ->
{64, 32, 16} at (56, 28, 14); residual blocks {64,32,16} ->
{128,64,32} concat -> {256,128} concat -> {512}, with an MgPool between
blocks; Avg7x7 -> Dense(512, 1000) -> log-softmax."""

from __future__ import annotations

from mgtpu_torch.models.common import LogSoftmaxClassifier, MgNet
from mgtpu_torch.ops.mg import MgPool, MgResidual, MgStem7x7

STEM = [64, 32, 16]
CFG = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3]}
BLOCKS = [
    ([64, 32, 16], [3, 3, 3], False),
    ([128, 64, 32], [3, 3, 3], True),
    ([256, 128], [3, 3], True),
    ([512], [3], False),
]


def build_ilsvrc_rnmg(depth: int = 34, n_classes: int = 1000, compute_dtype=None,
                      device=None, generator=None) -> MgNet:
    """Build R-MG-``depth``. ``generator`` (a CPU ``torch.Generator``)
    draws the init; the model is returned in eval mode, the only mode
    the port serves."""
    kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
    layers = [MgStem7x7(STEM, **kw)]
    widths = list(STEM)
    for bi, (ws, ks, is_concat) in enumerate(BLOCKS):
        for _ in range(CFG[depth][bi]):
            layers.append(MgResidual(widths, ws, ks, **kw))
            widths = list(ws)
        if bi < len(BLOCKS) - 1:
            pool = MgPool(widths, "concat" if is_concat else "plain")
            layers.append(pool)
            widths = pool.out_widths
    layers.append(LogSoftmaxClassifier(widths[0], n_classes, pool=7, **kw))
    return MgNet(layers).eval()
