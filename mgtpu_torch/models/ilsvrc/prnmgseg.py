"""PR-MG-30/52, the four-grid residual multigrid net for ImageNet
(counterpart of `mgtpu/models/ilsvrc/prnmgseg.py`): a 7x7/2 + maxpool
stem per scale -> {64, 32, 16, 8} at (56, 28, 14, 7); a pyramid prefix
whose stages set the tail's widths to the stage's leading width
({..., 16, 16} -> {.., 32, 32, 32} -> {64, 64, 64, 64}), a ResBlock on
the coarsest grid first; then residual mg blocks {64, 64, 64, 128} ->
{64, 64, 128, 256} -> {64, 128, 256, 512} with no pooling between them;
``--shortcutType`` A, B or C (the prefix's ResBlock takes a 1x1 ConvBN
shortcut under C); the classifier reads the coarsest scale: Avg7x7 ->
Dense(512, 1000) -> log-softmax. Depth 30: {2, 2, 2, 2} layers per
block, 52: {3, 4, 6, 3}. NLL loss, loss, top-1 and top-5, LR 0.1 x
0.1^floor((e-1)/30), weight decay 1e-4."""

from __future__ import annotations

from mgtpu_torch.models.common import LogSoftmaxClassifier, MgNet, ResBlock
from mgtpu_torch.models.ilsvrc.rnmg import IlsvrcRnmgNet
from mgtpu_torch.ops.mg import MgResidual, MgStem7x7, PerScale, TailOp

STEM = [64, 32, 16, 8]
CFG = {30: [2, 2, 2, 2], 52: [3, 4, 6, 3]}
BLOCKS = [
    ([64, 32, 16, 8], [3, 3, 3, 3]),  # the prefix (its widths are set by its stages)
    ([64, 64, 64, 128], [3, 3, 3, 3]),
    ([64, 64, 128, 256], [3, 3, 3, 3]),
    ([64, 128, 256, 512], [3, 3, 3, 3]),
]
SHORTCUT_TYPES = ("A", "B", "C")


def build(depth=30, shortcut_type="A", n_classes=1000, compute_dtype=None, device=None,
          generator=None) -> MgNet:
    if depth not in CFG or shortcut_type not in SHORTCUT_TYPES:
        raise ValueError(f"ilsvrc/prnmgseg: depth {depth} not in {sorted(CFG)} or shortcut "
                         f"type {shortcut_type!r} not in {SHORTCUT_TYPES}")
    kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
    n = len(STEM)
    layers = [MgStem7x7(STEM, **kw)]
    widths = list(STEM)
    for n_grid in range(1, n + 1):
        for _ in range(CFG[depth][0]):
            if n_grid == 1:
                unit = ResBlock(widths[-1], widths[-1],
                                shortcut_type="C" if shortcut_type == "C" else "", **kw)
                layers.append(PerScale([None] * (n - 1) + [unit]))
            else:
                tail_out = [widths[n - n_grid]] * n_grid
                op = MgResidual(widths[n - n_grid:], tail_out, [3] * n_grid,
                                shortcut_type=shortcut_type, **kw)
                layers.append(TailOp(n - n_grid, op, list(widths)))
                widths = widths[:n - n_grid] + tail_out
    for bi in range(1, len(BLOCKS)):
        ws, ks = BLOCKS[bi]
        for _ in range(CFG[depth][bi]):
            layers.append(MgResidual(widths, ws, ks, shortcut_type=shortcut_type, **kw))
            widths = list(ws)
    layers.append(LogSoftmaxClassifier(widths[-1], n_classes, pool=7, scale=-1, **kw))
    return MgNet(layers).eval()


class PrnmgsegNet(IlsvrcRnmgNet):
    name = "ilsvrc/prnmgseg"
    depth = 30

    def arguments(self, parser):
        parser.add_argument("--depth", type=int, default=self.depth,
                            choices=sorted(CFG), help="network depth")
        parser.add_argument("--shortcutType", default="B", choices=SHORTCUT_TYPES,
                            help="residual shortcut type")

    def create_model(self, opt, compute_dtype=None, device=None, generator=None):
        return build(opt.depth, opt.shortcutType, self.n_classes(opt),
                     compute_dtype=compute_dtype, device=device, generator=generator)

    def describe(self, opt):
        return f"{self.name} depth {opt.depth} shortcutType {opt.shortcutType}"


NET = PrnmgsegNet()
