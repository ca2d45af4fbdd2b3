"""R-MG-18/34, the residual multigrid network for ImageNet (counterpart
of `mgtpu/models/ilsvrc/rnmg.py`): a 7x7/2 + maxpool stem per scale ->
{64, 32, 16} at (56, 28, 14); residual blocks {64,32,16} ->
{128,64,32} concat -> {256,128} concat -> {512}, with an MgPool between
blocks; Avg7x7 -> Dense(512, 1000) -> log-softmax. NLL loss, loss, top-1
and top-5 metrics, LR 0.1 x 0.1^floor((e-1)/30), weight decay 1e-4."""

from __future__ import annotations

from mgtpu_torch.models.base import NetSpec, imagenet_rule
from mgtpu_torch.models.common import LogSoftmaxClassifier, MgNet
from mgtpu_torch.ops.mg import MgPool, MgResidual, MgStem7x7
from mgtpu_torch.utils.metrics import topk_accuracy

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
    draws the init; the model is returned in eval mode (a trainer calls
    ``.train()``)."""
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


class IlsvrcRnmgNet(NetSpec):
    name = "ilsvrc/rnmg"
    image_size = 224
    dataset = "ilsvrc"
    depth = 34

    def arguments(self, parser):
        parser.add_argument("--depth", type=int, default=self.depth, choices=sorted(CFG),
                            help="network depth")

    def create_model(self, opt, compute_dtype=None, device=None, generator=None):
        return build_ilsvrc_rnmg(opt.depth, self.n_classes(opt), compute_dtype=compute_dtype,
                                 device=device, generator=generator)

    def n_classes(self, opt):
        return 1000

    def describe(self, opt):
        return f"{self.name} depth {opt.depth}"

    def train_rule(self, epoch, opt):
        return imagenet_rule(epoch)

    def train_metrics(self, outputs, labels, loss):
        return {"loss": loss, "top1": topk_accuracy(outputs, labels, 1),
                "top5": topk_accuracy(outputs, labels, 5)}


NET = IlsvrcRnmgNet()
