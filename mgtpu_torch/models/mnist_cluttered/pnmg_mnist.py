"""P-NMG for cluttered MNIST (counterpart of
`mgtpu/models/mnist_cluttered/pnmg_mnist.py`): seven blocks of 3x3
mg-convs at the constant 64 px resolution (no pooling) on four grids
{64, 32, 16, 8}, narrowing to three, two and one grid by dropping the
coarsest inside the first layer of blocks 5-7; block 1 is the pyramid
prefix of the 1-channel image; the last layer is ConvBN without ReLU ->
scale 0 -> sigmoid in f32. BN eps 1e-3. BCE loss, log-linear LR rule."""

from __future__ import annotations

from mgtpu_torch.models.common import MgNet, SigmoidHead, build_pyramid_prefix
from mgtpu_torch.models.mnist_cluttered import MnistNetSpec
from mgtpu_torch.ops.mg import DropCoarsest, MgConv

BLOCKS4 = [64, 32, 16, 8]


def build(n_layer, n_class, compute_dtype=None, device=None, generator=None) -> MgNet:
    kw = dict(compute_dtype=compute_dtype, device=device, generator=generator)
    # (widths, whether the block's first layer drops the coarsest grid)
    plan = [
        (BLOCKS4, False),
        (BLOCKS4, False),
        (BLOCKS4, False),
        (BLOCKS4, False),
        ([64, 32, 16], True),
        ([64, 32], True),
        ([n_class], True),
    ]
    layers = build_pyramid_prefix(BLOCKS4, n_layer, residual=False, eps=1e-3, c_in=1, **kw)
    widths = list(BLOCKS4)
    for bi in range(1, len(plan)):
        ws, is_drop = plan[bi]
        for li in range(n_layer):
            if li == 0 and is_drop:
                layers.append(DropCoarsest(widths))
                widths = layers[-1].out_widths
            relu = not (bi == len(plan) - 1 and li == n_layer - 1)  # the output layer's none
            layers.append(MgConv(widths, list(ws), relu=relu, eps=1e-3, **kw))
            widths = list(ws)
    layers.append(SigmoidHead(0))
    return MgNet(layers).eval()


class PnmgMnistNet(MnistNetSpec):
    name = "mnist-cluttered/pnmg.mnist"
    dataset = "mnist-aff"

    def arguments(self, parser):
        parser.add_argument("--nLayer", type=int, default=1, help="layers per block")

    def create_model(self, opt, compute_dtype=None, device=None, generator=None):
        return build(opt.nLayer, self.n_classes(opt), compute_dtype, device, generator)

    def describe(self, opt):
        return f"{self.name} nLayer {opt.nLayer} {opt.dataset or self.dataset}"


NET = PnmgMnistNet()
