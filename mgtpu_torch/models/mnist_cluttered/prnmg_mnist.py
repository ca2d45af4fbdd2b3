"""PR-NMG for cluttered MNIST (counterpart of
`mgtpu/models/mnist_cluttered/prnmg_mnist.py`): pnmg.mnist's plan with
residual mg layers (1x1 ConvBN shortcuts where they narrow) and a
ResBlock in the pyramid prefix; the output block's last layer has 1x1
kernels and no final ReLU -> scale 0 -> sigmoid in f32. BN eps 1e-5.
BCE loss, step LR 0.1 x 0.2^#{e >= 60, 120, 160}."""

from __future__ import annotations

from mgtpu_torch.models.base import step_rule
from mgtpu_torch.models.common import MgNet, SigmoidHead, build_pyramid_prefix
from mgtpu_torch.models.mnist_cluttered.pnmg_mnist import PnmgMnistNet
from mgtpu_torch.ops.mg import DropCoarsest, MgResidual

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
    layers = build_pyramid_prefix(BLOCKS4, n_layer, residual=True, eps=1e-5, c_in=1, **kw)
    widths = list(BLOCKS4)
    for bi in range(1, len(plan)):
        ws, is_drop = plan[bi]
        for li in range(n_layer):
            if li == 0 and is_drop:
                layers.append(DropCoarsest(widths))
                widths = layers[-1].out_widths
            is_out = bi == len(plan) - 1 and li == n_layer - 1
            k = 1 if is_out else 3
            layers.append(MgResidual(widths, list(ws), [k] * len(ws), final_relu=not is_out,
                                     **kw))
            widths = list(ws)
    layers.append(SigmoidHead(0))
    return MgNet(layers).eval()


class PrnmgMnistNet(PnmgMnistNet):
    name = "mnist-cluttered/prnmg.mnist"
    dataset = "mnist-spt"

    def create_model(self, opt, compute_dtype=None, device=None, generator=None):
        return build(opt.nLayer, self.n_classes(opt), compute_dtype, device, generator)

    def train_rule(self, epoch, opt):
        return step_rule(epoch)


NET = PrnmgMnistNet()
