"""The cluttered-MNIST segmentation and spatial-transform nets
(counterparts of `mgtpu/models/mnist_cluttered/`): unet, unmg,
pnmg.mnist and prnmg.mnist. They take 64x64x1 images and give per-pixel
sigmoid probabilities, 10 channels on mnist-seg and 1 elsewhere,
trained with BCE against dense {0, 1} targets."""

from __future__ import annotations

from mgtpu_torch.models.base import NetOpts, NetSpec, bce_loss, log_linear_rule


class MnistNetSpec(NetSpec):
    """The NetSpec subset these nets share: 64x64x1 images, targets of
    the output's shape, BCE loss, the loss as the only train metric, the
    log-linear LR rule."""

    image_size = 64
    channels = 1

    def n_classes(self, opt: NetOpts) -> int:
        return 10 if (opt.dataset or self.dataset) == "mnist-seg" else 1

    def target_shape(self, opt: NetOpts) -> tuple:
        return (self.image_size, self.image_size, self.n_classes(opt))

    def describe(self, opt: NetOpts) -> str:
        return f"{self.name} {opt.dataset or self.dataset}"

    def create_loss(self, opt):
        return bce_loss

    def train_rule(self, epoch, opt):
        return log_linear_rule(epoch, opt.nEpochs)

    def train_metrics(self, outputs, labels, loss):
        return {"loss": loss}
