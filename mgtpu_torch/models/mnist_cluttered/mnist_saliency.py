"""The saliency harness "net" (counterpart of
`mgtpu/models/mnist_cluttered/mnist_saliency.py`, the rebuild of
`models/mnist-cluttered/mnist-saliency.lua`): run with ``-pipeline
saliency -trainedNet <ckpt> -test``, it rebuilds the trained net from
the checkpoint's meta (`mgtpu_torch.serve.read_checkpoint`, as the
``mnist-test`` harness does) and loads its weights and BN stats through
the bridge, so a checkpoint written by either package serves. Test
only: it has no LR rule."""

from __future__ import annotations

from mgtpu_torch.models.base import NetOpts, NetSpec, bce_loss


class MnistSaliencyNet(NetSpec):
    name = "mnist-cluttered/mnist-saliency"
    image_size = 64
    channels = 1
    dataset = "mnist-saliency"

    def arguments(self, parser):
        parser.add_argument("--trainedNet", type=str, default="",
                            help="path to the trained model checkpoint")

    def create_model(self, opt: NetOpts, compute_dtype=None, device=None, generator=None):
        """The net ``opt.trainedNet``'s checkpoint holds, with its weights
        and BN stats, in eval mode."""
        from mgtpu_torch.models import create_model
        from mgtpu_torch.serve import read_checkpoint
        from mgtpu_torch.utils.bridge import load_jax_tree

        if not opt.trainedNet:
            raise ValueError("mnist-saliency requires -trainedNet <checkpoint>")
        blob, trained = read_checkpoint(opt.trainedNet, opt)
        model = create_model(trained, compute_dtype=compute_dtype, generator=generator)
        load_jax_tree(model, blob["params"], blob["stats"])
        return model.to(device)

    def create_loss(self, opt):
        return bce_loss  # registered but unused, as in the JAX package

    def train_rule(self, epoch, opt):
        raise NotImplementedError("mnist-saliency is a test-only harness")

    def train_metrics(self, outputs, labels, loss):
        return {"loss": loss}


NET = MnistSaliencyNet()
