"""The offline test harness "net" (counterpart of
`mgtpu/models/mnist_cluttered/mnist_test.py`, the rebuild of
`models/mnist-cluttered/mnist-test.lua`): run with ``-retrain <ckpt>
-test``, it rebuilds the trained net from the checkpoint's meta
(`mgtpu_torch.serve.read_checkpoint`), scores it with BCE and ``meanIU``
and stores its per-pixel probabilities as ``prediction``, which the test
pass dumps to testOutput_<epoch>.h5."""

from __future__ import annotations

from mgtpu_torch.models.base import NetOpts, NetSpec, bce_loss
from mgtpu_torch.utils.metrics import mnist_iu


class MnistTestNet(NetSpec):
    name = "mnist-cluttered/mnist-test"
    image_size = 64
    channels = 1
    dataset = "mnist-spt"

    def trained_opts(self, opt: NetOpts) -> NetOpts:
        """The options of the net ``opt.retrain``'s checkpoint holds."""
        from mgtpu_torch.serve import read_checkpoint

        if opt.retrain in (None, "none"):
            raise ValueError("mnist-test requires -retrain <checkpoint>")
        return read_checkpoint(opt.retrain, opt)[1]

    def create_model(self, opt, compute_dtype=None, device=None, generator=None):
        from mgtpu_torch.models import create_model

        return create_model(self.trained_opts(opt), compute_dtype=compute_dtype, device=device,
                            generator=generator)

    def create_loss(self, opt):
        return bce_loss

    def train_rule(self, epoch, opt):
        raise NotImplementedError("mnist-test is a test-only harness")

    def train_metrics(self, outputs, labels, loss):
        return {"loss": loss}

    def test_metrics(self, outputs, labels, loss):
        return {"loss": loss, "meanIU": mnist_iu(outputs, labels)}

    def stored_outputs(self, outputs):
        return {"prediction": outputs}


NET = MnistTestNet()
