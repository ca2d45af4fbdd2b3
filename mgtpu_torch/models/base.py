"""Losses, learning-rate rules and the NetSpec subset of the model zoo
(counterpart of `mgtpu/models/base.py`): ``nll_loss``, ``bce_loss``,
``imagenet_rule``, ``log_linear_rule`` and ``step_rule``."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch

from mgtpu_torch.utils.metrics import topk_accuracy


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """ClassNLLCriterion: mean negative log-likelihood of int labels,
    for models that end in log_softmax."""
    return -log_probs.gather(1, labels.long()[:, None]).mean()


def bce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCECriterion: the mean binary cross-entropy over all elements, in
    f32, of sigmoid outputs. Each log takes max(., 1e-12), not a clip of
    p: at init the residual heads' logits reach +-17, where the sigmoid
    saturates to 1 and 1 - 1e-12 rounds to 1, so a clip would leave
    log(0). The loss is finite for every input, and its gradient is 0
    where the guard takes the constant."""
    p, t = probs.float(), targets.float()
    return -(t * torch.log(torch.clamp_min(p, 1e-12))
             + (1.0 - t) * torch.log(torch.clamp_min(1.0 - p, 1e-12))).mean()


def log_linear_rule(epoch: int, n_epochs: int, start: float = 1.0, delta: float = 3.0,
                    wd: float = 5e-4) -> Dict[str, float]:
    """LR = 10^-((e-1)*delta/(nEpochs-1) + start): 1e-1 -> 1e-4."""
    denom = max(n_epochs - 1, 1)
    return {"lr": 10.0 ** -((epoch - 1) * delta / denom + start), "wd": wd}


def step_rule(epoch: int, milestones=(60, 120, 160), base: float = 0.1, decay: float = 0.2,
              wd: float = 5e-4) -> Dict[str, float]:
    """LR = base * decay^#{e >= m}."""
    k = sum(1 for m in milestones if epoch >= m)
    return {"lr": base * decay ** k, "wd": wd}


def imagenet_rule(epoch: int, base: float = 0.1, decay: float = 0.1, every: int = 30,
                  wd: float = 1e-4) -> Dict[str, float]:
    """LR = base * decay^floor((e-1)/every), weight decay 1e-4."""
    return {"lr": base * decay ** ((epoch - 1) // every), "wd": wd}


@dataclass(frozen=True)
class NetOpts:
    """The flags that shape a net, under the JAX package's names
    (`mgtpu/utils/opts.py` and each net's ``arguments``): a net reads
    the ones it registers. ``nEpochs`` feeds the log-linear LR rule;
    ``dataset`` and ``depth`` None are the net's own (``NetSpec.dataset``,
    ``NetSpec.depth``; ``NetSpec.options`` fills the depth in). The
    defaults are R-MG-34."""

    netType: str = "ilsvrc/rnmg"
    depth: Optional[int] = None
    nLayer: int = 1
    isDropout: bool = False
    dataset: Optional[str] = None
    nEpochs: int = 20
    shortcutType: str = "B"
    retrain: Optional[str] = None  # the checkpoint a harness (mnist-test) rebuilds its net from
    trainedNet: Optional[str] = None  # the checkpoint the mnist-saliency harness serves

    @classmethod
    def from_meta(cls, meta: dict) -> "NetOpts":
        """The options a checkpoint's ``meta`` names (the JAX package's
        ``model_meta``); the rest keep their defaults."""
        keys = ("netType", "depth", "nLayer", "isDropout", "dataset", "shortcutType")
        return cls(**{k: meta[k] for k in keys if k in meta})


class NetSpec:
    """The JAX NetSpec as serving, training and the run loop use it: the
    model, its input and target shapes, the loss, the LR rule, the
    metrics and the outputs a test pass stores. The default is a CIFAR classifier: 32x32x3 images, int
    labels, NLL loss, loss and top-1 metrics."""

    name = "base"
    image_size = 32  # the recipes' -imageCrop
    channels = 3  # of the images
    dataset = "cifar100"  # when the options name none
    depth = None  # when the options name none, for a net that takes ``--depth``

    @property
    def image_shape(self) -> tuple[int, int, int]:
        """The (H, W, C) NHWC images the net takes."""
        return (self.image_size, self.image_size, self.channels)

    def target_shape(self, opt: NetOpts) -> tuple:
        """A target's shape after the batch axis: () for an int label,
        the output's shape for a net that takes dense targets."""
        return ()

    def options(self, opt: NetOpts) -> NetOpts:
        """``opt`` with the depth it leaves to the net filled in."""
        return opt if opt.depth is not None else replace(opt, depth=self.depth)

    def arguments(self, parser) -> None:
        """Add the net's own flags to an argparse parser (none here)."""

    def create_model(self, opt: NetOpts, compute_dtype=None, device=None, generator=None):
        raise NotImplementedError(f"{self.name}: create_model")

    def n_classes(self, opt: NetOpts) -> int:
        return 10 if opt.dataset == "cifar10" else 100

    def describe(self, opt: NetOpts) -> str:
        """The net and the flags that shape it, for a log line."""
        return (f"{self.name} nLayer {opt.nLayer}{' isDropout' if opt.isDropout else ''} "
                f"{opt.dataset or self.dataset}")

    def create_loss(self, opt):
        return nll_loss

    def train_rule(self, epoch: int, opt: NetOpts) -> Dict[str, float]:
        raise NotImplementedError(f"{self.name}: train_rule")

    def train_metrics(self, outputs, labels, loss):
        return {"loss": loss, "top1": topk_accuracy(outputs, labels, 1)}

    def test_metrics(self, outputs, labels, loss):
        return self.train_metrics(outputs, labels, loss)

    def eval_metrics(self, outputs, labels, loss):
        return self.test_metrics(outputs, labels, loss)

    def stored_outputs(self, outputs) -> Dict[str, torch.Tensor]:
        """Outputs the test pass accumulates and dumps to
        testOutput_<epoch>.h5 (none by default)."""
        return {}
