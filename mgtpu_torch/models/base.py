"""Losses and learning-rate rules of the model zoo (counterpart of
`mgtpu/models/base.py`): ``nll_loss`` and ``imagenet_rule``.
``bce_loss`` and the other rules are not ported yet."""

from __future__ import annotations

from typing import Dict

import torch


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """ClassNLLCriterion: mean negative log-likelihood of int labels,
    for models that end in log_softmax."""
    return -log_probs.gather(1, labels.long()[:, None]).mean()


def imagenet_rule(epoch: int, base: float = 0.1, decay: float = 0.1, every: int = 30,
                  wd: float = 1e-4) -> Dict[str, float]:
    """LR = base * decay^floor((e-1)/every), weight decay 1e-4."""
    return {"lr": base * decay ** ((epoch - 1) // every), "wd": wd}
