"""Metric functions (counterpart of `mgtpu/utils/metrics.py`)."""

from __future__ import annotations

import torch


def topk_accuracy(log_probs: torch.Tensor, labels: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Fraction of samples whose label is among the k largest
    log-probs, as a 0-dim f32 tensor."""
    labels = labels.long()
    if k == 1:
        return (log_probs.argmax(dim=-1) == labels).float().mean()
    topk = log_probs.topk(k, dim=-1).indices
    return (topk == labels[:, None]).any(dim=-1).float().mean()
