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


def mnist_iu(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sample mean IU over the classes present, at the threshold 0.5,
    as a 0-dim f32 tensor: for sample i, IU_i = TP_i / (TP_i + mismatches_i)
    over its whole (H, W, C) volume, divided by the number of classes
    present in its target, averaged over the samples whose target has
    any class. probs and targets (N, H, W, C)."""
    pred = (probs >= 0.5).float()
    t = targets.float()
    axes = tuple(range(1, t.dim()))
    tp = ((pred == 1) & (t == 1)).sum(dim=axes).float()
    fp_fn = (pred != t).sum(dim=axes).float()
    iu = tp / torch.clamp_min(tp + fp_fn, 1e-12)
    n_class = (t == 1).flatten(1, -2).any(dim=1).sum(dim=-1).float()
    per_sample = torch.where(n_class > 0, iu / torch.clamp_min(n_class, 1.0), 0.0)
    return per_sample.sum() / torch.clamp_min((n_class > 0).float().sum(), 1.0)


def seg_mean_iu_mean_acc(probs: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5):
    """Per-class counts for the offline segmentation metrics
    (`tools/seg_metrics.py`): IU_c = TP_c / (TP_c + FP_c + FN_c) and
    Acc_c = TP_c / (TP_c + FP_c), each averaged over all C classes by the
    caller. probs and targets (N, H, W, C); returns the sums (tp, fp, fn),
    each (C,) f32, so a caller can add them up over batches."""
    pred = (probs >= threshold).float()
    t = targets.float()
    axes = tuple(range(t.dim() - 1))
    return (pred * t).sum(dim=axes), (pred * (1 - t)).sum(dim=axes), ((1 - pred) * t).sum(dim=axes)
