"""The mnist-saliency probe in plain PyTorch: a frozen copy of the occlusion
dataset's definition (`dataset/mnist-saliency`: 8x8 windows at stride 2
over 64x64, uniform noise inside each window from a fixed generator, the
MNIST normalisation) and of the probe (`pipelines/saliency/test.lua`:
seven probe boxes on the un-occluded output's confident extent, and per
probe the sum of the masks of the variants whose impact on it is at
least 0.1, weighted by that impact)."""

from __future__ import annotations

import numpy as np
import torch

MEANSTD = ([0.1141], [0.2746])


def occlusion_masks(size=64, window=8, stride=2) -> np.ndarray:
    """Every ``window`` x ``window`` square at ``stride`` -> (N, size, size, 1)."""
    pos = list(range(0, size - window + 1, stride))
    masks = np.zeros((len(pos) ** 2, size, size, 1), np.float32)
    i = 0
    for y in pos:
        for x in pos:
            masks[i, y:y + window, x:x + window, 0] = 1.0
            i += 1
    return masks


def occlusion_noise(mask: np.ndarray, seed: int = 0) -> np.ndarray:
    """The dataset's fixed uniform noise inside each mask."""
    return (np.random.default_rng(seed).uniform(size=mask.shape) * mask).astype(np.float32)


def stacks(base: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Normalised base images (k, H, W, 1) -> (k, 1 + N, H, W, 1): each image,
    then each occluded variant ((1 - m) img + noise - mean) / std, written
    in terms of the normalised image b as (1 - m) b + (noise - m mean) / std."""
    mean, std = MEANSTD[0][0], MEANSTD[1][0]
    offset = (noise - mask * mean) / std
    b = base[:, None]
    return torch.cat([b, (1.0 - mask)[None] * b + offset[None]], 1)


def interest_points(outputs: torch.Tensor, th: float = 0.4, dp: int = 1):
    """outputs (k, H, W, C), each sample's un-occluded output -> (valid (k,),
    (k, 7, H, W, 1) probe boxes): the centre of the extent where the
    output reaches ``th`` and six points on its edges, each a (2 dp + 1)
    box kept inside the image; valid where the extent spans two rows and
    two columns."""
    o = outputs[..., 0].float()
    _, h, w = o.shape
    col_ok = (o.amax(dim=1) >= th).to(torch.int32)
    row_ok = (o.amax(dim=2) >= th).to(torch.int32)
    valid = (col_ok.sum(1) >= 2) & (row_ok.sum(1) >= 2)
    col_st = col_ok.argmax(1)
    col_ed = w - 1 - col_ok.flip(1).argmax(1)
    row_st = row_ok.argmax(1)
    row_ed = h - 1 - row_ok.flip(1).argmax(1)

    def clamp(p, size):
        p = torch.where(p - dp < 0, dp, p)
        return torch.where(p + dp >= size, size - dp - 1, p)

    pts = [(clamp((row_st + row_ed) // 2, h), clamp((col_st + col_ed) // 2, w))]
    for ix in range(2):
        x = clamp(col_st + ix * (col_ed - col_st), w)
        for iy in range(3):
            y = clamp(row_st + torch.ceil((row_ed - row_st) * iy / 2.0).to(row_st.dtype), h)
            pts.append((y, x))
    ys = torch.stack([y for y, _ in pts], 1)[:, :, None, None]
    xs = torch.stack([x for _, x in pts], 1)[:, :, None, None]
    ii = torch.arange(h, device=o.device)[:, None]
    jj = torch.arange(w, device=o.device)[None, :]
    points = ((ii - ys).abs() <= dp) & ((jj - xs).abs() <= dp)
    return valid, points.float()[..., None]


def saliency_maps(outputs: torch.Tensor, points: torch.Tensor, mask: torch.Tensor,
                  threshold: float = 0.1) -> torch.Tensor:
    """outputs (k, 1 + N, H, W, C), points (k, P, H, W, 1), mask (N, H, W, 1)
    -> (k, P, H, W, 1): per probe, the sum over the variants of mask_i
    times impact_i, where impact_i = max |out_i - out_0| over the probe's
    box, kept where it is at least ``threshold``."""
    diff = (outputs[:, 1:] - outputs[:, :1]).abs().float()
    impact = torch.stack([(diff * points[:, j, None]).amax(dim=(2, 3, 4))
                          for j in range(points.shape[1])], 2)
    keep = torch.where(impact >= threshold, impact, 0.0)
    m = mask.reshape(mask.shape[0], -1).float()
    sal = torch.stack([kp.T @ m for kp in keep])
    return sal.reshape(keep.shape[0], keep.shape[2], *mask.shape[1:])
