"""Spatial resampling on NHWC tensors (port of `mgtpu/ops/resample.py`).

Activations stay NHWC at every public function. The stock torch ops
run on the NCHW view ``x.permute(0, 3, 1, 2)``, which for a contiguous
NHWC tensor is a ``channels_last`` tensor that cuDNN takes without a
copy; the result is permuted back, again without a copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mgtpu_torch.ops.cuda_pool import maxpool2


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC. A no-copy view when ``x`` is
    channels_last, as the stock ops return for a channels_last input."""
    return x.permute(0, 2, 3, 1).contiguous()


def maxpool2_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with ceil semantics: a window that runs past the
    bottom or right edge is clipped, as the JAX version's -inf padding
    does. Its gradient goes to the first tied element of a window, as
    XLA's SelectAndScatter gives the JAX version's. On a CUDA tensor
    this launches the hand-written kernels."""
    return maxpool2(x, ties="first")


def maxpool(x: torch.Tensor, k: int, s: int, pad: int = 0) -> torch.Tensor:
    """General max pool, floor semantics (the 3x3/2 pad-1 stem pool).
    Padding is -inf, as in the JAX ``reduce_window``."""
    return nhwc(F.max_pool2d(nchw(x), k, s, pad))


def avgpool(x: torch.Tensor, r: int, s: int | None = None) -> torch.Tensor:
    """r x r / s average pool, VALID, accumulated in f32 and returned in
    ``x.dtype``."""
    s = r if s is None else s
    n, h, w, c = x.shape
    xf = x.float()
    if r == h and r == w:  # global (e.g. Avg(7,7) on 7x7)
        return xf.mean(dim=(1, 2), keepdim=True).to(x.dtype)
    if s == r and h % r == 0 and w % r == 0:
        y = xf.reshape(n, h // r, r, w // r, r, c).mean(dim=(2, 4))
        return y.to(x.dtype)
    return nhwc(F.avg_pool2d(nchw(xf), r, s)).to(x.dtype)


def upsample_nearest2(x: torch.Tensor, out_h: int | None = None,
                      out_w: int | None = None) -> torch.Tensor:
    """Nearest-neighbour 2x upsample; optionally crops to (out_h, out_w)
    so odd-sized ceil-pooled partners line up. Returns a contiguous
    tensor."""
    y = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    if out_h is not None and y.shape[1] != out_h:
        y = y[:, :out_h]
    if out_w is not None and y.shape[2] != out_w:
        y = y[:, :, :out_w]
    return y.contiguous()


def ceil_div2(n: int) -> int:
    return -(-n // 2)
