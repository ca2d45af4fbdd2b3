"""Spatial resampling on NHWC tensors (port of `mgtpu/ops/resample.py`).

Activations stay NHWC at every public function. The stock torch ops
run on the NCHW view ``x.permute(0, 3, 1, 2)``, which for a contiguous
NHWC tensor is a ``channels_last`` tensor that cuDNN takes without a
copy; the result is permuted back, again without a copy.

Under -spatial (`mgtpu_torch.parallel.axis`) the pools take H-slabs: a
2x2/2 or r x r/r pool of a slab of whole windows is local, the stem's
3x3/2 max pool takes one halo row above (the max's identity, -inf, at
the image's top); each output is brought to the rule's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mgtpu_torch.ops.cuda_pool import maxpool2, maxpool2_group
from mgtpu_torch.parallel import axis


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC. A no-copy view when ``x`` is
    channels_last, as the stock ops return for a channels_last input."""
    return x.permute(0, 2, 3, 1).contiguous()


def _whole_windows(x: torch.Tensor, r: int) -> torch.Tensor:
    """``x``, gathered if it is an H-slab whose rows do not hold whole
    r-row windows."""
    return axis.gather_h(x) if axis.rows(x) is not None and x.shape[1] % r else x


def _pooled(x: torch.Tensor, y: torch.Tensor, r: int) -> torch.Tensor:
    """A pool's output ``y`` of ``x`` (by ``r``) in the rule's layout."""
    g = axis.rows(x)
    return y if g is None else axis.canonical(axis.mark(y, -(-g // r)))


def maxpool2_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with ceil semantics: a window that runs past the
    bottom or right edge is clipped, as the JAX version's -inf padding
    does. Its gradient goes to the first tied element of a window, as
    XLA's SelectAndScatter gives the JAX version's. On a CUDA tensor
    this launches the hand-written kernels."""
    x = _whole_windows(x, 2)
    return _pooled(x, maxpool2(x, ties="first"), 2)


def maxpool2_ceil_group(xs) -> tuple:
    """``maxpool2_ceil`` of each tensor of ``xs``, as one group: a
    multigrid layer's pools, whose backward is one launch on the card."""
    xs = tuple(_whole_windows(x, 2) for x in xs)
    return tuple(_pooled(x, y, 2) for x, y in zip(xs, maxpool2_group(xs, ties="first")))


def maxpool2_floor(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with floor semantics (the U-Net's pool): a last row
    or column without a partner is dropped. That is ``maxpool2_ceil``
    of the map cropped to even sides, so every shape goes to the
    hand-written kernels on a CUDA tensor."""
    x = _whole_windows(x, 2)
    h, w = x.shape[1:3]
    if h % 2 or w % 2:
        x = x[:, :h - h % 2, :w - w % 2].contiguous()
    return maxpool2_ceil(x)


def maxpool(x: torch.Tensor, k: int, s: int, pad: int = 0) -> torch.Tensor:
    """General max pool, floor semantics (the 3x3/2 pad-1 stem pool).
    Padding is -inf, as in the JAX ``reduce_window``. On an H-slab: the
    halo rows its windows need (-inf at the image's edges), W padded
    alone."""
    g = axis.rows(x)
    if g is not None and (x.shape[1] % s or (g + 2 * pad - k) // s + 1 != g // s):
        x, g = axis.gather_h(x), None
    if g is None:
        return nhwc(F.max_pool2d(nchw(x), k, s, pad))
    top, bottom = axis.window_rows(k, s, pad)
    xh = axis.halo(x, top, bottom, fill=float("-inf"))[0]
    return _pooled(x, nhwc(F.max_pool2d(nchw(xh), k, s, (0, pad))), s)


def avgpool(x: torch.Tensor, r: int, s: int | None = None) -> torch.Tensor:
    """r x r / s average pool, VALID, accumulated in f32 and returned in
    ``x.dtype``.

    The 2x2/2 pool (the input pyramid) adds its four taps a, b (top row)
    and c, d (bottom row) in the order XLA's reshape-mean takes in
    `mgtpu.ops.resample.avgpool` on the CPU, eager and jitted alike, then
    divides by 4. That order depends on the row: (a + b) + (c + d) where
    W*C is a power of two (XLA vectorizes the row), ((a + b) + c) + d
    elsewhere (a numpy probe of every order over batches 1-64, sizes 2-224
    and C 1-64: the cluttered-MNIST pyramids take the first, the 3-channel
    images the second). Each add and the divide is one IEEE operation, so
    the CPU and the card give the JAX version's bits; a reduction
    (``mean``) sums in an order of its own on each device, one ulp off,
    which is enough to flip an int8 quantize tie downstream. An H-slab
    whose rows hold whole windows is pooled where it lies."""
    s = r if s is None else s
    if axis.rows(x) is not None:  # an H-slab: local where its rows hold whole windows
        x = _whole_windows(x, r) if s == r else axis.gather_h(x)
        if axis.rows(x) is not None:
            return _pooled(x, _avgpool(x, r, s, whole=False), r)
    return _avgpool(x, r, s)


def _avgpool(x: torch.Tensor, r: int, s: int, whole: bool = True) -> torch.Tensor:
    n, h, w, c = x.shape
    xf = x.float()
    if whole and r == h and r == w:  # global (e.g. Avg(7,7) on 7x7)
        return xf.mean(dim=(1, 2), keepdim=True).to(x.dtype)
    if s == r == 2 and h % 2 == 0 and w % 2 == 0:
        t = xf.reshape(n, h // 2, 2, w // 2, 2, c)
        a, b, c_, d = t[:, :, 0, :, 0], t[:, :, 0, :, 1], t[:, :, 1, :, 0], t[:, :, 1, :, 1]
        y = (a + b) + (c_ + d) if (w * c) & (w * c - 1) == 0 else ((a + b) + c_) + d
        return (y / 4).to(x.dtype)
    if s == r and h % r == 0 and w % r == 0:
        y = xf.reshape(n, h // r, r, w // r, r, c).mean(dim=(2, 4))
        return y.to(x.dtype)
    return nhwc(F.avg_pool2d(nchw(xf), r, s)).to(x.dtype)


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H, W -> (N, C), as ``jnp.mean`` takes it: a low-precision
    input summed and divided in f32, the mean returned in ``x.dtype``."""
    return x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(1, 2)).to(x.dtype)


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
