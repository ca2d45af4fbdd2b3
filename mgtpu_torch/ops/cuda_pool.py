"""2x2/2 max pool, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd Function that joins them.

Port of `mgtpu/ops/pallas_pool.py::maxpool2_pallas`: its forward
(`_pool_fwd_call`) and its custom VJP (`_pool_bwd`). Both kernels are in
`mgtpu_torch/csrc/maxpool2.cu` and compute ceil mode for every H and W,
so they serve ``maxpool2_ceil`` wherever the model calls it; the Pallas
kernels took even sizes only.

The backward has two tie rules for a window whose max several elements
share. ``ties="all"`` is the Pallas kernel's: every tied element gets
the cotangent (sum(dx) = k*g for k ties). ``ties="first"`` gives it to
the first tied element in row-major window order only, as XLA's
SelectAndScatter does for `mgtpu/ops/resample.py::maxpool2_ceil`, which
the JAX model zoo trains with (and as torch's ``max_pool2d`` does).
``maxpool2`` defaults to the Pallas rule, the port of
``maxpool2_pallas``; the model's ``maxpool2_ceil`` takes the first-tie
rule, the port of the zoo's pool, because on R-MG-34 positive ties are
common: the stem's overlapping 3x3/2 max pool copies one maximum into
neighbouring outputs, which block 1's 2x2 down-pool then sees tied.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mgtpu_torch import kernels

_DTYPES = (torch.float32, torch.bfloat16)


def maxpool2_plain(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2/2 ceil-mode max pool with stock torch (NaN propagates)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _up2(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Each element of ``t`` over its 2x2 window, cropped to (h, w)."""
    return t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :h, :w]


_TIES = ("all", "first")


def _check_ties(ties: str) -> None:
    if ties not in _TIES:
        raise ValueError(f"maxpool2: ties={ties!r} not in {_TIES}")


def _first_in_window(hit: torch.Tensor) -> torch.Tensor:
    """hit (N, H, W, C) bool -> only its first True in each 2x2 window,
    in row-major window order (clipped windows at odd edges)."""
    n, h, w, c = hit.shape
    oh, ow = -(-h // 2), -(-w // 2)
    win = torch.zeros((n, oh, 2, ow, 2, c), dtype=torch.bool, device=hit.device)
    win.view(n, 2 * oh, 2 * ow, c)[:, :h, :w] = hit
    taken = torch.zeros((n, oh, ow, c), dtype=torch.bool, device=hit.device)
    for a in (0, 1):
        for b in (0, 1):
            win[:, :, a, :, b] &= ~taken
            taken |= win[:, :, a, :, b]
    return win.view(n, 2 * oh, 2 * ow, c)[:, :h, :w]


def maxpool2_bwd_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                       ties: str = "all") -> torch.Tensor:
    """dx = where(x == y[window], g[window], 0) with stock torch; with
    ``ties="first"`` only the first tied element of a window gets g. A
    NaN never equals, so a NaN window gets 0. ``g`` is cast to x.dtype
    first, as in the Pallas backward."""
    _check_ties(ties)
    h, w = x.shape[1], x.shape[2]
    hit = x == _up2(y, h, w)
    if ties == "first":
        hit = _first_in_window(hit)
    g = g.to(x.dtype)
    return torch.where(hit, _up2(g, h, w), torch.zeros((), dtype=x.dtype, device=x.device))


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not in {_DTYPES}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous NHWC tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")


def maxpool2_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward alone. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return maxpool2_plain(x)
    _check("maxpool2", x)
    n, h, w, c = x.shape
    y = torch.empty((n, -(-h // 2), -(-w // 2), c), dtype=x.dtype, device=x.device)
    if y.numel():
        kernels.launch("maxpool2", "mg_maxpool2", x.device, x.data_ptr(), y.data_ptr(),
                       n, h, w, c, int(x.dtype == torch.bfloat16))
    return y


def maxpool2_backward(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                      ties: str = "all") -> torch.Tensor:
    """dx of the pool under the tie rule ``ties``. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return maxpool2_bwd_plain(x, y, g, ties)
    _check_ties(ties)
    _check("maxpool2_bwd", x)
    n, h, w, c = x.shape
    g = g.to(x.dtype).contiguous()
    pooled = (n, -(-h // 2), -(-w // 2), c)
    for name, t in (("y", y), ("g", g)):
        _check("maxpool2_bwd", t)
        if tuple(t.shape) != pooled or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"maxpool2_bwd: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {pooled} {x.dtype} on {x.device}")
    dx = torch.empty_like(x)
    if dx.numel():
        kernels.launch("maxpool2_bwd", "mg_maxpool2_bwd", x.device, x.data_ptr(), y.data_ptr(),
                       g.data_ptr(), dx.data_ptr(), n, h, w, c, int(ties == "first"),
                       int(x.dtype == torch.bfloat16))
    return dx


class _MaxPool2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ties):
        y = maxpool2_forward(x)
        ctx.ties = ties
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return maxpool2_backward(x, y, g, ctx.ties), None


def maxpool2(x: torch.Tensor, ties: str = "all") -> torch.Tensor:
    """NHWC 2x2/2 ceil-mode max pool, differentiable under the tie rule
    ``ties`` ("all", the Pallas kernel's, or "first"). CPU tensors take
    the plain versions; CUDA tensors launch the kernels or raise."""
    _check_ties(ties)
    return _MaxPool2.apply(x, ties)
