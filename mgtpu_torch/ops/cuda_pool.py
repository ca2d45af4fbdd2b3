"""2x2/2 max pool, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd Function that joins them.

Port of `mgtpu/ops/pallas_pool.py::maxpool2_pallas`: its forward
(`_pool_fwd_call`) and its custom VJP (`_pool_bwd`). Both kernels are in
`mgtpu_torch/csrc/maxpool2.cu` and compute ceil mode for every H and W,
so they serve ``maxpool2_ceil`` wherever the model calls it; the Pallas
kernels took even sizes only. The forward has two designs, ``sm90``
(bulk asynchronous copies into a shared-memory ring, 16-byte lanes) and
``simple`` (one thread an element); :func:`_route` picks one from dtype,
shape and alignment alone. It is not a fallback: a launch that fails
raises.

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

import functools

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


# the most one stage of the sm90 design's ring holds: K row pairs of
# 2*W*C elements must fit in it. Passed with each launch, which
# maxpool2.cu refuses unless it is its own sm90::STAGE_BYTES
SM90_STAGE_BYTES = 32768


def _route(x: torch.Tensor) -> str:
    """The design a CUDA launch of the forward on ``x`` takes: "sm90" for
    an even H, C*itemsize a multiple of 16 (the 16-byte lanes), x on a
    16-byte boundary (the bulk copies' rule; y is allocated by the
    wrapper and always is) and one row pair, 2*W*C*itemsize bytes, within
    a stage; "simple" for the rest. That takes every pool of R-MG-34 in
    bf16 and f32 to sm90. An odd W is taken: the clipped last window of a
    row reads its left column again, which cannot change the max. An odd
    H is not: its last row has no partner, which breaks the flat stream
    of row pairs the design copies. A fixed function of dtype, shape and
    alignment: a launch on either route that fails raises."""
    n, h, w, c = x.shape
    row_pair = 2 * w * c * x.element_size()
    # fewer than 2**31 - 2**15 row pairs: the kernel counts chunks in 32 bits
    if (h % 2 == 0 and c * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
            and 0 < row_pair <= SM90_STAGE_BYTES and 0 < n * h // 2 < 2**31 - 2**15):
        return "sm90"
    return "simple"


@functools.cache
def _plan(n: int, h: int, w: int, c: int, itemsize: int, sms: int) -> tuple[int, int]:
    """(K, grid) of an sm90 launch: K consecutive row pairs a chunk (a
    stage holds one chunk), and the blocks, at most one an SM, that walk
    chunks b, b + grid, ... Picks the K that gives the busiest block the
    fewest row pairs (the larger K on a tie: fewer, larger copies).
    Cached: the serving path is host-bound, and a model pools at a few
    shapes."""
    pairs = n * h // 2
    best = None
    for k in range(1, SM90_STAGE_BYTES // (2 * w * c * itemsize) + 1):
        chunks = -(-pairs // k)
        grid = min(chunks, sms)
        span = -(-chunks // grid) * k
        if best is None or span <= best[0]:
            best = (span, k, grid)
    return best[1], best[2]


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x: torch.Tensor, route: str) -> torch.Tensor:
    n, h, w, c = x.shape
    y = torch.empty((n, -(-h // 2), -(-w // 2), c), dtype=x.dtype, device=x.device)
    if not y.numel():
        return y
    bf16 = int(x.dtype == torch.bfloat16)
    if route == "sm90":
        k, grid = _plan(n, h, w, c, x.element_size(), _sms(x.device.index))
        kernels.launch("maxpool2", "mg_maxpool2_sm90", x.device, x.data_ptr(), y.data_ptr(),
                       n, h, w, c, k, grid, SM90_STAGE_BYTES, bf16, route=route)
    else:
        kernels.launch("maxpool2", "mg_maxpool2", x.device, x.data_ptr(), y.data_ptr(),
                       n, h, w, c, bf16, route=route)
    return y


def maxpool2_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward alone. CPU tensors take the plain version; CUDA
    tensors launch the kernel (the design :func:`_route` picks) or
    raise."""
    if x.device.type == "cpu":
        return maxpool2_plain(x)
    _check("maxpool2", x)
    return _launch(x, _route(x))


def _simple_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward through the simple design at any shape, on a CUDA
    tensor. Private: only for holding the two designs against each other
    and timing them at one shape (chip_smoke.py, tests/test_torch_cuda.py)."""
    _check("maxpool2", x)
    return _launch(x, "simple")


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
