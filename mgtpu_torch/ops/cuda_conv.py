"""3x3/s1/p1 NHWC conv with a bias, optional ReLU and an optional
per-channel (sum, sum of squares) epilogue: the CUDA kernel's wrapper
and its plain version.

Port of `mgtpu/ops/pallas_conv.py::conv3x3` (its ``rows`` and ``slab``
variants compute the same function); the signature drops ``variant``,
``th`` and ``interpret``. The kernel is `mgtpu_torch/csrc/conv3x3.cu`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mgtpu_torch import kernels
from mgtpu_torch.ops.resample import nchw, nhwc

_DTYPES = (torch.float32, torch.bfloat16)


def conv3x3_plain(x, w, b, *, relu_out=False, with_stats=True):
    """Stock-torch version, the same formula as ``xla_conv3x3``:
    y = conv(x, w) + b in ``x.dtype`` [ReLU]; stats (2, Co) f32 of y."""
    y = nhwc(F.conv2d(nchw(x), w.permute(3, 2, 0, 1), b.to(x.dtype), padding=1))
    y = y.contiguous()
    if relu_out:
        y = torch.relu(y)
    co = w.shape[3]
    if with_stats:
        yf = y.float()
        stats = torch.stack([yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))])
    else:
        stats = torch.zeros((2, co), dtype=torch.float32, device=x.device)
    return y, stats


def conv3x3(x, w, b, *, relu_out=False, with_stats=True):
    """x (N, H, W, Ci) NHWC; w (3, 3, Ci, Co) HWIO; b (Co,) f32.
    Returns (y (N, H, W, Co) in x.dtype, stats (2, Co) f32, zeros when
    ``with_stats`` is False). The f32 accumulator starts at the bias;
    stats sum the f32 values after the ReLU and before the cast.

    ``w`` may be a slice of a wider HWIO weight along its input
    channels (a view), as the multigrid exchange passes it.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu_out=relu_out, with_stats=with_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        raise NotImplementedError(
            "conv3x3: the CUDA kernel is forward-only; the backward kernels "
            "come with the training step (ROADMAP Queue 1 item 4)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3: dtype {x.dtype} not in {_DTYPES}")
    if w.dtype != x.dtype or b.dtype != torch.float32:
        raise TypeError(f"conv3x3: needs w in x.dtype ({x.dtype}) and an f32 bias, "
                        f"got w {w.dtype}, b {b.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"conv3x3: needs a contiguous NHWC x, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    n, h, wd, ci = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"conv3x3: w shape {tuple(w.shape)} is not (3, 3, {ci}, Co)")
    co = w.shape[3]
    # rows of (ci, co) contiguous per tap; taps evenly spaced: a dense HWIO
    # weight or its slice along the input channels
    if not (w.stride(3) == 1 and w.stride(2) == co and w.stride(0) == 3 * w.stride(1)):
        raise ValueError(f"conv3x3: w strides {w.stride()} are not an HWIO "
                         f"input-channel slice")
    if b.shape != (co,) or not b.is_contiguous():
        raise ValueError(f"conv3x3: b shape {tuple(b.shape)} is not ({co},)")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3x3: x, w and b must be on one device")
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    stats = torch.zeros((2, co), dtype=torch.float32, device=x.device)
    if y.numel():
        kernels.launch("conv3x3", "mg_conv3x3", x.device, x.data_ptr(), w.data_ptr(),
                       b.data_ptr(), y.data_ptr(), stats.data_ptr(),
                       n, h, wd, ci, co, w.stride(1), int(relu_out),
                       int(with_stats), int(x.dtype == torch.bfloat16))
    return y, stats
