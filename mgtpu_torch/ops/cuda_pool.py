"""2x2/2 max pool: the CUDA kernel's wrapper and its plain version.

Port of `mgtpu/ops/pallas_pool.py::maxpool2_pallas` (forward only). The
kernel (`mgtpu_torch/csrc/maxpool2.cu`) computes ceil mode for every H
and W, so it serves ``maxpool2_ceil`` wherever the model calls it; the
Pallas kernel took even sizes only.
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


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2/2 ceil-mode max pool. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return maxpool2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool2: unsupported device {x.device}")
    if x.requires_grad:
        raise NotImplementedError(
            "maxpool2: the CUDA kernel is forward-only; its backward is "
            "ROADMAP Queue 2 item 3 (pool backward with the tie rule)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"maxpool2: dtype {x.dtype} not in {_DTYPES}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"maxpool2: needs a contiguous NHWC tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    n, h, w, c = x.shape
    y = torch.empty((n, -(-h // 2), -(-w // 2), c), dtype=x.dtype, device=x.device)
    if y.numel():
        kernels.launch("maxpool2", "mg_maxpool2", x.device, x.data_ptr(), y.data_ptr(),
                       n, h, w, c, int(x.dtype == torch.bfloat16))
    return y
