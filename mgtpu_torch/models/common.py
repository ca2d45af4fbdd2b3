"""Shared model heads and the pyramid network wrapper (counterpart of
`mgtpu/models/common.py`)."""

from __future__ import annotations

import torch
from torch import nn

from mgtpu_torch.nn import Dense, Sequential
from mgtpu_torch.ops.resample import avgpool


class LogSoftmaxClassifier(nn.Module):
    """The finest pyramid scale -> [AvgPool a x a] -> flatten (NHWC
    order) -> Dense -> log-softmax, computed in f32."""

    def __init__(self, c_in, n_classes, pool=0, compute_dtype=None, device=None,
                 generator=None):
        super().__init__()
        self.pool = pool
        self.dense = Dense(c_in, n_classes, compute_dtype=compute_dtype,
                           device=device, generator=generator)

    def forward(self, pyr):
        x = pyr[0]
        if self.pool:
            x = avgpool(x, self.pool, 1)
        y = self.dense(x.reshape(x.shape[0], -1))
        return torch.log_softmax(y.float(), dim=-1)


class MgNet(nn.Module):
    """Pyramid network: the stem takes the image, body blocks map
    pyramid -> pyramid, the head maps pyramid -> output."""

    def __init__(self, blocks):
        super().__init__()
        self.seq = Sequential(blocks)

    def forward(self, x):
        return self.seq(x)
