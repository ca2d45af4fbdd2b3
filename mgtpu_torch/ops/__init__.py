"""The port's ops (counterpart of `mgtpu/ops/`)."""

from mgtpu_torch.ops.resample import global_avgpool
