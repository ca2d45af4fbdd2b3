"""Where the multigrid exchange sums its parts: in eval mode a 3x3
exchange conv adds each part into the running sum in the `conv3x3`
kernel's epilogue (`ConvBN.conv_parts`'s ``y_in``), and a folded conv's
ReLU and a residual layer's shortcut go into its last launch; in train
mode the parts are summed by stock adds, as before. On the CPU: the
stock elementwise ops of a folded eval forward of R-MG-34 and PR-MG-30,
by the call site in the port that made them (ops inside the kernels'
plain versions are the kernels' own work on a card, not stock passes),
the served log-probs against the stock sums', and the op sequence of a
train-mode forward against its pin."""

import collections
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mgtpu_torch import nn as tnn
from mgtpu_torch.models import create_model
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.ops.mg import MgResidual
from mgtpu_torch.serve import Server
from test_torch_cifar_models import few_torch_threads  # noqa: F401

PKG = Path(tnn.__file__).resolve().parent
NETS = {"rmg34": NetOpts(), "prmg30": NetOpts(netType="ilsvrc/prnmgseg", depth=30,
                                              shortcutType="A")}
# the benchmark's bf16 serving limits of the widest row's relative
# log-prob error (portbench's logit_err, the serve cells of the two nets)
SERVE_LIMIT = {"rmg34": 0.025, "prmg30": 0.05}
ELEMENTWISE = {"add", "add_", "relu", "relu_"}


class StockOps(TorchDispatchMode):
    """Counts (op, file, function) of each add and ReLU made by the
    port's model code: the innermost frame in the package that is not the
    kernels' plain versions (ops/cuda_conv.py), whose ops are a kernel's
    own work on the card."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ELEMENTWISE:
            f = sys._getframe(1)
            while f is not None and not f.f_code.co_filename.startswith(str(PKG)):
                f = f.f_back
            path = Path(f.f_code.co_filename).relative_to(PKG).as_posix() if f else "?"
            if path != "ops/cuda_conv.py":
                self.counts[(name, path, f.f_code.co_name if f else "?")] += 1
        return func(*args, **(kwargs or {}))


def _logit_error(got, ref):
    """portbench's logit_err: the widest row's relative error of log-probs,
    each row centred first."""
    d = got.double() - ref.double()
    d = d - d.mean(1, keepdim=True)
    r = ref.double() - ref.double().mean(1, keepdim=True)
    return float((d.norm(dim=1) / r.norm(dim=1)).max())


def _residual_scales_with_up(model):
    return sum(len(m.stage2) - 1 for m in model.modules() if isinstance(m, MgResidual))


@pytest.mark.parametrize("net", sorted(NETS))
def test_folded_eval_forward_sums_parts_in_the_kernels(net, monkeypatch):
    """A bf16 folded eval forward at batch 1: no stock part-sum add, no
    stock ReLU after a 3x3 conv and no residual add and ReLU are left,
    but the 7x7 stems' bias adds and ReLUs (stock convs: 3 scales in
    R-MG-34, 4 in PR-MG-30) and one add of the up part and the shortcut
    for each residual scale that has an up part (all but the coarsest).
    Before, R-MG-34 made 80 part-sum adds, 36 residual adds and 36 + 36
    ReLUs of 3x3 convs; PR-MG-30 120, 42 + 2 (two single-grid residual
    blocks) and 44 + 42 + 2. The log-probs stay within the serving limit
    of the stock sums'."""
    opt = NETS[net]
    server = Server(opt, seed=0, device="cpu", compute_dtype=torch.bfloat16)
    x = np.random.default_rng(1).standard_normal((1, 224, 224, 3), dtype=np.float32)
    with StockOps() as ops:
        got = server.predict(x)
    # each up part's 4x4 weight, built from its 3x3 slice: weights, not activations
    ops.counts.pop(("add_", "nn.py", "_conv_up3"))
    stems = len(server.model.seq.layers[0].convs)
    ups = _residual_scales_with_up(server.model)
    want = {("add", "nn.py", "conv_parts"): stems + ups,  # the stems' biases; up + shortcut
            ("relu", "nn.py", "_tail"): stems,
            ("add", "nn.py", "forward"): 1,  # the classifier's bias (Dense)
            ("add", "ops/resample.py", "_avgpool"): 3 * (stems - 1)}  # the input pyramid
    assert dict(ops.counts) == want
    monkeypatch.setattr(tnn.ConvBN, "sums_in_kernel", property(lambda self: False))
    with StockOps() as ops:
        stock = server.predict(x)
    assert ops.counts[("add", "nn.py", "apply_parts")] > 0  # the stock path ran
    assert _logit_error(got, stock) < SERVE_LIMIT[net]


# a train-mode forward's aten ops at batch 1 (seeded init, 224 px): their
# count and the sha256 of their names in order, as before the eval path
# summed in the kernels (the train path runs the same ops in the same order)
TRAIN_OPS = {"rmg34": (4323, "c7eb22c233061161"), "prmg30": (5765, "44acd86f32010efa")}


class OpSequence(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("net", sorted(NETS))
def test_train_forward_runs_the_stock_ops(net):
    model = create_model(NETS[net], generator=torch.Generator().manual_seed(1)).train()
    x = torch.randn(1, 224, 224, 3, generator=torch.Generator().manual_seed(2))
    with OpSequence() as seq:
        model(x)
    digest = hashlib.sha256("\n".join(seq.ops).encode()).hexdigest()[:16]
    assert (len(seq.ops), digest) == TRAIN_OPS[net]


def test_folded_residual_layer_exports():
    """A folded eval residual layer (the shortcut and the outer ReLU in the
    last conv3x3 launch; shortcut type A widens one scale) exports through
    `torch.export` (the ops ``mgtpu::conv3x3`` with their ``y_in``) and
    runs as the eager call."""
    from mgtpu_torch.ops.fold import fold_batchnorm

    layer = fold_batchnorm(MgResidual([4, 8, 8], [8, 8, 8], shortcut_type="A",
                                      generator=torch.Generator().manual_seed(3))).eval()
    g = torch.Generator().manual_seed(4)
    pyr = tuple(torch.randn((2, s, s, c), generator=g) for s, c in ((8, 4), (4, 8), (2, 8)))
    program = torch.export.export(layer, (pyr,))
    assert sum("mgtpu.conv3x3" in str(n.target) for n in program.graph.nodes) > 0
    with torch.no_grad():
        for got, want in zip(program.module()(pyr), layer(pyr)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
