"""Which design of the port's 3x3 convs a CUDA launch takes
(`mgtpu_torch.ops.cuda_conv._route`): "sm90" (TMA + wgmma), "window" or,
for f32 under ``torch.backends.cudnn.allow_tf32``, "window_tf32" (the
first design, "tile", is launched only through `_tile_forward`).

The route is a fixed function of dtype, shape and alignment, so it is
checked here on the CPU: against the kernel calls of one R-MG-34
serving forward and one training step, recorded with the plain path as
``chip_smoke.py`` records them (and as it then checks the card's launch
counts against), and against operands the sm90 design does not take.
"""

import pytest
import torch

from chip_smoke import (PER_FORWARD, PER_STEP, SEG_PER_FORWARD, misaligned, predicted_routes,
                        record_kernel_shapes)
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.ops.cuda_conv import _route

# the four largest shapes (H, W, Ci, Co): 24-29 GFLOP each at batch 128
LARGE = [(14, 14, 256, 256), (28, 28, 128, 128), (56, 56, 64, 64), (7, 7, 512, 512)]


@pytest.fixture(scope="module")
def recorded():
    """{"serve" | "train": {kernel: Counter of (H, W, Ci, Co)}}"""
    return {"serve": record_kernel_shapes(False), "train": record_kernel_shapes(True)}


def _operands(ci, co, dtype=torch.bfloat16):
    return torch.empty((1, 3, 3, ci), dtype=dtype), torch.empty((3, 3, ci, co), dtype=dtype)


def _aligned64(shape):
    return shape[2] % 64 == 0 and shape[3] % 64 == 0


@pytest.mark.parametrize("pass_, kernel, at_least", [("serve", "conv3x3", 70),
                                                     ("train", "conv3x3_bn_relu_in", 26)])
def test_route_sends_the_wide_convs_of_rmg34_to_sm90(recorded, pass_, kernel, at_least):
    shapes = recorded[pass_][kernel]
    assert sum(shapes.values()) == (PER_FORWARD if pass_ == "serve" else PER_STEP)[kernel]
    wide = sum(n for s, n in shapes.items() if _aligned64(s))
    assert wide >= at_least
    routes = predicted_routes(recorded[pass_])
    # exactly the calls with Ci, Co % 64 == 0 go to sm90, in bf16
    assert routes[(kernel, "sm90")] == wide
    assert routes[(kernel, "window")] == sum(shapes.values()) - wide
    assert routes[(kernel, "tile")] == 0
    for (h, w, ci, co) in shapes:
        assert _route(*_operands(ci, co)) == ("sm90" if ci % 64 == 0 and co % 64 == 0
                                              else "window")


@pytest.mark.parametrize("pass_, kernel", [("serve", "conv3x3"), ("train", "conv3x3"),
                                           ("train", "conv3x3_bn_relu_in")])
@pytest.mark.parametrize("shape", LARGE)
def test_route_takes_the_large_shapes_to_sm90(recorded, pass_, kernel, shape):
    assert recorded[pass_][kernel][shape] > 0
    assert _route(*_operands(*shape[2:])) == "sm90"


def test_route_counts_per_pass(recorded):
    """The counts chip_smoke.py holds the card's launches to (the pool's
    are tests/test_torch_pool_route.py's)."""
    assert predicted_routes(recorded["serve"]) == {
        ("conv3x3", "sm90"): 70, ("conv3x3", "window"): 42, ("conv3x3", "window_tf32"): 0,
        ("conv3x3", "tile"): 0,
        ("conv3x3_bn_relu_in", "sm90"): 0, ("conv3x3_bn_relu_in", "window"): 0,
        ("conv3x3_bn_relu_in", "window_tf32"): 0, ("conv3x3_bn_relu_in", "tile"): 0,
        ("maxpool2", "sm90"): 46, ("maxpool2", "simple"): 0,
        ("conv_i8", "sm90"): 0, ("conv_i8", "stem"): 0, ("conv_i8", "1x1"): 0,
        ("conv_i8", "simple"): 0,
        ("maxpool2_bwd", "group"): 0, ("maxpool2_bwd", "simple"): 0,
        ("quant_i8", "group"): 0, ("quant_i8", "part"): 0}
    assert predicted_routes(recorded["train"]) == {
        ("conv3x3", "sm90"): 44, ("conv3x3", "window"): 32, ("conv3x3", "window_tf32"): 0,
        ("conv3x3", "tile"): 0,
        ("conv3x3_bn_relu_in", "sm90"): 26, ("conv3x3_bn_relu_in", "window"): 10,
        ("conv3x3_bn_relu_in", "window_tf32"): 0, ("conv3x3_bn_relu_in", "tile"): 0,
        ("maxpool2", "sm90"): 46, ("maxpool2", "simple"): 0,
        ("conv_i8", "sm90"): 0, ("conv_i8", "stem"): 0, ("conv_i8", "1x1"): 0,
        ("conv_i8", "simple"): 0,
        ("maxpool2_bwd", "group"): 29, ("maxpool2_bwd", "simple"): 0,
        ("quant_i8", "group"): 0, ("quant_i8", "part"): 0}


@pytest.mark.parametrize("net", ["ilsvrc/rnmg", "mnist-cluttered/unmg"])
def test_eval_forward_makes_the_serving_calls(recorded, net):
    """The run loop's test forward (BN not folded, eval mode) makes the
    serving forward's kernel calls at the same shapes: chip_smoke.py holds
    the launches of a recipe's test pass to PER_FORWARD / SEG_PER_FORWARD
    a batch."""
    if net == "ilsvrc/rnmg":
        got, want, serve = record_kernel_shapes(False, fold=False), PER_FORWARD, recorded["serve"]
    else:
        opt = NetOpts(netType=net, dataset="mnist-seg")
        got, want = record_kernel_shapes(False, opt, fold=False), SEG_PER_FORWARD[net]
        serve = record_kernel_shapes(False, opt)
    assert {k: sum(c.values()) for k, c in got.items()} == want
    assert got == serve


@pytest.mark.parametrize("case", ["f32", "f32_wide", "x_misaligned", "w_misaligned",
                                  "ci_96", "ci_32", "co_32", "co_130", "ci_4096"])
def test_route_keeps_the_rest_on_the_tile_design(case):
    ci, co, dtype = 64, 128, torch.bfloat16
    if case.startswith("ci_"):
        ci = int(case[3:])
    elif case.startswith("co_"):
        co = int(case[3:])
    elif case.startswith("f32"):
        dtype = torch.float32
        ci = co = 256 if case == "f32_wide" else 64
    x, w = _operands(ci, co, dtype)
    if case.endswith("misaligned"):
        assert _route(x, w) == "sm90"  # aligned, the same operands take sm90
        x, w = (misaligned(x), w) if case == "x_misaligned" else (x, misaligned(w))
    old = torch.backends.cudnn.allow_tf32
    try:
        # f32 follows PyTorch's conv switch: its FMA branch without TF32,
        # the TF32 branch with it; bf16 ignores the switch
        torch.backends.cudnn.allow_tf32 = False
        assert _route(x, w) == "window"
        torch.backends.cudnn.allow_tf32 = True
        assert _route(x, w) == ("window_tf32" if dtype == torch.float32 else "window")
    finally:
        torch.backends.cudnn.allow_tf32 = old


def test_route_takes_an_aligned_weight_slice():
    """The exchange passes input-channel slices of a wider weight: a slice
    starting at a multiple of Co elements stays on 16-byte boundaries."""
    x, w = _operands(64, 128)
    wide = torch.empty((3, 3, 192, 128), dtype=torch.bfloat16)
    assert _route(x, wide[:, :, 64:128, :]) == "sm90"
