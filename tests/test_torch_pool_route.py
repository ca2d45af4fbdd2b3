"""Which design of the port's pool forward a CUDA launch takes
(`mgtpu_torch.ops.cuda_pool._route`: "sm90" or "simple"), how the sm90
design cuts the input into chunks (`_plan`), and the bounds that
``chip_smoke.py`` holds the kernels' times against.

The route and the plan are fixed functions of dtype, shape, alignment
and the card's SM count, so they are checked here on the CPU: against
the pool calls of one R-MG-34 serving forward and one training step,
recorded with the plain path as ``chip_smoke.py`` records them, and
against inputs the sm90 design does not take. A numpy walk of the sm90
kernel's chunks and index math (`mgtpu_torch/csrc/maxpool2.cu`, section
"sm90") checks that they select the plain version's values. The kernel
refuses a launch planned for another stage size than its own.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (PER_FORWARD, PER_STEP, RMG34_POOLS, bound, kernel_work, misaligned,
                        path_bounds, predicted_routes, record_kernel_shapes)
from mgtpu_torch.ops.cuda_pool import SM90_STAGE_BYTES, _plan, _route, maxpool2_plain

H100_SMS = 132
# odd sizes and a last chunk of fewer row pairs (40x14x14x16: 280 pairs,
# 3 a chunk on 132 SMs), (N, H, W, C)
ODD = [(2, 8, 9, 64), (40, 14, 14, 16), (3, 2, 1, 8), (1, 6, 7, 24), (5, 4, 3, 8)]


@pytest.fixture(scope="module")
def recorded():
    """{"serve" | "train": {kernel: Counter of shapes}}"""
    return {"serve": record_kernel_shapes(False), "train": record_kernel_shapes(True)}


def _x(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype)


@pytest.mark.parametrize("pass_", ["serve", "train"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_sends_every_rmg34_pool_to_sm90(recorded, pass_, dtype):
    shapes = recorded[pass_]["maxpool2"]
    assert sum(shapes.values()) == (PER_FORWARD if pass_ == "serve" else PER_STEP)["maxpool2"]
    assert sorted(shapes) == RMG34_POOLS
    for shape in shapes:
        assert _route(_x((1, *shape), dtype)) == "sm90"
        assert _route(_x((128, *shape), dtype)) == "sm90"
    routes = predicted_routes(recorded[pass_])
    assert (routes[("maxpool2", "sm90")], routes[("maxpool2", "simple")]) == (46, 0)


@pytest.mark.parametrize("case, shape, dtype", [
    ("odd_h", (2, 7, 8, 64), torch.bfloat16),
    ("odd_h_f32", (2, 15, 14, 64), torch.float32),
    ("c_8_bytes", (2, 8, 8, 4), torch.bfloat16),
    ("c_24_bytes", (2, 8, 8, 12), torch.bfloat16),
    ("c_8_bytes_f32", (2, 8, 8, 2), torch.float32),
    ("misaligned", (2, 8, 8, 64), torch.bfloat16),
    ("row_pair_wider_than_a_stage", (1, 4, 300, 64), torch.bfloat16),
    ("row_pair_wider_than_a_stage_f32", (1, 4, 150, 64), torch.float32),
])
def test_route_keeps_the_rest_on_the_simple_design(case, shape, dtype):
    x = _x(shape, dtype)
    if case == "misaligned":
        assert _route(x) == "sm90"  # aligned, the same shape takes sm90
        x = misaligned(x)
    assert _route(x) == "simple"


@pytest.mark.parametrize("shape", ODD[:2] + [(1, 4, 128, 64)])
def test_route_takes_odd_w_and_a_full_stage_to_sm90(shape):
    # 4x128x64 bf16: a row pair of exactly one stage (32 KB)
    assert _route(_x(shape)) == "sm90"


def _walk(n, h, w, c, itemsize, sms):
    """The chunks each block of an sm90 launch walks, as the kernel walks
    them: [(block, first row pair, row pairs)]"""
    k, grid = _plan(n, h, w, c, itemsize, sms)
    pairs = n * h // 2
    chunks = -(-pairs // k)
    return k, grid, [(b, ch * k, min(k, pairs - ch * k))
                     for b in range(grid) for ch in range(b, chunks, grid)]


def _plan_cases():
    cases = [(n, *s) for n in (128, 8, 1) for s in RMG34_POOLS] + ODD + [(1, 4, 128, 64)]
    return [(shape, itemsize, sms) for shape in cases for itemsize in (2, 4)
            for sms in (H100_SMS, 7) if shape[3] * itemsize % 16 == 0
            and 2 * shape[2] * shape[3] * itemsize <= SM90_STAGE_BYTES]


@pytest.mark.parametrize("shape, itemsize, sms", _plan_cases())
def test_plan_fits_a_stage_and_covers_every_row_pair_once(shape, itemsize, sms):
    n, h, w, c = shape
    k, grid, walk = _walk(n, h, w, c, itemsize, sms)
    stage = 2 * k * w * c * itemsize
    assert 1 <= k and stage <= SM90_STAGE_BYTES
    # every output vector of a stage has a consumer thread: the kernel's
    # threads own STAGE_BYTES / 32 of them
    assert k * -(-w // 2) * c * itemsize // 16 <= SM90_STAGE_BYTES // 32
    assert 1 <= grid <= sms and len({b for b, _, _ in walk}) == grid
    covered = np.zeros(n * h // 2, dtype=int)
    for _, first, count in walk:
        assert 1 <= count <= k
        covered[first:first + count] += 1
    assert (covered == 1).all()


def test_plan_splits_the_large_shapes_into_stages_of_two_row_pairs():
    """At batch 128 bf16 a row pair of 56x56x64, 28x28x128 or 14x14x256 is
    14 KB; 14x14x256 has too few pairs for 132 blocks at two a chunk."""
    assert _plan(128, 56, 56, 64, 2, H100_SMS) == (2, 132)
    assert _plan(128, 28, 28, 128, 2, H100_SMS) == (2, 132)
    assert _plan(128, 14, 14, 256, 2, H100_SMS) == (1, 132)
    assert _plan(128, 14, 14, 16, 2, H100_SMS) == (7, 128)


def _pool_input(shape, dtype, seed):
    """chip_smoke.pool_input's values on the CPU, with signed zeros"""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    # and two windows whose max is a 0 tied with a -0: the first one wins
    x[0, :2, 1:2, 1:3] = -1.0
    x[0, :2, 0, 1] = 0.0, -0.0
    x[0, :2, 0, 2] = -0.0, 0.0
    x[0, 0, 0, 0] = np.nan
    x[0, -1, -1, -1] = np.inf
    x[-1, :2, :2, :] = -np.inf  # a window of -inf only
    x[-1, -1, -1, -1] = np.nan  # in a clipped edge window when W is odd
    return torch.from_numpy(x).to(dtype)


def _emulate_sm90(x, sms):
    """The sm90 kernel's walk in numpy: chunks by block, each stage's
    output vectors j with the kernel's offsets (top-left corner, right
    step 0 where the window is clipped, the bottom row one input row
    further), the corners in row-major window order under take_max's
    rule. Returns the selected elements of x."""
    n, h, w, c = x.shape
    v = 16 // x.element_size()
    cv, ow_n, row = c // v, -(-w // 2), w * c
    k, _, walk = _walk(n, h, w, c, x.element_size(), sms)
    vals = x.float().numpy().ravel()
    sel = np.full(n * h // 2 * ow_n * c, -1)
    for _, first, count in walk:
        j = np.arange(count * ow_n * cv)
        t, vec = np.divmod(j, cv)
        pair, ow = np.divmod(t, ow_n)
        off = first * 2 * row + ((2 * pair * w + 2 * ow) * cv + vec) * v
        right = np.where(2 * ow + 1 < w, cv * v, 0)
        for e in range(v):
            best = off + e
            for cand in (best + right, best + row, best + row + right):
                with np.errstate(invalid="ignore"):
                    b, cd = vals[best], vals[cand]
                    best = np.where(~np.isnan(b) & ((cd > b) | np.isnan(cd)), cand, best)
            out = (first * ow_n * cv + j) * v + e
            assert (sel[out] == -1).all()
            sel[out] = best
    assert (sel >= 0).all()
    return x.reshape(-1)[torch.from_numpy(sel)].reshape(n, h // 2, ow_n, c)


@pytest.mark.parametrize("shape", ODD + [(3, 14, 14, 16), (2, 28, 28, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sms", [H100_SMS, 5])
def test_emulated_sm90_walk_selects_the_plain_values(shape, dtype, sms):
    x = _pool_input(shape, dtype, seed=sum(shape))
    assert _route(x) == "sm90"
    got, ref = _emulate_sm90(x, sms), maxpool2_plain(x)
    assert got.shape == ref.shape
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    assert bool(same.all())
    # the selected value itself: signed zeros keep their sign
    assert torch.equal(torch.signbit(got[~torch.isnan(got)]), torch.signbit(ref[~torch.isnan(ref)]))


def test_bounds_of_the_pool_per_batch_128_forward_and_step(recorded):
    fwd = path_bounds(recorded["serve"], 128)["maxpool2"]
    bwd = path_bounds(recorded["train"], 128)["maxpool2_bwd"]
    assert fwd[:2] == (0, 1_014_558_720) and fwd[3] == "bytes"
    assert round(fwd[2], 4) == 0.3029
    assert bwd[:2] == (0, 2_029_117_440) and bwd[3] == "bytes"
    assert round(bwd[2], 4) == 0.6057


def test_bound_of_the_large_conv_is_its_arithmetic(recorded):
    """2 * 128 * (3*14 - 2)^2 * 256 * 256: the multiply-adds on taps
    inside the image (9 * 14^2 = 1764 taps an image plane, 1600 of them
    inside), none on the zero padding."""
    flops, nbytes = kernel_work("conv3x3", (14, 14, 256, 256), 128)
    assert flops == 26_843_545_600
    assert kernel_work("conv3x3_bn_relu_in", (14, 14, 256, 256), 128)[0] == flops
    t, by = bound(flops, nbytes)
    assert by == "operations" and round(t, 4) == 0.0271
    assert path_bounds(recorded["serve"], 128)["conv3x3"][3] == "operations"
    assert path_bounds(recorded["train"], 128)["conv3x3_bn_relu_in"][3] == "operations"


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Both sources include csrc/sm90_async.cuh: a change to it alone must
    name another library, or a stale build would load."""
    from mgtpu_torch import kernels

    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.library_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert kernels.library_path() != before
    assert [p.name for p in kernels._sources()] == ["a.cu"]  # headers are not compiled alone
