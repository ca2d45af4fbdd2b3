"""The window design of the port's 3x3 convs (`csrc/conv3x3_window.cu`),
checked on the CPU where its arithmetic does not need the card.

- The host plan (`cuda_conv._window_plan`) at every conv3x3 and
  conv3x3_bn_relu_in shape the zoo's recorded passes send off sm90, at
  the batches the card runs them: shared memory within a block's 232,448
  bytes, and the persistent blocks' walk covering each output pixel and
  channel exactly once.
- A torch walk of the window decomposition, mirroring the kernel's
  index math (origin, SlotWalk.src, slot_of, Place and the packed K
  table of Ci < 16): each tile's window cut from x with zero rows and
  columns, the prologue applied where a position lies in x, then the 9
  shifted tap products summed chunk by chunk, held to conv3x3_plain and
  conv3x3_bn_relu_in_plain at small shapes with tails and all four pad
  pairs.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (CHECK_BATCH, CIFAR_RECIPES, CIFAR_SERVE_BATCH, DEPTH, F32_STEP_BATCH,
                        SEG_F32_MICRO, SEG_RECIPES, SERVE_BATCHES, TIME_BATCH, TRAIN_BATCH,
                        cifar_opts, predicted_routes, record_kernel_shapes)
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.ops import cuda_conv
from mgtpu_torch.ops.cuda_conv import (_window_plan, bn_relu_plain, conv3x3_bn_relu_in_plain,
                                       conv3x3_plain)
from mgtpu_torch.parallel import spatial_split, tp_spec

SMS = 132  # the H100's
SMEM_BLOCK = 232_448
SALIENCY_IMAGES = 3368  # a saliency forward's images (chip_smoke.py phase 27)
CONV_KERNELS = ("conv3x3", "conv3x3_bn_relu_in")

# net -> (its options, bf16 batches, f32 batches): the batches at which
# chip_smoke.py serves, trains, checks and times it
NETS = {
    f"R-MG-{DEPTH}": (NetOpts(depth=DEPTH), (*SERVE_BATCHES, CHECK_BATCH, TRAIN_BATCH, TIME_BATCH),
                      (CHECK_BATCH, F32_STEP_BATCH)),
    **{net: (cifar_opts(net), (CHECK_BATCH, CIFAR_SERVE_BATCH, micro), (CHECK_BATCH, 16))
       for net, (_, micro, _) in CIFAR_RECIPES.items()},
    **{net: (opt, (CHECK_BATCH, micro, *batches), (CHECK_BATCH, SEG_F32_MICRO[net]))
       for net, (opt, micro, _, batches) in SEG_RECIPES.items()},
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: the recording forwards run beside the other
    test workers, and more threads than cores slow them many fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@functools.cache
def _recorded(train, opt):
    """record_kernel_shapes of one pass, once a module (R-MG-34's training
    step serves two tests)"""
    return record_kernel_shapes(train, opt)


def _off_sm90(shapes):
    """{kernel: {(H, W, Ci, Co)}} of the recorded calls _route sends to window"""
    out = {}
    for kernel in CONV_KERNELS:
        out[kernel] = {s for s in shapes[kernel]
                       if predicted_routes({**{k: {} for k in shapes}, kernel: {s: 1}})[
                           (kernel, "window")]}
    return out


def _covered_once(plan, n, h, w, co):
    """The persistent walk (block b takes tiles b, b + grid_x, ... of each
    channel slice) visits every tile once, and the tiles' origins (the
    kernel's origin()) partition every axis of the output."""
    visited = np.zeros(plan.tiles, dtype=np.int64)
    for b in range(plan.grid_x):
        visited[b::plan.grid_x] += 1
    assert (visited == 1).all()
    tiles_h, tiles_w = -(-h // plan.th), -(-w // plan.tw)
    assert plan.tiles == -(-n // plan.ti) * tiles_h * tiles_w
    t = np.arange(plan.tiles)
    for start, size, extent in ((t // (tiles_w * tiles_h) * plan.ti, plan.ti, n),
                                (t // tiles_w % tiles_h * plan.th, plan.th, h),
                                (t % tiles_w * plan.tw, plan.tw, w)):
        cover = np.zeros(extent, dtype=np.int64)
        for s in np.unique(start):
            cover[s:s + size] += 1
        assert (cover == 1).all()
    chans = np.zeros(co, dtype=np.int64)
    for j in range(plan.grid_y):
        chans[j * plan.bn:(j + 1) * plan.bn] += 1
    assert (chans == 1).all()


def _check_plan(n, h, w, ci, co, bf16):
    p = _window_plan(n, h, w, ci, co, bf16, SMS)
    assert p.smem <= SMEM_BLOCK
    assert 1 <= p.ti * p.th * p.tw <= 128 and p.th <= h and p.tw <= w
    assert p.ti == 1 or (p.th, p.tw) == (h, w)
    assert p.bn in ((8, 16, 32, 64) if bf16 else (1, 8, 16, 32, 64))
    assert 1 <= p.grid_x <= p.tiles and p.grid_y == -(-co // p.bn)
    if bf16 and ci < 16:
        assert (p.kc, p.chunks) == (ci, 1)  # the taps packed into one K walk
    _covered_once(p, n, h, w, co)
    return p


def _rmg_axis_slabs():
    """R-MG-34's training-step convs as a rank of phase 31 launches them:
    under -spatial 2 each splittable height halved (a slab of H/2 rows),
    under -tensor 2 each sliced Co halved"""
    train = _recorded(True, NETS[f"R-MG-{DEPTH}"][0])
    out = {}
    for kernel in CONV_KERNELS:
        slabs = {(h // 2 if spatial_split(h, 2) else h, w, ci, co)
                 for (h, w, ci, co) in train[kernel]}
        halves = {(h, w, ci, co // 2 if tp_spec((co,), 2) else co)
                  for (h, w, ci, co) in train[kernel]}
        out[kernel] = slabs | halves
    return {**{k: {} for k in train}, **{k: dict.fromkeys(v, 1) for k, v in out.items()}}


@pytest.mark.parametrize("net", [*NETS, "saliency", "axis"])
def test_window_plan_at_every_routed_shape(net):
    """Every shape the net's recorded serving forward and training step
    send to window (bf16), and every shape of its f32 checks, at the
    card's batches; the saliency forward's at 3,368 images in f32; R-MG-34's
    slabs and halved channels under -spatial 2 / -tensor 2 (phase 31)."""
    if net == "saliency":
        shapes = _recorded(False, SEG_RECIPES["mnist-cluttered/pnmg.mnist"][0])
        cases = [(SALIENCY_IMAGES, s, False) for s in shapes["conv3x3"]]
        assert len(cases) == 12
    elif net == "axis":
        slabs = _rmg_axis_slabs()
        cases = [(b, s, True) for k, ss in _off_sm90(slabs).items() for s in ss
                 for b in (CHECK_BATCH, TIME_BATCH)]
        assert len(cases) > 20
    else:
        opt, bf16_batches, f32_batches = NETS[net]
        cases = []
        for train in (False, True):
            shapes = _recorded(train, opt)
            for kernel, ss in _off_sm90(shapes).items():
                cases += [(b, s, True) for s in ss for b in bf16_batches]
            for kernel in CONV_KERNELS:  # every f32 launch takes window
                cases += [(b, s, False) for s in shapes[kernel] for b in f32_batches]
        assert cases
    for batch, (h, w, ci, co), bf16 in cases:
        _check_plan(batch, h, w, ci, co, bf16)


def test_window_plans_of_the_narrow_rmg34_shapes():
    """The plans the card runs R-MG-34's narrow batch-128 launches with:
    one chunk, two window stages, a block's channels Co rounded up to a
    power of two (at most 64), one 7x7 image a tile (at least one block an
    image: narrower blocks ran slower on the card), tiles of 9 x 14 pixels
    at 14x14 and 28x28."""
    for shape in [(7, 7, 16, 32), (7, 7, 32, 32), (7, 7, 64, 32), (7, 7, 96, 128),
                  (14, 14, 16, 16), (14, 14, 32, 16), (14, 14, 32, 64), (28, 28, 32, 32),
                  (28, 28, 64, 32)]:
        p = _check_plan(TIME_BATCH, *shape, True)
        assert p.stages == 2 and p.chunks == 1 and p.kc == shape[2]
        assert min(p.tiles, p.grid_x) * p.grid_y >= TIME_BATCH
        assert (p.ti, p.th, p.tw) == ((1, 7, 7) if shape[0] == 7 else (1, 9, 14))
        assert p.bn == (32 if shape[3] == 128 else shape[3])
    # 7x7x96->128: 32 channels a block, the 9 x 96 x 32 weights kept
    p = _window_plan(TIME_BATCH, 7, 7, 96, 128, True, SMS)
    assert (p.bn, p.kc, p.smem) == (32, 96, 9 * 96 * 40 * 2 + 2 * 81 * 104 * 2 + 2 * 32 * 4)
    # the saliency forward's f32 64x64x64->64: 8 x 16 tiles, 64 channels a block
    p = _window_plan(SALIENCY_IMAGES, 64, 64, 64, 64, False, SMS)
    assert (p.ti, p.th, p.tw, p.bn, p.kc, p.chunks) == (1, 8, 16, 64, 64, 1)
    assert p.smem == 180 * 68 * 4 + 2 * 64 * 64 * 4 + 2 * 64 * 4


# ------------------------------------------------- the walk on the CPU

def _packed_koff(ci, sw):
    """The kernel's K table for Ci < 16: slot k = tap * Ci + c -> the
    element offset of its tap's shift and its channel, -1 past 9 * Ci"""
    rows = -(-9 * ci // 16) * 16
    return [((k // ci) // 3 * sw + (k // ci) % 3) * ci + k % ci if k < 9 * ci else -1
            for k in range(rows)]


def window_walk(x, w, b, scale=None, shift=None, *, pads=(1, 1), relu_out=False, bf16=False,
                sms=4):
    """conv3x3 (with the prologue, given scale and shift) computed as the
    window design walks it: per channel slice and tile (each block's
    tiles b, b + grid_x, ...), the window of (ti, th + 2, tw + 2) slots
    cut from x (zero outside x: the window's first row is h0 - pad_top,
    its first column w0 - 1), the prologue where a slot lies in x (its
    result rounded to bf16 as the kernel's operand), then per chunk of
    kc channels the 9 taps as shifted views of it, tap outer; packed
    (bf16, Ci < 16) as one K walk gathered through the kernel's slot
    table. Sums in float64. Returns (y, the windows after the prologue
    with their in-x masks, the plan)."""
    n, hin, wd, ci = x.shape
    pad_top, pad_bottom = pads
    h = hin - (1 - pad_top) - (1 - pad_bottom)
    co = w.shape[3]
    p = _window_plan(n, h, wd, ci, co, bf16, sms)
    sh, sw = p.th + 2, p.tw + 2
    tiles_i, tiles_h, tiles_w = -(-n // p.ti), -(-h // p.th), -(-wd // p.tw)
    # x with a zero border wide enough for every window: x[i, r, c] at
    # [i, r + 1, c + 1]
    shape = (tiles_i * p.ti, tiles_h * p.th + 3, tiles_w * p.tw + 3)
    big = torch.zeros((*shape, ci), dtype=torch.float64)
    inside = torch.zeros(shape, dtype=torch.bool)
    big[:n, 1:1 + hin, 1:1 + wd] = x.double()
    inside[:n, 1:1 + hin, 1:1 + wd] = True
    y = torch.zeros((n, h, wd, co), dtype=torch.float64)
    windows = []
    koff = torch.tensor(_packed_koff(ci, sw)[:9 * ci]) if bf16 and ci < 16 else None
    for j in range(p.grid_y):
        n0 = j * p.bn
        nc = min(p.bn, co - n0)
        wsl = w[..., n0:n0 + nc].double()
        for bx in range(p.grid_x):
            for t in range(bx, p.tiles, p.grid_x):
                w0 = t % tiles_w * p.tw
                h0 = t // tiles_w % tiles_h * p.th
                img0 = t // (tiles_w * tiles_h) * p.ti
                rows = slice(h0 - pad_top + 1, h0 - pad_top + 1 + sh)
                cols = slice(w0, w0 + sw)
                win = big[img0:img0 + p.ti, rows, cols].clone()
                mask = inside[img0:img0 + p.ti, rows, cols]
                if scale is not None:
                    norm = bn_relu_plain(win.float(), scale, shift)
                    if bf16:
                        norm = norm.to(torch.bfloat16)
                    win = torch.where(mask[..., None], norm.double(), torch.zeros_like(win))
                windows.append((win, mask))
                acc = b[n0:n0 + nc].double().expand(p.ti, p.th, p.tw, nc).clone()
                if koff is not None:
                    # A[q, k] = the window element at pixel q's (0, 0) slot
                    # plus the table's offset of slot k
                    q = torch.arange(p.ti * p.th * p.tw)
                    base = ((q // (p.th * p.tw) * sh + q % (p.th * p.tw) // p.tw) * sw
                            + q % p.tw) * ci
                    a = win.reshape(-1)[base[:, None] + koff[None, :]]
                    acc += (a @ wsl.reshape(9 * ci, nc)).reshape(acc.shape)
                else:
                    for c0 in range(0, ci, p.kc):
                        for tap in range(9):
                            kh, kw = divmod(tap, 3)
                            view = win[:, kh:kh + p.th, kw:kw + p.tw, c0:c0 + p.kc]
                            acc += view @ wsl[kh, kw, c0:c0 + p.kc]
                ni, nh, nw = min(p.ti, n - img0), min(p.th, h - h0), min(p.tw, wd - w0)
                y[img0:img0 + ni, h0:h0 + nh, w0:w0 + nw, n0:n0 + nc] = acc[:ni, :nh, :nw]
    if relu_out:
        y = torch.relu(y)
    return y, windows, p


WALK_SHAPES = [(2, 7, 7, 5, 3), (3, 5, 6, 3, 10), (2, 9, 19, 1, 8), (2, 8, 8, 8, 8),
               (1, 20, 17, 24, 10), (2, 4, 4, 40, 20), (1, 6, 5, 72, 70), (4, 2, 2, 16, 9),
               (16, 4, 4, 16, 9)]
PAD_PAIRS = [(1, 1), (0, 1), (1, 0), (0, 0)]


@pytest.mark.parametrize("pads", PAD_PAIRS)
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_window_walk_matches_the_plain_version(pads, prologue, bf16):
    """The decomposition is the conv: f32 values (bf16-rounded where the
    kernel's operands are bf16), held to the plain version within 1e-5 of
    its scale; pad positions of every window stay 0 under the prologue,
    whose shifts are mostly positive (relu(shift) > 0 there)."""
    rng = np.random.default_rng(sum(pads) + 2 * prologue + 4 * bf16)
    for k, (n, h, wd, ci, co) in enumerate(WALK_SHAPES):
        hin = h + 2 - sum(pads)
        dt = torch.bfloat16 if bf16 else torch.float32
        x = torch.from_numpy(rng.standard_normal((n, hin, wd, ci), dtype=np.float32)).to(dt)
        w = torch.from_numpy(rng.standard_normal((3, 3, ci, co), dtype=np.float32)).to(dt)
        b = torch.from_numpy(rng.standard_normal(co, dtype=np.float32))
        scale = shift = None
        if prologue:
            scale = torch.from_numpy(rng.uniform(0.5, 1.5, ci).astype(np.float32))
            shift = torch.from_numpy(rng.normal(0.5, 0.3, ci).astype(np.float32))
        y, windows, plan = window_walk(x.float(), w.float(), b, scale, shift, pads=pads,
                                       relu_out=k % 2 == 1, bf16=bf16)
        kw = dict(relu_out=k % 2 == 1, with_stats=False, pad_top=pads[0], pad_bottom=pads[1])
        if prologue:
            xn = bn_relu_plain(x, scale, shift)
            y_ref = conv3x3_plain(xn.float(), w.float(), b, **kw)[0]
            assert torch.equal(conv3x3_bn_relu_in_plain(x, w, b, scale, shift, **kw)[0],
                               conv3x3_plain(xn, w, b, **kw)[0])
            for win, inside in windows:
                assert not win[~inside].any()
        else:
            y_ref = conv3x3_plain(x.float(), w.float(), b, **kw)[0]
        scale_ref = y_ref.abs().max().item()
        err = (y.float() - y_ref).abs().max().item()
        assert err <= 1e-5 * scale_ref, (n, h, wd, ci, co, plan, err)


def test_walk_takes_every_path_of_the_plan():
    """The walk's shapes reach the plan's paths at sms=4: several images a
    tile, row and column tails, packed and dense K, several channel
    slices, and (f32) several chunks."""
    plans = [_window_plan(n, h, w, ci, co, bf16, 4) for (n, h, w, ci, co) in WALK_SHAPES
             for bf16 in (False, True)]
    assert any(p.ti > 1 for p in plans)
    assert any(p.th < h for p, (n, h, w, ci, co) in zip(plans[::2], WALK_SHAPES))
    assert any(p.grid_y > 1 for p in plans)
    assert _window_plan(1, 6, 5, 72, 70, False, 4).chunks == 2
    assert _window_plan(2, 8, 8, 8, 8, True, 4).kc == 8  # packed
    assert cuda_conv._route(torch.empty((1, 3, 3, 8)), torch.empty((3, 3, 8, 8))) == "window"


def test_packed_k_table_is_the_tap_major_k():
    """Gathering A through the packed table gives, for slot k = tap * Ci +
    c, the window element at the pixel's slot shifted by the tap, channel
    c: the dense K order of the taps, without the zero fill of 16-channel
    steps."""
    for ci in (1, 3, 8, 10, 15):
        sh, sw = 9, 9
        win = np.arange(sh * sw * ci, dtype=np.int64).reshape(sh, sw, ci)
        koff = _packed_koff(ci, sw)
        assert len(koff) % 16 == 0 and len(koff) - 9 * ci < 16
        for r, c in ((0, 0), (3, 4), (6, 6)):
            base = (r * sw + c) * ci
            got = [win.reshape(-1)[base + o] for o in koff[:9 * ci]]
            want = [win[r + tap // 3, c + tap % 3, ch] for tap in range(9) for ch in range(ci)]
            assert got == want
        assert all(o == -1 for o in koff[9 * ci:])
