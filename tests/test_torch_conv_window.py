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
- The f32 TF32 branch: the route as a function of dtype, shape and
  ``torch.backends.cudnn.allow_tf32``; its plans at the saliency
  forward's shapes (and the FMA plans unchanged without the flag); the
  TF32 rounding the card's comparisons use; and a walk of the wgmma
  kernel's index math (the window's planes, the m64 units' core
  matrices, the K-major weights) held to the plain version on
  TF32-rounded operands.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (CHECK_BATCH, CIFAR_RECIPES, CIFAR_SERVE_BATCH, DEPTH, F32_STEP_BATCH,
                        SEG_F32_MICRO, SEG_RECIPES, SERVE_BATCHES, TIME_BATCH, TRAIN_BATCH,
                        cifar_opts, misaligned, predicted_routes, record_kernel_shapes)
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.ops import cuda_conv
from mgtpu_torch.ops.cuda_conv import (_route, _window_plan, _window_smem, bn_relu_plain,
                                       conv3x3_bn_relu_in_plain, conv3x3_plain, tf32_round)
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


def _covered_once(plan, n, h, w, co, workers=1):
    """The persistent walk (each of a block's ``workers`` walkers, block b's
    k-th taking tiles workers b + k, + workers grid_x, ... of each channel
    slice) visits every tile once, and the tiles' origins (the kernel's
    origin()) partition every axis of the output."""
    visited = np.zeros(plan.tiles, dtype=np.int64)
    for b in range(workers * plan.grid_x):
        visited[b::workers * plan.grid_x] += 1
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
    old = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False  # f32's FMA branch, which the walk mirrors
        assert cuda_conv._route(torch.empty((1, 3, 3, 8)), torch.empty((3, 3, 8, 8))) == "window"
    finally:
        torch.backends.cudnn.allow_tf32 = old


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


# ------------------------------------------------- the TF32 branch

@pytest.fixture
def allow_tf32():
    """Sets torch.backends.cudnn.allow_tf32 for a test and restores it."""
    old = torch.backends.cudnn.allow_tf32

    def set_(on):
        torch.backends.cudnn.allow_tf32 = on

    yield set_
    torch.backends.cudnn.allow_tf32 = old


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype, ci, co, flag, want", [
    (F32, 64, 64, True, "window_tf32"), (F32, 64, 64, False, "window"),
    (F32, 1, 64, True, "window_tf32"), (F32, 1, 64, False, "window"),
    (F32, 3, 8, True, "window_tf32"),  # the packed K walk
    (F32, 20, 70, True, "window_tf32"), (F32, 12, 16, True, "window_tf32"),
    (F32, 10, 16, True, "window"),  # Ci >= 8 off a multiple of 4: no TMA box of its windows
    (F32, 64, 1, True, "window"),  # Co = 1 stays on the FMA branch
    (F32, 64, 7, True, "window"),  # Co < 8: less than one n8 tile
    (F32, 4096, 64, True, "window"),  # no TF32 plan: the weights do not fit a block
    (BF16, 64, 64, True, "sm90"), (BF16, 64, 64, False, "sm90"),
    (BF16, 8, 8, True, "window"), (BF16, 8, 8, False, "window")])
def test_route_follows_allow_tf32(allow_tf32, dtype, ci, co, flag, want):
    allow_tf32(flag)
    x, w = torch.empty((1, 16, 16, ci), dtype=dtype), torch.empty((3, 3, ci, co), dtype=dtype)
    assert _route(x, w) == want
    if want == "window_tf32" and ci >= 8:  # x off 16 bytes: no TMA box either
        assert _route(misaligned(x), w) == "window"


def _up(v, m):
    return -(-v // m) * m


def _tf32_bytes(ci, bn, kc, stages, slots):
    """The TF32 branch's dynamic shared memory, from its layout as the
    kernel's source describes it: dense (Ci >= 8) the K-major weights of
    all 9 * Ci8 slots (bn x 16-byte planes, on 128 bytes), each of two
    warpgroups' window stages of slots x kc f32 (on 128 bytes), an 8-byte
    TMA barrier a stage, the (2, bn) stats and 128 bytes to align the
    start; packed (Ci < 8) weight rows of 9 * Ci rounded up to 8, plus 4,
    f32, the stages of slots x Ci f32, the slot table and the stats."""
    if ci >= 8:
        return (_up(bn * 9 * _up(ci, 8) * 4, 128) + 2 * stages * _up(slots * kc * 4, 128)
                + 2 * 8 * stages + 2 * bn * 4 + 128)
    rows = _up(9 * ci, 8)
    return _up(bn * (rows + 4) * 4, 16) + stages * _up(slots * ci * 4, 16) + rows * 4 + 2 * bn * 4


def _saliency_shapes():
    return sorted(_recorded(False, SEG_RECIPES["mnist-cluttered/pnmg.mnist"][0])["conv3x3"])


def test_tf32_plans_at_the_saliency_shapes():
    """Every shape of the saliency forward that the TF32 branch takes (Co
    >= 8) has a plan at 3,368 images: within a block's shared memory, the
    bytes of the layout, the wgmma tiling (8 columns, 8 or 16 rows, one or
    two images: whole m64 units), the persistent walk of two warpgroups a
    block (one with Ci < 8) covering every tile and channel slice once."""
    shapes = _saliency_shapes()
    assert len(shapes) == 12
    taken = 0
    for (h, w, ci, co) in shapes:
        if co < 8:
            continue
        taken += 1
        p = _window_plan(SALIENCY_IMAGES, h, w, ci, co, False, SMS, tf32=True)
        slots = p.ti * (p.th + 2) * (p.tw + 2)
        assert p.smem <= SMEM_BLOCK
        assert p.smem == _tf32_bytes(ci, p.bn, p.kc, p.stages, slots)
        assert (p.smem, p.chunks) == _window_smem(False, ci, p.bn, p.kc, p.stages, slots, True)
        assert p.bn == min(64, co) and p.grid_y == 1
        if ci >= 8:
            assert p.tw == 8 and p.th == (8 if h <= 8 else 16) and p.ti * p.th == 16
            assert p.chunks == -(-_up(ci, 8) // p.kc)
        else:
            assert (p.kc, p.chunks) == (ci, 1)
        _covered_once(p, SALIENCY_IMAGES, h, w, co, workers=2 if ci >= 8 else 1)
    assert taken == 11
    # 64x64x64->64: 64 channels a block, the 9 x 64 x 64 weights (147,456
    # bytes) kept, a stage of 32 channels of 10 x 18 slots (23,040 bytes)
    # a warpgroup, one block an SM
    p = _window_plan(SALIENCY_IMAGES, 64, 64, 64, 64, False, SMS, tf32=True)
    assert (p.ti, p.th, p.tw, p.bn, p.kc, p.chunks, p.stages, p.grid_x) == (
        1, 16, 8, 64, 32, 2, 1, SMS)
    assert p.smem == 147_456 + 2 * 23_040 + 2 * 8 + 2 * 64 * 4 + 128
    # 32x32x64->32: four 16-channel chunks, one stage, two blocks an SM
    p = _window_plan(SALIENCY_IMAGES, 32, 32, 64, 32, False, SMS, tf32=True)
    assert (p.bn, p.kc, p.chunks, p.stages, p.grid_x) == (32, 16, 4, 1, 2 * SMS)
    # 64x64x1->64, packed: rows of 16 slots + 4, 180 slots of one f32
    p = _window_plan(SALIENCY_IMAGES, 64, 64, 1, 64, False, SMS, tf32=True)
    assert p.smem == 64 * 20 * 4 + 2 * 720 + 16 * 4 + 2 * 64 * 4


# the FMA branch's plans at the saliency shapes, as they were before the
# TF32 branch: (ti, th, tw, bn, kc, chunks, stages, smem, tiles, grid_x,
# grid_y) on 132 SMs at 3,368 images
FMA_PLANS = {
    (8, 8, 1, 8): (2, 8, 8, 8, 4, 1, 1, 4416, 1684, 528, 1),
    (8, 8, 8, 8): (2, 8, 8, 8, 8, 1, 1, 11968, 1684, 528, 1),
    (8, 8, 16, 8): (2, 8, 8, 8, 16, 1, 1, 20672, 1684, 528, 1),
    (16, 16, 1, 16): (1, 8, 16, 16, 4, 1, 1, 5312, 6736, 528, 1),
    (16, 16, 16, 16): (1, 8, 16, 16, 16, 1, 1, 23744, 6736, 528, 1),
    (16, 16, 32, 16): (1, 8, 16, 16, 32, 1, 1, 44480, 6736, 528, 1),
    (32, 32, 1, 32): (1, 8, 16, 32, 4, 1, 1, 7744, 26944, 528, 1),
    (32, 32, 32, 32): (1, 8, 16, 32, 32, 1, 1, 63040, 26944, 396, 1),
    (32, 32, 64, 32): (1, 8, 16, 32, 64, 1, 1, 65600, 26944, 396, 1),
    (64, 64, 1, 64): (1, 8, 16, 64, 4, 1, 1, 12608, 107776, 528, 1),
    (64, 64, 64, 1): (1, 8, 16, 1, 64, 1, 1, 51272, 107776, 528, 1),
    (64, 64, 64, 64): (1, 8, 16, 64, 64, 1, 1, 82240, 107776, 264, 1)}


def test_f32_plans_without_tf32_are_unchanged(allow_tf32):
    """With allow_tf32 False every f32 launch of the saliency forward
    routes to the FMA branch, planned exactly as before the TF32 branch."""
    allow_tf32(False)
    assert sorted(FMA_PLANS) == _saliency_shapes()
    for (h, w, ci, co), want in FMA_PLANS.items():
        x, wt = torch.empty((1, h, w, ci)), torch.empty((3, 3, ci, co))
        assert _route(x, wt) == "window"
        assert tuple(_window_plan(SALIENCY_IMAGES, h, w, ci, co, False, SMS)) == want


def _f32(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("given, want", [
    (0x3F800000, 0x3F800000),  # 1.0
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: a tie, away from zero
    (0x3F800FFF, 0x3F800000),  # just under the tie
    (0x3F801001, 0x3F802000),  # just over it
    (0x3F803000, 0x3F804000),  # 1 + 3 * 2^-11: a tie to the odd neighbour (away, not even)
    (0xBF801000, 0xBF802000),  # -(1 + 2^-11): away from zero, negative
    (0x00000000, 0x00000000), (0x80000000, 0x80000000),  # +0, -0 keep their signs
    (0x00000001, 0x00000000),  # the least subnormal: under half a TF32 step
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x7F7FE000, 0x7F7FE000),  # TF32's largest
    (0x7F7FFFFF, 0x7F800000),  # f32's largest rounds past it: inf
    (0xFF7FFFFF, 0xFF800000),  # and -inf
    (0x7F800000, 0x7F800000), (0xFF800000, 0xFF800000)])  # inf, -inf stay
def test_tf32_round_by_hand(given, want):
    got = tf32_round(_f32([given])).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want


def test_tf32_round_keeps_nan():
    """A NaN stays a NaN, also one whose payload sits in the dropped bits
    (masking those bits alone would make it inf)."""
    x = _f32([0x7FC00000, 0x7F800001, 0xFF800FFF, 0x7F801000])
    assert torch.isnan(tf32_round(x)).all()


def tf32_walk(x, w, b, pads=(1, 1), sms=4):
    """conv3x3 as the TF32 branch's wgmma kernel computes it (Ci >= 8): per
    channel slice and tile (whichever warpgroup takes it), per chunk of kc
    channels, the window in the
    planes' layout a TMA box gives (plane pl, slot s, channel e at (pl *
    slots + s) * 4 + e; zero outside x), the weights in K-major planes
    (slot k of output channel n at (k // 4 * bn + n) * 4 + k % 4, k = tap
    * Ci8 + c), and for each tap and 8-channel step each m64 unit's A read
    as the descriptor reads it: core matrix p (8 rows) at slot abase +
    shift + p * sw, planes slots apart; D's row r of unit i is tile pixel
    64 i + r. Operands rounded to TF32, sums in float64."""
    n, hin, wd, ci = x.shape
    co = w.shape[3]
    h = hin - 2 + sum(pads)
    p = _window_plan(n, h, wd, ci, co, False, sms, tf32=True)
    assert p.tw == 8 and p.th in (8, 16) and p.ti * p.th <= 16
    sh, sw = p.th + 2, p.tw + 2
    slots, ci8, tpx = p.ti * sh * sw, _up(ci, 8), p.ti * p.th * p.tw
    tiles_h, tiles_w = -(-h // p.th), -(-wd // p.tw)
    xr, wr = tf32_round(x).double().numpy(), tf32_round(w).double().numpy()
    big = np.zeros((n + 2 * p.ti, hin + 2 * sh, wd + 2 * sw, _up(ci8, p.kc)))
    big[:n, sh:sh + hin, sw:sw + wd, :ci] = xr  # x[i, r, c] at [i, r + sh, c + sw]
    y = np.zeros((n, h, wd, co))

    def slot_of(q):  # the kernel's slot_of: a tile pixel's (0, 0) slot
        ii, r, c = q // (p.th * p.tw), q % (p.th * p.tw) // p.tw, q % p.tw
        return (ii * sh + r) * sw + c

    m64 = -(-tpx // 64)
    abase = [slot_of(64 * i) for i in range(m64)]
    for j in range(p.grid_y):
        n0 = j * p.bn
        nc = min(p.bn, co - n0)
        wk = np.zeros((9, ci8, p.bn))
        wk[:, :ci, :nc] = wr.reshape(9, ci, co)[:, :, n0:n0 + nc]
        wflat = wk.reshape(9 * ci8 // 4, 4, p.bn).transpose(0, 2, 1).reshape(-1)
        for t in range(p.tiles):
            w0, h0 = t % tiles_w * p.tw, t // tiles_w % tiles_h * p.th
            img0 = t // (tiles_w * tiles_h) * p.ti
            acc = np.zeros((m64, 64, p.bn)) + np.pad(b[n0:n0 + nc].double().numpy(),
                                                     (0, p.bn - nc))
            for chunk in range(p.chunks):
                c0 = chunk * p.kc
                box = big[img0:img0 + p.ti, sh + h0 - pads[0]:sh + h0 - pads[0] + sh,
                          sw + w0 - 1:sw + w0 - 1 + sw, c0:c0 + p.kc]
                win = box.reshape(slots, p.kc // 4, 4).transpose(1, 0, 2).reshape(-1)
                kcc = min(p.kc, ci8 - c0)
                for tap in range(9):
                    shift = tap // 3 * sw + tap % 3
                    for k in range(0, kcc, 8):
                        kk = tap * ci8 + c0 + k + np.arange(8)
                        bmat = wflat[((kk[:, None] // 4) * p.bn + np.arange(p.bn)) * 4
                                     + kk[:, None] % 4]
                        rows = np.arange(64)
                        for i in range(m64):
                            slot = abase[i] + shift + rows // 8 * sw + rows % 8
                            e = np.arange(8)
                            amat = win[((k // 4 + e[None, :] // 4) * slots + slot[:, None]) * 4
                                       + e[None, :] % 4]
                            acc[i] += amat @ bmat
            for i in range(m64):
                for r in range(64):
                    q = 64 * i + r
                    ii, rr, cc = q // (p.th * p.tw), q % (p.th * p.tw) // p.tw, q % p.tw
                    if img0 + ii < n and h0 + rr < h and w0 + cc < wd:
                        y[img0 + ii, h0 + rr, w0 + cc, n0:n0 + nc] = acc[i, r, :nc]
    return torch.from_numpy(y), p


TF32_WALK_SHAPES = [(3, 5, 6, 8, 8), (2, 19, 21, 16, 10), (1, 9, 13, 20, 70), (2, 8, 8, 64, 16),
                    (1, 17, 9, 40, 8), (1, 3, 4, 520, 8)]


@pytest.mark.parametrize("pads", PAD_PAIRS)
def test_tf32_walk_matches_the_plain_version(pads):
    """The wgmma kernel's decomposition is the conv on TF32-rounded
    operands (float64 sums: within 1e-9 of the scale), at shapes with
    images smaller than a unit (H, W < 8; two images a tile), row and
    column tails, Ci off a multiple of 8, several channel slices and (Ci
    520) several chunks."""
    rng = np.random.default_rng(sum(pads) + 40)
    chunked = False
    for (n, h, wd, ci, co) in TF32_WALK_SHAPES:
        hin = h + 2 - sum(pads)
        x = torch.from_numpy(rng.standard_normal((n, hin, wd, ci), dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal((3, 3, ci, co), dtype=np.float32))
        b = torch.from_numpy(rng.standard_normal(co, dtype=np.float32))
        y, plan = tf32_walk(x, w, b, pads)
        chunked |= plan.chunks > 1
        ref = conv3x3_plain(tf32_round(x).double(), tf32_round(w).double(), b.double(),
                            with_stats=False, pad_top=pads[0], pad_bottom=pads[1])[0]
        assert (y - ref).abs().max().item() <= 1e-9 * ref.abs().max().item(), (n, h, wd, ci, co)
    assert chunked
