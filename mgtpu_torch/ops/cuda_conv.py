"""3x3/s1/p1 NHWC convs with a bias, optional ReLU and an optional
per-channel (sum, sum of squares) epilogue: the CUDA kernels' wrappers,
their plain versions, and the autograd Functions around them.

Ports of `mgtpu/ops/pallas_conv.py::conv3x3` (its ``rows`` and ``slab``
variants compute the same function) and ``conv3x3_bn_relu_in`` (the
BatchNorm-apply + ReLU prologue); the signatures drop ``variant``,
``th`` and ``interpret``. Both kernels have three designs:
``sm90`` (TMA and wgmma, for bf16 with Ci and Co multiples of 64: the
large shapes; `mgtpu_torch/csrc/conv3x3.cu`), ``window`` (a tile's input
window in shared memory once, its 9 taps shifted views of it; mma.sync
in bf16, FMAs in f32: everything else; `csrc/conv3x3_window.cu`, planned
by :func:`_window_plan`) and ``tile`` (the first design, WMMA or FMA
tiles that gather every tap from device memory; `conv3x3.cu`), which the
port no longer launches: :func:`_tile_forward` runs it for comparisons.
The window design's f32 launches have two branches, counted as two
routes: ``window_tf32`` (TF32 tensor cores, wgmma fed by TMA, mma.sync
for Ci < 8; each operand rounded to TF32 once: :func:`tf32_round`) where
``torch.backends.cudnn.allow_tf32`` is True, PyTorch's own switch for
its convs (so the forward follows cuDNN's backward), and ``window``
(exact FMAs) where it is False or the shape does not suit TF32.
:func:`_route` picks from dtype, shape, alignment and that flag alone;
it is not a fallback, and a launch that fails raises.

The running part sum (``y_in``, conv3x3 only): the output is
``relu?(round(acc + bias + float(y_in)))``, the f32 accumulator seeded
with the bias as without it, ``y_in`` (the output's shape and dtype)
added in f32 before the one rounding and the ReLU after it, so the
multigrid exchange sums its parts in the kernels' epilogues instead of
in a stock add a part (`mgtpu_torch.nn.ConvBN.conv_parts`, eval mode).
Every design the route picks takes it (tile refuses it); a launch that
reads one is counted in ``kernels.SUMMED``. The output is a new tensor,
and ``y_in`` must lie on 16 bytes (the kernels read it as they write y).

Per-side H padding (``pad_top``, ``pad_bottom``, each 0 or 1; default
1): where one is 0, ``x`` carries the neighbour's row on that side (the
halo row of an H-slab under ``-spatial``, `mgtpu_torch.parallel.axis`)
instead of a zero pad, so ``x`` has ``H + (1 - pad_top) + (1 -
pad_bottom)`` rows and ``y`` has ``H``. ``conv3x3_bn_relu_in``
normalizes halo rows (they are activations); only padding stays 0. One
slab conv is one launch, as one whole-image conv is.

The backward of both is cuDNN's dgrad and wgrad (``convolution_backward``
on the ``channels_last`` views) plus elementwise reductions: the JAX
package has no Pallas backward for these convs (XLA differentiates
them), so there is no TPU kernel to port there. The stats output is not
differentiable. Under ``torch.export`` the forwards are the custom
ops ``mgtpu::conv3x3`` and ``mgtpu::conv3x3_bn_relu_in``
(`mgtpu_torch.ops.library`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mgtpu_torch import kernels, trace
from mgtpu_torch.ops.resample import nchw, nhwc

_DTYPES = (torch.float32, torch.bfloat16)
_AXES = (0, 1, 2)  # every axis of an NHWC tensor but its channels


def _stats(y, co, with_stats):
    if not with_stats:
        return torch.zeros((2, co), dtype=torch.float32, device=y.device)
    yf = y.float()
    return torch.stack([yf.sum(dim=_AXES), (yf * yf).sum(dim=_AXES)])


def _pad_rows(x, pad_top, pad_bottom):
    """NHWC x with ``pad_top`` zero rows above and ``pad_bottom`` below."""
    return F.pad(x, (0, 0, 0, 0, pad_top, pad_bottom)) if pad_top or pad_bottom else x


def out_rows(x, pad_top=1, pad_bottom=1) -> int:
    """The rows of a conv3x3's output from ``x`` under the pads."""
    if pad_top not in (0, 1) or pad_bottom not in (0, 1):
        raise ValueError(f"pad_top {pad_top} and pad_bottom {pad_bottom} must be 0 or 1")
    return x.shape[1] - (1 - pad_top) - (1 - pad_bottom)


def conv3x3_plain(x, w, b, *, relu_out=False, with_stats=True, pad_top=1, pad_bottom=1,
                  y_in=None):
    """Stock-torch version, the same formula as ``xla_conv3x3``:
    y = conv(x, w) + b in ``x.dtype`` [ReLU]; stats (2, Co) f32 of y.
    Under per-side padding the zero rows are added to x where a pad is 1
    and the conv pads W alone. With ``y_in`` the conv runs in f32 (bf16
    products are exact there; float64 stays), ``y_in`` is added there and
    the sum rounded to ``x.dtype`` once, before the ReLU."""
    wt, dt = w.permute(3, 2, 0, 1), x.dtype
    if y_in is not None:
        acc = torch.promote_types(dt, torch.float32)
        x, wt, b, y_in_acc = x.to(acc), wt.to(acc), b.to(acc), y_in.to(acc)
    if (pad_top, pad_bottom) == (1, 1):
        y = nhwc(F.conv2d(nchw(x), wt, b.to(x.dtype), padding=1))
    else:
        out_rows(x, pad_top, pad_bottom)
        y = nhwc(F.conv2d(nchw(_pad_rows(x, pad_top, pad_bottom)), wt, b.to(x.dtype),
                          padding=(0, 1)))
    y = y.contiguous()
    if y_in is not None:
        y = (y + y_in_acc).to(dt)
    if relu_out:
        y = torch.relu(y)
    return y, _stats(y, w.shape[3], with_stats)


def bn_relu_plain(x, scale, shift):
    """relu(x * scale + shift) computed in f32 and rounded to x.dtype:
    the normalized input of ``conv3x3_bn_relu_in``."""
    return torch.relu(x.float() * scale + shift).to(x.dtype)


def conv3x3_bn_relu_in_plain(x, w, b, scale, shift, *, relu_out=False, with_stats=True,
                             pad_top=1, pad_bottom=1):
    """Stock-torch version, the same formula as ``xla_conv3x3_bn_relu_in``:
    conv3x3_plain of the normalized input. Its zero padding is added
    after the normalization, so pad positions stay 0; every row of x,
    halo rows included, is normalized."""
    return conv3x3_plain(bn_relu_plain(x, scale, shift), w, b, relu_out=relu_out,
                         with_stats=with_stats, pad_top=pad_top, pad_bottom=pad_bottom)


def _check(name, x, w, b, vectors=()):
    """Raise unless the CUDA kernel takes these operands."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not in {_DTYPES}")
    if w.dtype != x.dtype or b.dtype != torch.float32:
        raise TypeError(f"{name}: needs w in x.dtype ({x.dtype}) and an f32 bias, "
                        f"got w {w.dtype}, b {b.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous NHWC x, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    ci = x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"{name}: w shape {tuple(w.shape)} is not (3, 3, {ci}, Co)")
    co = w.shape[3]
    # rows of (ci, co) contiguous per tap; taps evenly spaced: a dense HWIO
    # weight or its slice along the input channels
    if not (w.stride(3) == 1 and w.stride(2) == co and w.stride(0) == 3 * w.stride(1)):
        raise ValueError(f"{name}: w strides {w.stride()} are not an HWIO "
                         f"input-channel slice")
    if b.shape != (co,) or not b.is_contiguous():
        raise ValueError(f"{name}: b shape {tuple(b.shape)} is not ({co},)")
    for vname, v in vectors:
        if v.dtype != torch.float32 or v.shape != (ci,) or not v.is_contiguous():
            raise ValueError(f"{name}: {vname} must be a contiguous f32 ({ci},) tensor, got "
                             f"{tuple(v.shape)} {v.dtype}")
    if any(t.device != x.device for t in (w, b, *(v for _, v in vectors))):
        raise ValueError(f"{name}: all operands must be on one device")


def _route(x, w):
    """The design a CUDA launch of these operands takes: "sm90" (TMA and
    wgmma) for bf16 with Ci and Co multiples of 64 (one 128-byte
    swizzled row of the tiles), at most 2048 (the block keeps per-channel
    sums and the prologue's scale and shift in shared memory), and x and
    w on 16-byte boundaries (TMA's rule); "window_tf32" (the window
    design's TF32 branch) for f32 where ``torch.backends.cudnn.allow_tf32``
    is True, Co >= 8 (Co = 1 would fill one column of an n8 tile), the
    branch's weights fit a block (:func:`_tf32_fits`) and, for Ci >= 8,
    TMA takes x's windows (Ci a multiple of 4, x on 16 bytes); "window"
    for everything else (every shape the first design, tile, took before
    it). A fixed function of dtype, shape, alignment and the flag: a
    launch on any route that fails raises."""
    ci, co = x.shape[3], w.shape[3]
    if (x.dtype == torch.bfloat16 and ci % 64 == 0 and co % 64 == 0 and max(ci, co) <= 2048
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "sm90"
    if (x.dtype == torch.float32 and co >= 8 and torch.backends.cudnn.allow_tf32
            and (ci < 8 or (ci % 4 == 0 and x.data_ptr() % 16 == 0))
            and _tf32_fits(x.shape[1], x.shape[2], ci, co)):
        return "window_tf32"
    return "window"


def tf32_round(t):
    """f32 ``t`` rounded to TF32 (10 mantissa bits) as the TF32 branch
    rounds its operands (``cvt.rna.tf32.f32``): to nearest on the low 13
    bits of the mantissa, ties away from zero; inf and NaN stay as they
    are, and a finite value past TF32's largest rounds to inf. Plain
    torch, on any device: the card's comparisons round the plain
    version's operands with it."""
    bits = t.contiguous().view(torch.int32)
    # adding half of the dropped part to the magnitude carries into the
    # kept bits (and the exponent) exactly where rounding away would
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t)


# The window design's plan (csrc/conv3x3_window.cu; its Layout mirrors
# _window_smem): 128 threads a block, a tile of at most 128 output pixels
_WINDOW_PIXELS = 128
_SMEM_BLOCK = 232_448  # a block's largest dynamic shared memory on the H100
_SMEM_SM = 233_472  # an SM's, of which the card keeps 1 KB a block
_SMEM_TWO = _SMEM_SM // 2 - 1024  # the most a block may take for two to share an SM
_F32_RESIDENT = 49_152  # f32: the 9 taps' weights stay in shared memory up to this


def _tf32_blocks_sm(ci, bn):
    """Blocks an SM the TF32 kernels' registers allow: the dense kernel's
    two warpgroups (256 threads) take 189 registers at 64 channels a block
    (one block), at most 128 below; the packed one's 128 threads at most
    161 (ptxas on the H100)."""
    return 1 if ci >= 8 and bn == 64 else 2


class WindowPlan(NamedTuple):
    """ti images x th output rows x tw columns a tile; bn output channels
    a block (grid_y slices of Co); kc input channels a chunk (chunks of
    them; bf16 with Ci < 16 and TF32 with Ci < 8 pack the taps: kc = Ci);
    stages of the window (bf16, TF32: 2 or 3 overlap the next units'
    loads with this one's math); smem,
    the dynamic shared memory; tiles, the pixel tiles of a channel slice,
    which grid_x persistent blocks walk."""
    ti: int
    th: int
    tw: int
    bn: int
    kc: int
    chunks: int
    stages: int
    smem: int
    tiles: int
    grid_x: int
    grid_y: int


def _up(v, m):
    return -(-v // m) * m


def _window_smem(bf16, ci, bn, kc, stages, slots, tf32=False):
    """(dynamic shared memory, chunks) of a window-design block (``tf32``:
    the f32 TF32 branch's): the C side's make_layout
    (csrc/conv3x3_window.cu), which refuses a launch whose plan says
    other bytes."""
    if tf32:
        # the weights of all chunks (K = 9 * Ci8 dense, 9 * Ci rounded up
        # to 8 packed; packed in K-major rows of K + 4 f32), then the window
        # stages (packed: slots of Ci f32; dense: of kc f32, on 128 bytes,
        # with 128 bytes kept to align them), then the packed slot table or
        # the dense stages' TMA barriers
        packed = ci < 8
        ci8 = _up(ci, 8)
        kc = ci if packed else kc
        chunks = 1 if packed else -(-ci8 // kc)
        rows = _up(9 * ci, 8) if packed else 9 * ci8
        if packed:
            smem = _up(bn * (rows + 4) * 4, 16) + stages * _up(slots * ci * 4, 16) + rows * 4
        else:  # two warpgroups, `stages` window stages and barriers each
            smem = (_up(bn * rows * 4, 128) + 2 * stages * _up(slots * kc * 4, 128)
                    + 16 * stages + 128)
    elif bf16:
        packed = ci < 16
        kc = ci if packed else kc
        cp = ci if packed else kc + 8
        chunks = 1 if packed else -(-_up(ci, 16) // kc)
        rows = _up(9 * ci, 16) if packed else 9 * kc
        bnp = bn + 8 if (bn // 8) % 2 == 0 else bn
        win, wts = _up(slots * cp * 2, 16), _up(rows * bnp * 2, 16)
        stage = win if chunks == 1 else win + wts
        smem = (wts if chunks == 1 else 0) + stages * stage + (rows * 4 if packed else 0)
    else:
        cp = kc + 4 if (kc // 4) % 2 == 0 else kc
        chunks = -(-_up(ci, 4) // kc)
        tap = _up(kc * bn * 4, 16)
        resident = chunks == 1 and 9 * tap <= _F32_RESIDENT  # all 9 taps' weights kept
        smem = _up(slots * cp * 4, 16) + (9 if resident else 2) * tap
    return smem + 2 * bn * 4, chunks


@functools.cache
def _window_plan(n, h, w, ci, co, bf16, sms, tf32=False) -> WindowPlan:
    """The window design's tiling of an (n, h, w) output of ci -> co
    channels on a card of ``sms`` SMs (``tf32``: f32 through the TF32
    branch), a fixed function of them:
    - the tile: whole images where one fits in 128 pixels (several
      images a tile: 2 at 7x7 and 8x8, 8 at 4x4), else rows of at most
      16 columns (tw = ceil(w / ceil(w / 16)): 14 at 28, 16 at 32 and 64)
      and as many rows as fit;
    - bn: Co rounded up to 8, 16, 32 or 64 in bf16 (an n8 tile of
      mma.sync each 8), to 1, 8, 16, 32 or 64 in f32 (a thread's register
      tile), 64 a block and several blocks along Co above;
    - then, while fewer than two blocks an SM would have work, fewer
      images a tile (not narrower bn: at R-MG-34's 7x7 and 14x14 shapes
      the card ran 32 and 64 channels a block faster than 16 and 32 with
      twice the blocks, NVIDIA H100 80GB HBM3 at 700 W);
    - kc, bn and the stages: the whole Ci in one chunk with the weights
      kept (bf16) where that fits two blocks an SM; else narrower bn,
      one stage, chunks of 64, 32, 16 channels; then one block an SM; then
      fewer images a tile. f32 takes chunks of up to 64 channels (one
      chunk, and tile's f32 order, up to Ci = 64) and one window stage.
    - TF32 with Ci >= 8 (wgmma) tiles by m64 units of 8 x 8 pixels of
      one image: 8 columns, 16 rows, or 2 images of 8 rows where H <= 8
      (rows and columns past the image computed on zeros, not stored);
      with Ci < 8 (mma.sync) as f32. Ci >= 8 runs two warpgroups a block
      on one copy of the weights, each with its own window stages. The
      weights of all of Ci stay for the block's life, so it tries the
      widest bn first, then two blocks an SM before one, then the widest
      chunk of Ci (rounded up to 8), then three window stages (two with
      Ci < 8) before fewer: at the saliency forward's 64x64x64->64, 64
      channels a block, one block an SM, one stage of 32 channels a
      warpgroup (on the card the fastest of the plans that fit, as at its
      32x32 and 16x16 shapes; NVIDIA H100 80GB HBM3 at 700 W).
    Raises ValueError where no plan fits a block's shared memory."""
    if tf32 and ci >= 8:
        tw, th = 8, 8 if h <= 8 else 16
        ti = min(n, 2) if th == 8 else 1
    else:
        tw = -(-w // -(-w // 16))
        th = min(h, _WINDOW_PIXELS // tw)
        ti = min(n, max(1, _WINDOW_PIXELS // (th * tw))) if th == h else 1
    if bf16 or tf32 or co > 1:
        bn = min(64, max(8, 1 << (co - 1).bit_length()))
    else:
        bn = 1

    def pixel_tiles(ti):
        return -(-n // ti) * -(-h // th) * -(-w // tw)

    while ti > 1 and pixel_tiles(ti) * -(-co // bn) < 2 * sms and not tf32:
        ti = -(-ti // 2)
    if tf32:
        kcs = [ci] if ci < 8 else [_up(ci, 8)] + [k for k in (64, 32, 16, 8) if k < _up(ci, 8)]
        bns = [bn >> i for i in range(4) if bn >> i >= 8]
        order = [(b, budget, stages, kc) for b in bns for budget in (_SMEM_TWO, _SMEM_BLOCK)
                 for kc in kcs for stages in ((2, 1) if ci < 8 else (3, 2, 1))]
    else:
        if bf16:
            kcs = [ci] if ci < 16 else [_up(ci, 16)] + [k for k in (64, 32, 16)
                                                        if k < _up(ci, 16)]
            bns = [bn >> i for i in range(4) if bn >> i >= 8]
        else:
            kc = min(64, _up(ci, 4))
            kcs = [kc] + [k for k in (32, 16, 8, 4) if k < kc]
            bns = [bn]
        order = [(b, budget, stages, kc) for budget in (_SMEM_TWO, _SMEM_BLOCK) for kc in kcs
                 for b in bns for stages in ((2, 1) if bf16 else (1,))]
    while True:
        slots = ti * (th + 2) * (tw + 2)
        for b, budget, stages, kc in order:
            smem, chunks = _window_smem(bf16, ci, b, kc, stages, slots, tf32)
            if smem > budget:
                continue
            tiles, grid_y = pixel_tiles(ti), -(-co // b)
            per_sm = min(_tf32_blocks_sm(ci, b) if tf32 else 4, _SMEM_SM // (smem + 1024))
            grid_x = min(tiles, max(1, -(-per_sm * sms // grid_y)))
            return WindowPlan(ti, th, tw, b, kc, chunks, stages, smem, tiles, grid_x, grid_y)
        if ti == 1:
            raise ValueError(f"conv3x3 window design: no plan fits {_SMEM_BLOCK} bytes of "
                             f"shared memory at {n}x{h}x{w}x{ci}->{co}")
        ti = -(-ti // 2)


@functools.cache
def _tf32_fits(h, w, ci, co) -> bool:
    """Whether the TF32 branch has a plan for ci -> co at an h x w grid:
    its weights stay in shared memory, so very wide Ci does not fit. A
    tile of one image is the plan's last resort at any batch, so batch 1
    decides; the input's rows (h) bound the output's."""
    try:
        _window_plan(1, h, w, ci, co, False, 1, tf32=True)
    except ValueError:
        return False
    return True


@functools.cache
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_y_in(y_in, x, w, pads):
    """Raise unless ``y_in`` is a contiguous tensor of the output's shape
    and dtype on x's device."""
    shape = (x.shape[0], out_rows(x, *pads), x.shape[2], w.shape[3])
    if (y_in.dtype != x.dtype or tuple(y_in.shape) != shape or not y_in.is_contiguous()
            or y_in.device != x.device):
        raise ValueError(f"conv3x3: y_in must be a contiguous {x.dtype} {shape} tensor on "
                         f"{x.device}, got {tuple(y_in.shape)} {y_in.dtype} on {y_in.device}")


def _launch(kernel, route, x, w, b, vectors, relu_out, with_stats, pads=(1, 1), y_in=None):
    n, _, wd, ci = x.shape
    h = out_rows(x, *pads)
    if h < 1:
        raise ValueError(f"{kernel}: {x.shape[1]} input rows under pads {pads} leave no output")
    co = w.shape[3]
    if y_in is not None:
        if kernel != "conv3x3" or route == "tile":
            raise ValueError(f"{kernel} through {route}: takes no y_in")
        _check_y_in(y_in, x, w, pads)
        if y_in.data_ptr() % 16:  # the kernels read y_in as they write y, up to 16 bytes
            raise ValueError("conv3x3: y_in must lie on 16 bytes")
        vectors = (y_in,)
    elif kernel == "conv3x3":
        vectors = (None,)
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    stats = torch.zeros((2, co), dtype=torch.float32, device=x.device)
    if y.numel():
        bf16 = x.dtype == torch.bfloat16
        tf32 = route == "window_tf32"
        plan = ()
        if route in ("window", "window_tf32"):
            p = _window_plan(n, h, wd, ci, co, bf16, _sms(x.device.index or 0), tf32)
            plan = (p.ti, p.th, p.tw, p.bn, p.kc, p.stages, p.grid_x, p.smem)
        entry = "mg_" + kernel + {"sm90": "_sm90", "window": "_window", "window_tf32": "_window",
                                  "tile": ""}[route]
        kind = 2 if tf32 else int(bf16)  # the window entry's branch; tile's is_bf16
        kernels.launch(kernel, entry, x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                       *(0 if v is None else v.data_ptr() for v in vectors), y.data_ptr(),
                       stats.data_ptr(), n, h, wd, ci, co, w.stride(1), int(relu_out),
                       int(with_stats), kind, *pads, *plan, route=route,
                       padded=tuple(pads) != (1, 1), summed=y_in is not None)
    return y, stats


def conv3x3_forward(x, w, b, *, relu_out=False, with_stats=True, pad_top=1, pad_bottom=1,
                    y_in=None):
    """The forward alone: CPU tensors take the plain version; CUDA
    tensors launch the kernel (the design :func:`_route` picks) or
    raise."""
    if x.device.type == "cpu":
        if y_in is not None:
            _check_y_in(y_in, x, w, (pad_top, pad_bottom))
        return conv3x3_plain(x, w, b, relu_out=relu_out, with_stats=with_stats,
                             pad_top=pad_top, pad_bottom=pad_bottom, y_in=y_in)
    _check("conv3x3", x, w, b)
    return _launch("conv3x3", _route(x, w), x, w, b, (), relu_out, with_stats,
                   (pad_top, pad_bottom), y_in)


def conv3x3_bn_relu_in_forward(x, w, b, scale, shift, *, relu_out=False, with_stats=True,
                               pad_top=1, pad_bottom=1):
    """The forward alone: CPU tensors take the plain version; CUDA
    tensors launch the kernel (the design :func:`_route` picks) or
    raise."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_in_plain(x, w, b, scale, shift, relu_out=relu_out,
                                        with_stats=with_stats, pad_top=pad_top,
                                        pad_bottom=pad_bottom)
    _check("conv3x3_bn_relu_in", x, w, b, (("scale", scale), ("shift", shift)))
    return _launch("conv3x3_bn_relu_in", _route(x, w), x, w, b, (scale, shift), relu_out,
                   with_stats, (pad_top, pad_bottom))


def _design_forward(design, x, w, b, scale, shift, relu_out, with_stats, pads):
    if scale is None:
        _check("conv3x3", x, w, b)
        return _launch("conv3x3", design, x, w, b, (), relu_out, with_stats, pads)
    _check("conv3x3_bn_relu_in", x, w, b, (("scale", scale), ("shift", shift)))
    return _launch("conv3x3_bn_relu_in", design, x, w, b, (scale, shift), relu_out, with_stats,
                   pads)


def _tile_forward(x, w, b, scale=None, shift=None, *, relu_out=False, with_stats=True,
                  pad_top=1, pad_bottom=1):
    """The forward of conv3x3 (or of conv3x3_bn_relu_in, given scale and
    shift) through the tile design at any shape, on CUDA tensors.
    Private: only for holding the designs against each other and
    timing them at one shape (chip_smoke.py, tests/test_torch_cuda.py)."""
    return _design_forward("tile", x, w, b, scale, shift, relu_out, with_stats,
                           (pad_top, pad_bottom))


def _window_forward(x, w, b, scale=None, shift=None, *, relu_out=False, with_stats=True,
                    pad_top=1, pad_bottom=1):
    """As :func:`_tile_forward`, through the window design at any shape
    (also where :func:`_route` picks sm90); f32 through its FMA branch,
    whatever ``allow_tf32`` says (the TF32 branch runs where the route
    takes it)."""
    return _design_forward("window", x, w, b, scale, shift, relu_out, with_stats,
                           (pad_top, pad_bottom))


def _conv_grads(gy, x, w, need_x, need_w, pads=(1, 1)):
    """(dx, dw) of y = conv3x3(x, w) under ``pads`` for the NHWC cotangent
    gy: cuDNN dgrad and wgrad on the channels_last views (the CPU's conv
    backward on a CPU tensor); under per-side padding, of the conv with W
    padding alone of x with its zero rows added, dx cropped to x's rows.
    Each is None where not needed."""
    if pads == (1, 1):
        xp, padding = x, [1, 1]
    else:
        xp, padding = _pad_rows(x, *pads).contiguous(), [0, 1]
    dx, dw, _ = torch.ops.aten.convolution_backward(
        nchw(gy.contiguous()), nchw(xp), w.permute(3, 2, 0, 1), None, [1, 1], padding, [1, 1],
        False, [0, 0], 1, [need_x, need_w, False])
    if need_x:
        dx = nhwc(dx)
        if pads != (1, 1):
            dx = dx[:, pads[0]:pads[0] + x.shape[1]].contiguous()
    return (dx if need_x else None), (dw.permute(2, 3, 1, 0) if need_w else None)


def _relu_out_grad(gy, y, relu_out):
    return gy * (y > 0) if relu_out else gy


class _Conv3x3(torch.autograd.Function):
    """Its backward sees None for an output that no loss reads (a scale
    whose output is discarded) and returns None: nothing is
    differentiated behind it. The output is a new tensor; ``y_in``'s
    gradient is the output's, through the ReLU's mask as the conv's."""

    @staticmethod
    def forward(ctx, x, w, b, y_in, relu_out, with_stats, pad_top, pad_bottom):
        y, stats = conv3x3_forward(x, w, b, relu_out=relu_out, with_stats=with_stats,
                                   pad_top=pad_top, pad_bottom=pad_bottom, y_in=y_in)
        ctx.relu_out, ctx.pads = relu_out, (pad_top, pad_bottom)
        ctx.save_for_backward(x, w, y if relu_out else None)
        ctx.mark_non_differentiable(stats)
        ctx.set_materialize_grads(False)
        return y, stats

    @staticmethod
    def backward(ctx, gy, _gstats):
        if gy is None:
            return (None,) * 8
        x, w, y = ctx.saved_tensors
        gy = _relu_out_grad(gy, y, ctx.relu_out)
        need_x, need_w, need_b, need_y_in = ctx.needs_input_grad[:4]
        dx, dw = _conv_grads(gy, x, w, need_x, need_w, ctx.pads)
        db = gy.float().sum(dim=_AXES) if need_b else None
        return dx, dw, db, (gy if need_y_in else None), None, None, None, None


class _Conv3x3BnReluIn(torch.autograd.Function):
    """As `_Conv3x3`: a None cotangent gives None."""

    @staticmethod
    def forward(ctx, x, w, b, scale, shift, relu_out, with_stats, pad_top, pad_bottom):
        y, stats = conv3x3_bn_relu_in_forward(x, w, b, scale, shift, relu_out=relu_out,
                                              with_stats=with_stats, pad_top=pad_top,
                                              pad_bottom=pad_bottom)
        ctx.relu_out, ctx.pads = relu_out, (pad_top, pad_bottom)
        # the normalized input is recomputed in the backward, not kept
        ctx.save_for_backward(x, w, scale, shift, y if relu_out else None)
        ctx.mark_non_differentiable(stats)
        ctx.set_materialize_grads(False)
        return y, stats

    @staticmethod
    def backward(ctx, gy, _gstats):
        if gy is None:
            return (None,) * 9
        x, w, scale, shift, y = ctx.saved_tensors
        gy = _relu_out_grad(gy, y, ctx.relu_out)
        need_x, need_w, need_b, need_scale, need_shift = ctx.needs_input_grad[:5]
        z = x.float() * scale + shift
        xn = torch.relu(z).to(x.dtype)
        need_z = need_x or need_scale or need_shift
        dxn, dw = _conv_grads(gy, xn, w, need_z, need_w, ctx.pads)
        dx = dscale = dshift = None
        if need_z:
            dz = dxn.float() * (z > 0)
            dx = (dz * scale).to(x.dtype) if need_x else None
            dscale = (dz * x.float()).sum(dim=_AXES) if need_scale else None
            dshift = dz.sum(dim=_AXES) if need_shift else None
        db = gy.float().sum(dim=_AXES) if need_b else None
        return dx, dw, db, dscale, dshift, None, None, None, None


def conv3x3(x, w, b, *, relu_out=False, with_stats=True, pad_top=1, pad_bottom=1, y_in=None):
    """x (N, H, W, Ci) NHWC; w (3, 3, Ci, Co) HWIO; b (Co,) f32.
    Returns (y (N, H, W, Co) in x.dtype, stats (2, Co) f32, zeros when
    ``with_stats`` is False). The f32 accumulator starts at the bias;
    stats sum the f32 values after the ReLU and before the cast.
    ``y_in`` (contiguous, y's shape and dtype; a running part sum) is
    added to the accumulator before the rounding and the ReLU; y is a
    new tensor.

    ``w`` may be a slice of a wider HWIO weight along its input
    channels (a view), as the multigrid exchange passes it.
    ``pad_top`` / ``pad_bottom`` 0: x carries a halo row on that side
    instead of the zero pad (the module's head).
    Differentiable in x, w, b and y_in (not through stats). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise; under
    ``torch.export``, the op ``mgtpu::conv3x3`` (inference only). A span
    (`mgtpu_torch.trace`), ``conv3x3``."""
    if torch.compiler.is_exporting():
        from mgtpu_torch.ops import library  # noqa: F401 (registers the op)

        return torch.ops.mgtpu.conv3x3(x, w, b, relu_out, with_stats, pad_top, pad_bottom, y_in)
    with trace.span("conv3x3"):
        return _Conv3x3.apply(x, w, b, y_in, relu_out, with_stats, pad_top, pad_bottom)


def conv3x3_bn_relu_in(x, w, b, scale, shift, *, relu_out=False, with_stats=True, pad_top=1,
                       pad_bottom=1):
    """conv3x3(relu(x * scale + shift), w, b) with the conv's zero
    padding kept: pad positions are not activations, so they stay 0
    even where relu(shift) > 0. ``scale`` and ``shift`` are contiguous
    f32 (Ci,) tensors (a BatchNorm's batch scale and shift). The
    normalized input is rounded to x.dtype before the conv and never
    stored. Under per-side padding halo rows are normalized too.
    Differentiable in x, w, b, scale and shift (not through
    stats). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise; under ``torch.export``, the op
    ``mgtpu::conv3x3_bn_relu_in`` (inference only). A span
    (`mgtpu_torch.trace`), ``conv3x3_bn_relu_in``."""
    if torch.compiler.is_exporting():
        from mgtpu_torch.ops import library  # noqa: F401 (registers the op)

        return torch.ops.mgtpu.conv3x3_bn_relu_in(x, w, b, scale, shift, relu_out, with_stats,
                                                  pad_top, pad_bottom)
    with trace.span("conv3x3_bn_relu_in"):
        return _Conv3x3BnReluIn.apply(x, w, b, scale, shift, relu_out, with_stats, pad_top,
                                      pad_bottom)
