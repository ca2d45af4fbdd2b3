"""int8 x int8 -> int32 NHWC convolutions with the int8 layers' epilogue:
the CUDA kernel's wrappers and their plain versions.

The JAX package's int8 serving conv, `mgtpu/ops/quant.py::conv_i8`, is
``lax.conv_general_dilated`` on int8 NHWC/HWIO operands with an int32
result, which XLA lowers and fuses with the dequant, the part sums and
the bias of `mgtpu/nn.py`'s int8 branch; it calls no Pallas kernel.
PyTorch has no int8 convolution on CUDA and runs eagerly, so the port has
its own kernel, `mgtpu_torch/csrc/conv_i8.cu`, whose epilogue does that
fusion: the int32 sums, or in f32 or bf16

    y = relu?([y_in +] cast(float(acc) * (sx * v)) [+ cast(bias)])

each step rounded as torch rounds it (the plain version is that torch
sequence). Four designs; :func:`_route` picks one from shape and
alignment alone, and counts in ``kernels.ROUTES[("conv_i8", design)]``:

- ``sm90`` (`csrc/conv_i8.cu`; TMA + wgmma s8): 3x3/s1/p1 parts with
  channel counts and offsets multiples of 16, reading the weight from its
  K-major copy (:func:`pack_weight`);
- ``stem`` (`csrc/conv_i8_stem.cu`): Ci < 16 with k * k * Ci <= 160 and
  Co of 16, 32 or 64 (the 7x7/2 and 3x3 stems on 3 and 1 channels), x at
  any byte offset, the tile's input rows staged in shared memory by the
  plan of :func:`_stem_plan`;
- ``1x1`` (`csrc/conv_i8_1x1.cu`): 1x1/s1/p0 parts with Ci, Co and the
  packed weight's row and offset multiples of 16 and x on a 16-byte
  boundary, a GEMM of the pixels by the packed weight;
- ``simple`` (`csrc/conv_i8.cu`, the first design, from the HWIO weight):
  everything else (the 1x1 heads on 10 channels).

Per-side H padding (``pad_top``, ``pad_bottom``, each 0..``pad``; None
is ``pad``): an H-slab under -spatial carries its neighbours' rows
where a side has no zero padding, so x has the slab's rows and the
halo's, and the output (H + pad_top + pad_bottom - k) // stride + 1
rows; W keeps ``pad``. (pad, pad) is the plain launch, bit for bit;
any other pair is the halo mode, counted in
``kernels.PADDED[("conv_i8", design)]``. CPU tensors
take the plain version; CUDA tensors launch the kernel or raise. Under
``torch.export`` the call is the custom op ``mgtpu::conv_i8``
(`mgtpu_torch.ops.library`), which writes a new tensor instead of the
part sum.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from mgtpu_torch import kernels, trace
from mgtpu_torch.ops.resample import nchw, nhwc

# output dtype -> the kernel's out_kind
_OUT_KINDS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
# design -> its C entry point
_ENTRIES = {"sm90": "mg_conv_i8_sm90", "stem": "mg_conv_i8_stem", "1x1": "mg_conv_i8_1x1",
            "simple": "mg_conv_i8"}
DESIGNS = tuple(_ENTRIES)


def out_size(n: int, k: int, stride: int, pad: int, pad_end: int | None = None) -> int:
    """Output extent of a k-tap, zero-padded conv along a side of n:
    ``pad`` zeros before it and ``pad_end`` (None: ``pad``) after."""
    return (n + pad + (pad if pad_end is None else pad_end) - k) // stride + 1


def _pads(pad: int, pad_top, pad_bottom) -> tuple[int, int]:
    """(pad_top, pad_bottom), None taken as ``pad``; raises outside
    0..pad."""
    pads = tuple(pad if p is None else p for p in (pad_top, pad_bottom))
    if not all(0 <= p <= pad for p in pads):
        raise ValueError(f"conv_i8: pad_top {pads[0]} and pad_bottom {pads[1]} must be in "
                         f"0..{pad}")
    return pads


def pack_weight(w8: torch.Tensor) -> torch.Tensor:
    """A (k, k, Ci, Co) HWIO weight as the K-major (Co, k*k*Ci) matrix the
    ``sm90`` design reads (wgmma takes 8-bit operands K-major only): row
    co holds slot ``tap * Ci + c`` = w8[tap // k, tap % k, c, co]."""
    k, _, ci, co = w8.shape
    return w8.permute(3, 0, 1, 2).reshape(co, k * k * ci).contiguous()


def _slice(w8) -> tuple[int, int]:
    """(Ci of the whole weight, the slice's first input channel) of an
    HWIO input-channel slice of a weight whose storage starts at its
    element 0 (a conv's ``w8`` buffer)."""
    co = w8.shape[3]
    return w8.stride(1) // co, w8.storage_offset() // co


def conv_i8_plain(x8, w8, stride: int, pad: int, v=None, dtype=torch.int32, *, sx=None,
                  y_in=None, bias=None, relu=False, pad_top=None, pad_bottom=None):
    """``F.conv2d`` in float64 on the int8 values, converted to int32
    (``pad_top`` / ``pad_bottom`` zero rows added first, then H unpadded).
    Exact: every product is at most 127^2 and every sum (at most 7*7*512
    taps of them here) far below 2^53, so no order of summation rounds.
    The round before the conversion only guards against a library
    algorithm that is not a plain sum of products. With ``v`` (Co,) f32,
    the int8 layers' sequence in ``dtype`` (the JAX layers'
    ``(acc.astype(f32) * (sx * scale)).astype(dtype)``, then the part sum
    and the bias in the compute dtype): ``(acc.float() * (sx * v))`` cast,
    added into ``y_in`` (in place, as the kernel does), ``+ bias.to(dtype)``
    and ReLU (:func:`epilogue_plain`). ``sx`` is a 0-d f32 tensor; without it the dequant vector is
    ``v`` itself."""
    pads = _pads(pad, pad_top, pad_bottom)
    xd = nchw(x8).double()
    if pads != (pad, pad):
        xd = F.pad(xd, (0, 0, *pads))
    y = F.conv2d(xd, w8.permute(3, 2, 0, 1).double(), stride=stride,
                 padding=pad if pads == (pad, pad) else (0, pad))
    acc = nhwc(y.round()).to(torch.int32)
    if v is None:
        return acc
    return epilogue_plain(acc, v, dtype, sx=sx, y_in=y_in, bias=bias, relu=relu)


def epilogue_plain(acc, v, dtype, *, sx=None, y_in=None, bias=None, relu=False):
    """The epilogue of `conv_i8_plain` on its int32 sums ``acc``; with
    ``y_in`` the result is ``y_in`` itself, as the kernel's (each in-place
    op rounds as its out-of-place form)."""
    y = (acc.float() * (v if sx is None else sx * v)).to(dtype)
    if y_in is not None:
        y = y_in.add_(y)
    if bias is not None:
        y.add_(bias.to(dtype))
    return y.relu_() if relu else y


# the stem design's limits: Ci below 16, at most STEM_SLOTS taps x
# channels, Co one of STEM_CO (the channel tile), a plan within a block's
# shared memory and 16-bit patch offsets
STEM_SLOTS = 160
STEM_CO = (16, 32, 64)
STEM_SMEM = 227 * 1024
_STEM_TILE = 128  # output pixels a tile
_STEM_STEPS = 7   # k32 steps at most: k * round_up(k * Ci, 4) <= 160 + 3k, k <= 12


class _StemPlan(ctypes.Structure):
    """conv_i8_stem.cu StemPlan, field for field"""
    _fields_ = [*((f, ctypes.c_int) for f in ("run", "steps", "lm", "rm", "pitch", "lead",
                                              "rows", "patch_bytes", "smem")),
                ("off", ctypes.c_uint16 * (_STEM_STEPS * 4 * 2))]


@functools.cache
def _stem_plan(w: int, ci: int, co: int, k: int, stride: int, pad: int, es: int) -> _StemPlan:
    """The stem design's plan of a k x k/``stride``/``pad`` conv of a
    W = ``w`` wide map of ``ci`` -> ``co`` channels, ``es`` bytes an output
    element (the kernel recomputes it and refuses one that differs):

    - K: slot kh * run + kw * Ci + c, ``run`` = k * Ci rounded up to 4
      (weight 0 past k * Ci), ``steps`` k32 steps;
    - a tile is 128 output pixels in (oh, ow) order within one image; its
      patch holds the whole input rows they read, ``rows`` at most
      (tiles start at multiples of gcd(128, OW) within a row);
    - ``lm`` and ``rm``: the bytes left and right of a row's W * Ci data
      that taps read (the conv's zero padding), zeroed in the patch;
    - ``pitch``: W * Ci plus a multiple of 16 that holds both margins and
      16 bytes of each side's copy (aligned down and up to 16 bytes). As
      pitch = W * Ci mod 16, every row of a tile lands at the same offset
      ``lead`` + (address of its first row) % 16, with ``lead`` = ``lm``
      rounded up to 16, whatever x's byte offset;
    - ``off`` [step][t][h]: where slot group q = 8 step + 4h + t (slots
      4q .. 4q + 3, contiguous in input row kh = 4q // run) lies past a
      pixel's base: kh * pitch + 4q - kh * run; 0 past the k rows (weight
      0); lane t of a warp loads groups (step, t, 0) and (step, t, 1);
    - ``patch_bytes`` (one of two buffers) and the block's ``smem``: the
      two patches, the staged output tile (128 rows of Co * es + 16
      bytes), the weight (Co x 32 * steps bytes), the dequant
      factors and biases, four mbarriers."""
    ow = out_size(w, k, stride, pad)
    row = w * ci
    plan = _StemPlan()
    plan.run = 4 * -(-k * ci // 4)
    plan.steps = -(-k * plan.run // 32)
    plan.lm = pad * ci
    plan.rm = ci * max(0, (ow - 1) * stride - pad + k - w)
    l16, r16 = max(plan.lm, 16), max(plan.rm, 16)
    plan.pitch = row + 16 * -(-(l16 + r16) // 16)
    plan.lead = 16 * -(-plan.lm // 16)
    g = math.gcd(_STEM_TILE, ow)
    plan.rows = ((ow - g + _STEM_TILE - 1) // ow) * stride + k
    plan.patch_bytes = 16 * -(-((plan.rows - 1) * plan.pitch + plan.lead + 15 + row + r16) // 16)
    plan.smem = (2 * plan.patch_bytes + _STEM_TILE * (co * es + 16) + co * 32 * plan.steps
                 + 8 * co + 32)
    for st in range(plan.steps):
        for t in range(4):
            for h in range(2):
                q = 8 * st + 4 * h + t
                kh = 4 * q // plan.run
                if kh < k:
                    plan.off[(st * 4 + t) * 2 + h] = kh * plan.pitch + 4 * q - kh * plan.run
    return plan


def _stem_takes(w: int, ci: int, co: int, k: int, stride: int, pad: int) -> bool:
    """Whether the stem design takes the shape: Ci < 16, k * k * Ci <=
    STEM_SLOTS, Co in STEM_CO, the plan (f32 output: the larger) within
    STEM_SMEM and its offsets within 16 bits."""
    if not (ci < 16 and k * k * ci <= STEM_SLOTS and co in STEM_CO):
        return False
    plan = _stem_plan(w, ci, co, k, stride, pad, 4)
    return plan.smem <= STEM_SMEM and (k - 1) * plan.pitch + plan.run <= 0xFFFF


def _route(x8, w8, stride: int, pad: int, wk=None) -> str:
    """The design a CUDA launch of these operands takes, a fixed function
    of shape and alignment (a launch on any route that fails raises):
    "sm90" (TMA and wgmma) for a 3x3/s1/p1 conv with Ci and Co multiples
    of 16, the K-major weight's row (``wk``'s Ci total, or Ci where no
    ``wk`` is given and the slice is packed on its own) and the slice's
    offset in it multiples of 16 (TMA's 16-byte strides and base) and x
    on a 16-byte boundary; "stem" for Ci < 16 where :func:`_stem_takes`
    (x at any offset); "1x1" for a 1x1/s1/p0 conv with Ci, Co, the
    weight's row and offset multiples of 16 and x on a 16-byte boundary;
    "simple" for everything else."""
    k, ci, co = w8.shape[0], x8.shape[3], w8.shape[3]
    ci_total, ofs = _slice(w8) if wk is not None else (ci, 0)
    sixteens = (ci % 16 == 0 and co % 16 == 0 and ci_total % 16 == 0 and ofs % 16 == 0
                and x8.data_ptr() % 16 == 0)
    if (k, stride, pad) == (3, 1, 1) and sixteens:
        return "sm90"
    if _stem_takes(x8.shape[2], ci, co, k, stride, pad):
        return "stem"
    if (k, stride, pad) == (1, 1, 0) and sixteens:
        return "1x1"
    return "simple"


@functools.cache
def _one(device: torch.device) -> torch.Tensor:
    """1.0 f32 on ``device``: the sx of a dequant given as ``v`` alone
    (1.0 * v is v, bit for bit)."""
    return torch.ones((), device=device)


def _check(x8, w8, stride, pad, v, dtype, sx, y_in, bias, wk, pads):
    """Raise unless the CUDA kernel takes these operands (``pads``: the
    per-side H padding, `_pads`). Returns the output's shape."""
    if x8.device.type != "cuda":
        raise ValueError(f"conv_i8: unsupported device {x8.device}")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"conv_i8: needs int8 x and w, got {x8.dtype}, {w8.dtype}")
    if x8.dim() != 4 or not x8.is_contiguous():
        raise ValueError(f"conv_i8: needs a contiguous NHWC x, got shape {tuple(x8.shape)} "
                         f"strides {x8.stride()}")
    n, h, w, ci = x8.shape
    if w8.dim() != 4 or w8.shape[0] != w8.shape[1] or w8.shape[2] != ci:
        raise ValueError(f"conv_i8: w shape {tuple(w8.shape)} is not (k, k, {ci}, Co)")
    k, co = w8.shape[0], w8.shape[3]
    # rows of (ci, co) contiguous per tap; taps evenly spaced: a dense HWIO
    # weight or its slice along the input channels
    s0, s1, s2, s3 = w8.stride()
    if not (s3 == 1 and s2 == co and s0 == k * s1):
        raise ValueError(f"conv_i8: w strides {w8.stride()} are not an HWIO input-channel slice")
    oh, ow = out_size(h, k, stride, *pads), out_size(w, k, stride, pad)
    if stride < 1 or pad < 0 or min(oh, ow) < 1:
        raise ValueError(f"conv_i8: stride {stride}, pad {pad} and a {k}x{k} kernel leave no "
                         f"output of a {h}x{w} map")
    dev = x8.device
    for name, t in (("v", v), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (co,)
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"conv_i8: {name} must be a contiguous f32 ({co},) tensor on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if sx is not None and (sx.dtype != torch.float32 or sx.numel() != 1 or sx.device != dev):
        raise ValueError(f"conv_i8: sx must be one f32 on {dev}, got {tuple(sx.shape)} "
                         f"{sx.dtype} on {sx.device}")
    shape = (n, oh, ow, co)
    if y_in is not None and (y_in.dtype != dtype or y_in.shape != shape
                             or not y_in.is_contiguous() or y_in.device != dev):
        raise ValueError(f"conv_i8: y_in must be a contiguous {dtype} {shape} tensor on {dev}, "
                         f"got {tuple(y_in.shape)} {y_in.dtype} on {y_in.device}")
    if wk is not None:
        ci_total, ofs = s1 // co, w8.storage_offset() // co
        if (wk.dtype != torch.int8 or wk.shape != (co, k * k * ci_total)
                or not wk.is_contiguous() or ofs + ci > ci_total or wk.device != dev):
            raise ValueError(f"conv_i8: wk {tuple(wk.shape)} {wk.dtype} is not the packed "
                             f"({co}, {k * k * ci_total}) int8 weight of this slice on {dev}")
    if w8.device != dev:
        raise ValueError("conv_i8: all operands must be on one device")
    return shape


def _launch(x8, w8, stride, pad, v, dtype, sx, y_in, bias, relu, wk, route, shape, pads,
            in_place=True):
    n, h, w, ci = x8.shape
    k, co = w8.shape[0], w8.shape[3]
    # the kernel reads y_in and writes y through two pointers, which may be one tensor
    y = y_in if y_in is not None and in_place else torch.empty(shape, dtype=dtype,
                                                                device=x8.device)
    if not y.numel():
        return y
    if route in ("sm90", "1x1"):
        if wk is None:  # the slice packed on its own
            wk, (ci_total, ofs) = pack_weight(w8), (ci, 0)
        else:
            ci_total, ofs = _slice(w8)
        w_ptr, tap_stride = wk.data_ptr() + ofs, ci_total
    else:
        w_ptr, tap_stride = w8.data_ptr(), w8.stride(1)
    plan = ()
    if route == "stem":
        p = _stem_plan(w, ci, co, k, stride, pad, dtype.itemsize)
        plan = (ctypes.byref(p), ctypes.sizeof(p))
    deq = v is not None
    sx_ptr = (_one(x8.device) if sx is None else sx).data_ptr() if deq else 0
    kernels.launch("conv_i8", _ENTRIES[route], x8.device,
                   x8.data_ptr(), w_ptr, sx_ptr, v.data_ptr() if deq else 0,
                   0 if y_in is None else y_in.data_ptr(), 0 if bias is None else bias.data_ptr(),
                   y.data_ptr(), n, h, w, ci, co, k, stride, pad, tap_stride, _OUT_KINDS[dtype],
                   int(relu), *pads, *plan, route=route, padded=pads != (pad, pad))
    return y


def conv_i8(x8, w8, stride: int, pad: int, v=None, dtype=torch.int32, *, sx=None, y_in=None,
            bias=None, relu=False, wk=None, pad_top=None, pad_bottom=None):
    """x8 (N, H, W, Ci) int8 NHWC, w8 (k, k, Ci, Co) int8 HWIO (or its
    slice along Ci) -> (N, OH, OW, Co) int32 sums of the conv with
    ``stride`` and zero padding ``pad``; with ``v`` (Co,) f32 and
    ``dtype`` f32 or bf16, the epilogue in the same launch: the dequant
    ``cast(float(acc) * (sx * v), dtype)`` (``sx`` a 0-d f32 tensor, the
    activation scale; without it ``v`` alone), added into the running
    part sum ``y_in`` (which takes the result: the output is ``y_in``
    itself), plus ``bias`` (Co,) f32 rounded to ``dtype``, then ReLU.
    ``wk`` is :func:`pack_weight` of the whole weight ``w8`` slices (its
    ``sm90`` operand; without it the slice is packed per call).
    ``pad_top`` / ``pad_bottom`` (0..``pad``, None: ``pad``) replace
    ``pad`` above and below x: the halo mode of an H-slab whose
    neighbours' rows x carries (see the module's head). The kernel
    rounds each step as the plain version does: the two are equal bit for
    bit. CPU tensors take the plain version; CUDA tensors launch the
    kernel (the design :func:`_route` picks) or raise; under
    ``torch.export``, the op ``mgtpu::conv_i8``. A span
    (`mgtpu_torch.trace`), ``conv_i8``."""
    if torch.compiler.is_exporting():
        from mgtpu_torch.ops import library  # noqa: F401 (registers the op)

        return torch.ops.mgtpu.conv_i8(x8, w8, stride, pad, v, dtype, sx, y_in, bias, relu, wk,
                                       pad_top, pad_bottom)
    with trace.span("conv_i8"):
        return conv_i8_forward(x8, w8, stride, pad, v, dtype, sx=sx, y_in=y_in, bias=bias,
                               relu=relu, wk=wk, pad_top=pad_top, pad_bottom=pad_bottom)


def conv_i8_forward(x8, w8, stride: int, pad: int, v=None, dtype=torch.int32, *, sx=None,
                    y_in=None, bias=None, relu=False, wk=None, in_place=True, pad_top=None,
                    pad_bottom=None):
    """`conv_i8` without the export branch: the op ``mgtpu::conv_i8``'s
    implementation. With ``in_place`` False the result is a new tensor
    and ``y_in`` is only read."""
    if (v is None) != (dtype == torch.int32) or dtype not in _OUT_KINDS:
        raise TypeError(f"conv_i8: out dtype {dtype} with v {'absent' if v is None else 'given'}")
    if v is None and (sx is not None or y_in is not None or bias is not None or relu):
        raise TypeError("conv_i8: sx, y_in, bias and relu need a dequantized output (v)")
    if x8.device.type == "cpu":
        if y_in is not None and not in_place:
            y_in = y_in.clone()
        return conv_i8_plain(x8, w8, stride, pad, v, dtype, sx=sx, y_in=y_in, bias=bias,
                             relu=relu, pad_top=pad_top, pad_bottom=pad_bottom)
    pads = _pads(pad, pad_top, pad_bottom)
    shape = _check(x8, w8, stride, pad, v, dtype, sx, y_in, bias, wk, pads)
    return _launch(x8, w8, stride, pad, v, dtype, sx, y_in, bias, relu, wk,
                   _route(x8, w8, stride, pad, wk), shape, pads, in_place)


def _simple_forward(x8, w8, stride: int, pad: int, v=None, dtype=torch.int32, *, sx=None,
                    y_in=None, bias=None, relu=False, pad_top=None, pad_bottom=None):
    """`conv_i8` on a CUDA tensor through the simple design at any shape
    (for comparisons: the main path takes the design :func:`_route`
    picks)."""
    pads = _pads(pad, pad_top, pad_bottom)
    shape = _check(x8, w8, stride, pad, v, dtype, sx, y_in, bias, None, pads)
    return _launch(x8, w8, stride, pad, v, dtype, sx, y_in, bias, relu, None, "simple", shape,
                   pads)
