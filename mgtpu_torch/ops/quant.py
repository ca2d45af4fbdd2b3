"""Post-training int8 quantization for serving (counterpart of
`mgtpu/ops/quant.py`).

The scheme is the JAX package's, detail for detail:
  - weights: per-output-channel symmetric int8,
    ``scale[co] = max(max|w[..., co]| / 127, 1e-12)`` and
    ``w8 = clip(round(w / scale), -127, 127)`` (round half to even);
  - activations: per-tensor symmetric int8 over the whole tensor, the
    batch included, computed from each conv input on the fly (dynamic),
    or frozen by :func:`calibrate` as the largest such scale over a few
    batches (static, ``sx``);
  - the conv sums int8 x int8 in int32 and is dequantized to the compute
    dtype, ``cast(float(acc) * (sx * scale))``; bias, BN and ReLU run on
    that unchanged.

:func:`quantize_model` turns, in place, every conv of the model whose
kernel is not 2x2 (the U-Nets' transposed-conv upsamplers stay float) into
a quantized one: its f32 weight gives way to the buffers ``w8`` (int8,
HWIO), ``scale`` (f32, (Co,)) and, once calibrated, ``sx`` (f32, one
scale a slot). A slot is one input of the conv: a plain conv has one;
`ConvBN.conv_parts` numbers its exchange parts in their order (down,
same, up). The layers of `mgtpu_torch.nn` branch on ``conv.quantized``:
a multigrid layer quantizes all its conv parts in one
:func:`quant_i8_group` call (`nn.quantize_layer`: the activation
quantizer, one kernel launch a layer with static scales), a conv outside
one its input in one :func:`quant_i8` call (a group of one); then each
conv part is one `mgtpu_torch.ops.cuda_conv_i8.conv_i8` launch whose
epilogue dequantizes, adds the part sum and, on a conv's last part, the
bias; on a CUDA tensor both launch their kernels or raise.

Across ranks (`mgtpu_torch.nn.batch_group`, which every eval step
enters): a dynamic scale is the whole tensor's, as JAX's ``jnp.max``
over a batch- or H-sharded array is. Each rank holds its rows of the
batch, its H-slab, or a whole (replicated) tensor, so the absmaxes are
all-reduced with MAX over every rank of the mesh before the divide
(:func:`mesh_absmax`): one all-reduce of a layer's absmax vector. A max
over copies of one tensor is that tensor's, so the rule is the same for
all three. Static scales, `calibrate` (whole batches, no group) and the
``torch.export`` ops (one device) take none.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import struct

import torch
import torch.distributed as dist
from torch import nn

from mgtpu_torch import kernels, trace
from mgtpu_torch.ops.cuda_conv_i8 import conv_i8, conv_i8_plain  # noqa: F401 (re-exported)
from mgtpu_torch.ops.resample import upsample_nearest2
from mgtpu_torch.parallel import axis


@functools.cache
def _127(device: torch.device) -> torch.Tensor:
    """127 as an f32 tensor on ``device``. Dividing by it divides: torch on
    CUDA multiplies by the reciprocal when the divisor is a host scalar,
    which can differ from x / 127 in the last bit."""
    return torch.full((), 127.0, device=device)


def quantize_kernel(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 of an HWIO kernel:
    ``{"w8": int8 (k, k, ci, co), "scale": f32 (co,)}``, bit for bit the
    JAX package's."""
    w = w.detach().float()
    scale = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)) / _127(w.device), 1e-12)
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"w8": w8, "scale": scale}


def mesh_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """This rank's absmaxes (an f32 vector, one a dynamic conv part of a
    layer, on the rank's device) made the mesh's, in place: one
    all-reduce with MAX over every rank (data x model) of the mesh active
    in `batch_group`; as they are without one. MAX is exact, so the bits
    are each part's absmax over the whole tensor."""
    mesh = axis.ACTIVE
    if mesh is not None:
        dist.all_reduce(absmax, dist.ReduceOp.MAX, group=mesh.all_ranks)
    return absmax


def quantize_act(x: torch.Tensor, sx: torch.Tensor | None = None):
    """Per-tensor symmetric int8 of ``x``: (x8, sx). Without ``sx`` (a
    0-d f32 tensor, a calibrated static scale) the scale is the absmax of
    the whole tensor, the batch included, over 127; across ranks the
    whole tensor's (:func:`mesh_absmax` between the max and the divide).
    ``x`` goes to f32 before the divide."""
    xf = x.float()
    if sx is None:
        sx = _scales(mesh_absmax(xf.abs().amax()))
    x8 = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return x8, sx


def _scales(absmax: torch.Tensor) -> torch.Tensor:
    """The dynamic scales of the (mesh's) absmaxes: max(absmax / 127,
    1e-12), a NaN kept."""
    return torch.clamp_min(absmax / _127(absmax.device), 1e-12)


def quant_i8_plain(x: torch.Tensor, sx: torch.Tensor | None = None, up=None):
    """:func:`quantize_act`, then for an exchange's "up" part (``up`` =
    (oh, ow)) the nearest 2x upsample of the int8 values cropped to
    (oh, ow): the JAX layers' int8 "up" part (quantized at coarse
    resolution; nearest upsampling commutes with the quantize)."""
    x8, sx = quantize_act(x, sx)
    return (x8 if up is None else upsample_nearest2(x8, *up)), sx


def quant_i8_group_plain(members) -> list:
    """:func:`quant_i8_plain` member by member over ``members``, [(x, sx
    or None, up or None)]: [(x8, sx)]. The dynamic members' absmaxes are
    taken first and made the mesh's in one :func:`mesh_absmax` (one
    all-reduce a group, as the kernels' path makes it); each scale is
    then quantize_act's, bit for bit."""
    dynamic = [j for j, (_, sx, _) in enumerate(members) if sx is None]
    scales = {}
    if dynamic:
        absmax = torch.stack([members[j][0].float().abs().amax() for j in dynamic])
        scales = dict(zip(dynamic, _scales(mesh_absmax(absmax)).unbind()))
    return [quant_i8_plain(x, scales.get(j, sx), up) for j, (x, sx, up) in enumerate(members)]


def quant_i8_group(members) -> list:
    """The activation quantizer of a multigrid layer: every quantized-conv
    input of the layer in one pass. ``members`` is [(x, sx, up)]: a
    contiguous NHWC f32 or bf16 ``x``, its static scale ``sx`` (a 0-d f32
    tensor on x's device) or None for a dynamic one, and ``up`` (oh, ow)
    for an exchange's "up" part (quantized at coarse resolution, stored
    nearest-upsampled 2x and cropped) or None. Returns [(x8, sx)], each
    bit for bit :func:`quant_i8_plain`'s (a NaN quantizes to 0), a given
    ``sx`` returned as it is.

    CPU tensors take :func:`quant_i8_group_plain`. CUDA tensors launch
    the `mgtpu_torch/csrc/quant_i8.cu` group design or raise: with static
    scales one ``mg_quant_i8_group`` launch for up to MAX_MEMBERS members
    (a longer group is split); with dynamic ones first ``mg_absmax_group``
    into the group's zeroed absmax vector, then across ranks one
    :func:`mesh_absmax` of the whole vector, then ``mg_quant_i8_group``,
    which computes each scale as `quantize_act` does and writes it to the
    group's scale vector (no synchronisation without a mesh). Every launch
    counts as ``quant_i8`` and as its design ``group``. Under
    ``torch.export``, the op ``mgtpu::quant_i8_group``
    (`mgtpu_torch.ops.library`). A span (`mgtpu_torch.trace`),
    ``quant_i8``."""
    members = [(x, sx, None if up is None else tuple(up)) for x, sx, up in members]
    if torch.compiler.is_exporting():
        from mgtpu_torch.ops import library  # noqa: F401 (registers the op)

        x8s, scales = torch.ops.mgtpu.quant_i8_group(
            [m[0] for m in members], [m[1] for m in members],
            [v for _, _, up in members for v in (up or (0, 0))])
        return _with_scales(members, x8s, scales)
    with trace.span("quant_i8"):
        if all(x.device.type == "cpu" for x, _, _ in members):
            return quant_i8_group_plain(members)
        return _with_scales(members, *_launch_group(members))


def quant_i8(x: torch.Tensor, sx: torch.Tensor | None = None, up=None):
    """One quantize: (x8, sx), a group of one (:func:`quant_i8_group`),
    for the convs outside a multigrid layer (the heads, the 1x1
    shortcuts, the plain nets). Under ``torch.export``, the op
    ``mgtpu::quant_i8``."""
    if torch.compiler.is_exporting():
        from mgtpu_torch.ops import library  # noqa: F401 (registers the op)

        x8, scales = torch.ops.mgtpu.quant_i8(x, sx, None if up is None else list(up))
        return x8, (sx if sx is not None else scales[1])
    return quant_i8_group([(x, sx, up)])[0]


def _with_scales(members, x8s, scales) -> list:
    """[(x8, sx)]: a static member's own sx, a dynamic one's the next
    element of row 1 of ``scales`` (the group's (absmax, sx) rows)."""
    dyn = iter(range(0 if scales is None else scales.shape[-1]))
    return [(x8, sx if sx is not None else scales[1, next(dyn)])
            for x8, (_, sx, _) in zip(x8s, members)]


def quant_i8_forward(x: torch.Tensor, sx: torch.Tensor | None = None, up=None):
    """`quant_i8` as the op ``mgtpu::quant_i8`` computes it: (x8,
    scales), ``scales`` None where ``sx`` is given, else a new (2,) f32
    tensor whose element 1 is the dynamic scale (element 0 is the absmax
    on the card, the scale again on the CPU)."""
    x8s, scales = quant_i8_group_forward([(x, sx, up)])
    return x8s[0], (None if sx is not None else scales[:, 0])


def quant_i8_group_forward(members):
    """`quant_i8_group` as the op ``mgtpu::quant_i8_group`` computes it:
    (x8s, scales), ``scales`` a new (2, dynamic members) f32 tensor whose
    row 1 holds the dynamic scales in member order (row 0 the absmaxes
    on the card, the scales again on the CPU), None without a dynamic
    member."""
    if all(x.device.type == "cpu" for x, _, _ in members):
        out = quant_i8_group_plain(members)
        sxs = [s for (_, sx, _), (_, s) in zip(members, out) if sx is None]
        return [x8 for x8, _ in out], torch.stack((torch.stack(sxs),) * 2) if sxs else None
    return _launch_group(members)


# the group design (quant_i8.cu, namespace group): the most members one
# launch takes (a longer group is split), the threads a block, the items a
# thread takes at most, and the blocks an SM holds (the kernels'
# __launch_bounds__)
MAX_MEMBERS, GROUP_THREADS, GROUP_MAX_ITEMS, GROUP_BLOCKS_PER_SM = 8, 256, 2, 3


class _Member(ctypes.Structure):
    """quant_i8.cu group::Member, field for field"""
    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p), ("sx", ctypes.c_void_p),
                *((f, ctypes.c_int) for f in ("slot", "n", "h", "w", "c", "oh", "ow", "up",
                                              "bf16", "vec", "items", "tile0"))]


class _Table(ctypes.Structure):
    """quant_i8.cu group::Table: the member table a launch takes by value"""
    _fields_ = [("m", _Member * MAX_MEMBERS), ("count", ctypes.c_int), ("tiles", ctypes.c_int),
                ("per_thread", ctypes.c_int)]


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _group_plan(items: tuple, sms: int) -> tuple:
    """The work plan of one group launch over members of ``items`` work
    items each: (per_thread, grid, tiles, (tile0, ...)). A tile is
    per_thread * GROUP_THREADS items of one member; tile0 is the prefix
    sum of the earlier members' tiles. per_thread is the most items a
    thread (up to GROUP_MAX_ITEMS) that still gives every resident block
    of the card a tile, else 1 (a small layer: the most blocks); the grid
    is the tiles, at most one resident wave. Cached: a net's layers form a
    few plans."""
    if not 0 < len(items) <= MAX_MEMBERS:
        raise ValueError(f"quant_i8: {len(items)} members, 1 to {MAX_MEMBERS} a launch")
    resident = GROUP_BLOCKS_PER_SM * sms
    for per_thread in range(GROUP_MAX_ITEMS, 0, -1):
        size = per_thread * GROUP_THREADS
        counts = [-(-i // size) for i in items]
        if sum(counts) >= resident:
            break
    tile0 = tuple(sum(counts[:j]) for j in range(len(counts)))
    return per_thread, min(sum(counts), resident), sum(counts), tile0


def _vec(x: torch.Tensor, x8: torch.Tensor | None, up) -> bool:
    """Whether a member takes 16-value lanes: a quantize (``x8`` given) as
    mg_quant_i8's VEC path (16 consecutive values without up, 16 channels
    of a pixel with it; x and x8 on 16-byte boundaries), an absmax (x8
    None) 16 values of the flat x on a 16-byte boundary."""
    if x8 is None:
        return x.numel() % 16 == 0 and x.data_ptr() % 16 == 0
    lanes = x.shape[3] % 16 == 0 if up is not None else x.numel() % 16 == 0
    return lanes and x.data_ptr() % 16 == 0 and x8.data_ptr() % 16 == 0


# a _Member's fields as struct packs them (the same native layout): the
# table is packed in two calls, not set field by field through ctypes,
# which took three times the host time
_MEMBER_FORMAT = "PPP12i"
assert struct.calcsize("@" + _MEMBER_FORMAT) == ctypes.sizeof(_Member)


def _group_table(rows, sms: int) -> tuple[_Table, int]:
    """(the member table, the grid) of one launch over ``rows``, [(x, x8
    or None for an absmax launch, sx or None, slot, up)]."""
    vecs = [_vec(x, x8, up) for x, x8, _, _, up in rows]
    items = tuple(x.numel() // 16 if v else x.numel() for (x, *_), v in zip(rows, vecs))
    per_thread, grid, tiles, tile0 = _group_plan(items, sms)
    fields = []
    for (x, x8, sx, slot, up), v, n_items, t0 in zip(rows, vecs, items, tile0):
        n, h, w, c = x.shape
        fields += (x.data_ptr(), 0 if x8 is None else x8.data_ptr(),
                   0 if sx is None else sx.data_ptr(), slot, n, h, w, c,
                   *((h, w) if up is None else up), int(up is not None),
                   int(x.dtype == torch.bfloat16), int(v), n_items, t0)
    buf = bytearray(ctypes.sizeof(_Table))
    struct.pack_into("@" + _MEMBER_FORMAT * len(rows), buf, 0, *fields)
    struct.pack_into("@3i", buf, _Table.count.offset, len(rows), tiles, per_thread)
    return _Table.from_buffer(buf), grid


def _checked(x: torch.Tensor, sx, up, device) -> None:
    """Raise unless the kernels take the member (x, sx, up) on ``device``."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"quant_i8: needs a contiguous NHWC f32 or bf16 x, got "
                         f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
    if x.device != device:
        raise ValueError(f"quant_i8: a group on {x.device} and {device}")
    n, h, w, c = x.shape
    oh, ow = (h, w) if up is None else up
    if not x.numel() or (up is not None and not (0 < oh <= 2 * h and 0 < ow <= 2 * w)):
        raise ValueError(f"quant_i8: input {tuple(x.shape)}, up {up}")
    # 32-bit index math in the group design
    if max(x.numel(), n * oh * ow * c) >= 2**31:
        raise ValueError(f"quant_i8: {tuple(x.shape)} -> {(n, oh, ow, c)} has 2**31 values "
                         f"or more")
    if sx is not None and (sx.dtype != torch.float32 or sx.numel() != 1
                           or sx.device != device):
        raise ValueError(f"quant_i8: sx must be one f32 on {device}, got "
                         f"{tuple(sx.shape)} {sx.dtype} on {sx.device}")


def _launch_group(members):
    """The group design's launches over ``members`` on one card: (x8s,
    scales), ``scales`` the (2, dynamic members) f32 (absmax, sx) rows on
    the card, row 1 written by the quantize launches (None without a
    dynamic member)."""
    device = members[0][0].device
    for x, sx, up in members:
        _checked(x, sx, up, device)
    x8s = [torch.empty((x.shape[0], *(x.shape[1:3] if up is None else up), x.shape[3]),
                       dtype=torch.int8, device=device) for x, _, up in members]
    dynamic = [j for j, (_, sx, _) in enumerate(members) if sx is None]
    slots = dict(zip(dynamic, range(len(dynamic))))
    scales = torch.empty((2, len(dynamic)), device=device) if dynamic else None
    absmax, sx_out = (scales[0].data_ptr(), scales[1].data_ptr()) if dynamic else (None, None)
    sms = _sms(device.index if device.index is not None else torch.cuda.current_device())
    for i in range(0, len(dynamic), MAX_MEMBERS):
        rows = [(members[j][0], None, None, slots[j], None) for j in dynamic[i:i + MAX_MEMBERS]]
        table, grid = _group_table(rows, sms)
        kernels.launch("quant_i8", "mg_absmax_group", device, ctypes.byref(table),
                       ctypes.sizeof(table), grid, absmax, len(dynamic),
                       len(dynamic) if i == 0 else 0, route="group")
    if dynamic:
        mesh_absmax(scales[0])  # the group's one all-reduce across ranks
    for i in range(0, len(members), MAX_MEMBERS):
        rows = [(x, x8s[j], sx, slots.get(j, -1), up)
                for j, (x, sx, up) in enumerate(members[i:i + MAX_MEMBERS], start=i)]
        table, grid = _group_table(rows, sms)
        kernels.launch("quant_i8", "mg_quant_i8_group", device, ctypes.byref(table),
                       ctypes.sizeof(table), grid, absmax, sx_out, len(dynamic), route="group")
    return x8s, scales


def _part_forward(x: torch.Tensor, sx: torch.Tensor | None = None, up=None):
    """(x8, sx) through the per-part design, ``mg_quant_i8`` (after
    ``mg_absmax`` for a dynamic scale): one launch a part, the kernels'
    first design. Private: only for holding the group design against it
    and timing the two (chip_smoke.py, tests/test_torch_cuda.py); no mesh
    reduction."""
    _checked(x, sx, up, x.device)
    n, h, w, c = x.shape
    oh, ow = (h, w) if up is None else up
    x8 = torch.empty((n, oh, ow, c), dtype=torch.int8, device=x.device)
    shape = (n, h, w, c, oh, ow, int(up is not None), int(x.dtype == torch.bfloat16))
    if sx is not None:
        kernels.launch("quant_i8", "mg_quant_i8", x.device, x.data_ptr(), sx.data_ptr(), 0, 0,
                       x8.data_ptr(), *shape, route="part")
        return x8, sx
    scales = torch.empty(2, device=x.device)  # the absmax, then sx
    kernels.launch("quant_i8", "mg_absmax", x.device, x.data_ptr(), scales.data_ptr(), x.numel(),
                   shape[-1], route="part")
    kernels.launch("quant_i8", "mg_quant_i8", x.device, x.data_ptr(), 0, scales.data_ptr(),
                   scales.data_ptr() + 4, x8.data_ptr(), *shape, route="part")
    return x8, scales[1]


# --- calibration (static activation scales) -------------------------------
class _Collector:
    """The largest dynamic scale each (conv, slot) reported during one
    calibration pass. Each quantized conv of the model holds it as its
    ``calibration`` while the pass runs."""

    def __init__(self):
        self.maxima: dict[nn.Module, dict[int, float]] = {}

    def record(self, conv: nn.Module, slot: int, sx: torch.Tensor) -> None:
        slots = self.maxima.setdefault(conv, {})
        val = float(sx)
        if slot not in slots or val > slots[slot]:
            slots[slot] = val


def record_scale(conv: nn.Module, slot: int, sx: torch.Tensor) -> None:
    """The layers' hook: report one dynamic activation scale. A no-op
    unless a calibration pass is running on ``conv``."""
    if conv.calibration is not None:
        conv.calibration.record(conv, slot, sx)


@torch.no_grad()
def calibrate(model: nn.Module, batches) -> nn.Module:
    """Run ``batches`` (NHWC arrays or tensors, taken as they are: no cast)
    through the quantized ``model`` in eval mode, recording every conv
    input's dynamic scale, and freeze the largest over all batches into
    each conv's ``sx``, slot by slot. Stale ``sx`` are dropped first (a
    frozen scale suppresses the recording). Raises RuntimeError on a
    pass nested in another, and AssertionError (the JAX package's
    error, raised explicitly here) where the slots a conv recorded are
    not 0..n-1, which no scale vector can index. Returns ``model``."""
    convs = [m for m in model.modules() if getattr(m, "quantized", False)]
    if any(c.calibration is not None for c in convs):
        raise RuntimeError("nested calibration passes")
    for c in convs:
        c.sx = None
    device = next(itertools.chain(model.parameters(), model.buffers())).device
    col = _Collector()
    was_training = model.training
    model.eval()
    for c in convs:
        c.calibration = col
    try:
        for x in batches:
            model(torch.as_tensor(x).to(device))
    finally:
        for c in convs:
            c.calibration = None
        model.train(was_training)
    for conv, slots in col.maxima.items():
        n = max(slots) + 1
        if sorted(slots) != list(range(n)):
            raise AssertionError(f"non-contiguous calibration slots {sorted(slots)}")
        conv.sx = torch.tensor([max(slots[i], 1e-12) for i in range(n)], dtype=torch.float32,
                               device=conv.w8.device)
    return model


def quantize_model(model: nn.Module) -> nn.Module:
    """Quantize, in place, the kernel of every `Conv` of ``model`` whose
    kernel is not 2x2 (the JAX package's ``quantize_params`` rule, which
    keeps the U-Nets' 2x2 transposed-conv upsamplers float: the port's
    `ConvTranspose` is 2x2 only and never quantized). Quantizing twice is
    a no-op. Returns ``model``."""
    from mgtpu_torch.nn import Conv

    for m in model.modules():
        if isinstance(m, Conv) and m.k != 2 and not m.quantized:
            m.set_quantized(**quantize_kernel(m.w))
    return model
