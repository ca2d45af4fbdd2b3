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
each conv part is one :func:`quant_i8` (the activation quantizer, one
kernel launch with a static scale) and one
`mgtpu_torch.ops.cuda_conv_i8.conv_i8` launch whose epilogue
dequantizes, adds the part sum and, on a conv's last part, the bias; on
a CUDA tensor both launch their kernels or raise.

Across ranks (`mgtpu_torch.nn.batch_group`, which every eval step
enters): a dynamic scale is the whole tensor's, as JAX's ``jnp.max``
over a batch- or H-sharded array is. Each rank holds its rows of the
batch, its H-slab, or a whole (replicated) tensor, so the absmax is
all-reduced with MAX over every rank of the mesh before the divide
(:func:`mesh_absmax`): one scalar all-reduce a dynamic conv part. A max
over copies of one tensor is that tensor's, so the rule is the same for
all three. Static scales, `calibrate` (whole batches, no group) and the
``torch.export`` op (one device) take none.
"""

from __future__ import annotations

import functools
import itertools

import torch
import torch.distributed as dist
from torch import nn

from mgtpu_torch import kernels
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
    """This rank's absmax (f32, one element, on the rank's device) made
    the mesh's, in place: all-reduced with MAX over every rank (data x
    model) of the mesh active in `batch_group`; as it is without one."""
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
        sx = torch.clamp_min(mesh_absmax(xf.abs().amax()) / _127(x.device), 1e-12)
    x8 = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return x8, sx


def quant_i8_plain(x: torch.Tensor, sx: torch.Tensor | None = None, up=None):
    """:func:`quantize_act`, then for an exchange's "up" part (``up`` =
    (oh, ow)) the nearest 2x upsample of the int8 values cropped to
    (oh, ow): the JAX layers' int8 "up" part (quantized at coarse
    resolution; nearest upsampling commutes with the quantize)."""
    x8, sx = quantize_act(x, sx)
    return (x8 if up is None else upsample_nearest2(x8, *up)), sx


def quant_i8(x: torch.Tensor, sx: torch.Tensor | None = None, up=None):
    """:func:`quant_i8_plain` in one pass: (x8, sx). On a CUDA tensor the
    `mgtpu_torch/csrc/quant_i8.cu` kernels: with a static ``sx`` (a 0-d
    f32 tensor on the card) one ``mg_quant_i8`` launch; without, a
    dynamic scale, ``mg_absmax`` (the |x| max into a zeroed f32), across
    ranks `mesh_absmax` of it, then ``mg_quant_i8``, which computes
    ``sx`` from it as `quantize_act` does and returns it as a 0-d tensor
    on the card (no synchronisation without a mesh).
    Both launches count as ``quant_i8``. ``x`` is a contiguous NHWC f32
    or bf16 tensor. Bit-equal to the plain version; a NaN quantizes to 0
    on both. CPU tensors take the plain version; CUDA tensors launch the
    kernels or raise; under ``torch.export``, the op ``mgtpu::quant_i8``
    (`mgtpu_torch.ops.library`)."""
    if torch.compiler.is_exporting():
        from mgtpu_torch.ops import library  # noqa: F401 (registers the op)

        x8, scales = torch.ops.mgtpu.quant_i8(x, sx, None if up is None else list(up))
        return x8, (sx if sx is not None else scales[1])
    if x.device.type == "cpu":
        return quant_i8_plain(x, sx, up)
    x8, scales = _launch(x, sx, up)
    return x8, (sx if scales is None else scales[1])


def quant_i8_forward(x: torch.Tensor, sx: torch.Tensor | None = None, up=None):
    """`quant_i8` as the op ``mgtpu::quant_i8`` computes it: (x8,
    scales), ``scales`` None where ``sx`` is given, else a new (2,) f32
    tensor whose element 1 is the dynamic scale (element 0 is the absmax
    on the card, the scale again on the CPU)."""
    if x.device.type == "cpu":
        x8, s = quant_i8_plain(x, sx, up)
        return x8, (None if sx is not None else torch.stack((s, s)))
    return _launch(x, sx, up)


def _launch(x: torch.Tensor, sx: torch.Tensor | None, up):
    """The kernels of `quant_i8` on a CUDA tensor: (x8, None) with a
    static ``sx``, else (x8, the (absmax, sx) pair on the card)."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"quant_i8: needs a contiguous NHWC f32 or bf16 x, got "
                         f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
    n, h, w, c = x.shape
    oh, ow = (h, w) if up is None else up
    if not x.numel() or (up is not None and not (0 < oh <= 2 * h and 0 < ow <= 2 * w)):
        raise ValueError(f"quant_i8: input {tuple(x.shape)}, up {up}")
    if sx is not None and (sx.dtype != torch.float32 or sx.numel() != 1
                           or sx.device != x.device):
        raise ValueError(f"quant_i8: sx must be one f32 on {x.device}, got "
                         f"{tuple(sx.shape)} {sx.dtype} on {sx.device}")
    x8 = torch.empty((n, oh, ow, c), dtype=torch.int8, device=x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    shape = (n, h, w, c, oh, ow, int(up is not None), is_bf16)
    if sx is not None:
        kernels.launch("quant_i8", "mg_quant_i8", x.device, x.data_ptr(), sx.data_ptr(), 0, 0,
                       x8.data_ptr(), *shape)
        return x8, None
    scales = torch.empty(2, device=x.device)  # the absmax, then sx
    kernels.launch("quant_i8", "mg_absmax", x.device, x.data_ptr(), scales.data_ptr(), x.numel(),
                   is_bf16)
    mesh_absmax(scales[:1])  # mg_quant_i8 reads the absmax from scales[0]
    kernels.launch("quant_i8", "mg_quant_i8", x.device, x.data_ptr(), 0, scales.data_ptr(),
                   scales.data_ptr() + 4, x8.data_ptr(), *shape)
    return x8, scales


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
