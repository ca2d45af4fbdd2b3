"""Layer library of the port (counterpart of `mgtpu/nn.py`).

Layers are ``nn.Module``s; ``.train()`` and ``.eval()`` select the JAX
``train=`` flag. Layouts follow the JAX package at every public
function: activations are NHWC and conv weights HWIO, so the tests
compare like with like and `mgtpu_torch.utils.bridge` copies weights
without transposing them.

``compute_dtype`` follows the JAX ``dtype=`` rules: conv weights and
activations are cast to it; ``Dense`` accumulates in f32 and adds an
f32 bias; BatchNorm computes in f32 in both modes. Parameters are f32
masters, drawn on the CPU from an explicit ``torch.Generator`` and then
moved to ``device``, so a seed gives the same weights on every device.
BatchNorm's running stats are buffers, updated in place by a
train-mode forward (the JAX layer returns them as new stats), except
inside :func:`running_stats_held`.

Under the mesh's second axis (`mgtpu_torch.parallel.axis`, active within
:func:`batch_group`): -spatial runs a layer on an H-slab with the halo
rows its window needs, the 3x3 kernels and the int8 conv with the slab's
per-side padding;
-tensor runs a layer whose output channels are sliced (``module.tp``) on
its slice, its input through ``axis.copy_t`` and its output, after its
BatchNorm and ReLU, through ``axis.gather_c``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

from mgtpu_torch import trace
from mgtpu_torch.ops import cuda_conv_i8, quant
from mgtpu_torch.ops.cuda_conv import bn_relu_plain, conv3x3, conv3x3_bn_relu_in
from mgtpu_torch.ops.resample import nchw, nhwc, upsample_nearest2
from mgtpu_torch.parallel import axis


def cast_to(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    if dtype is None or x.dtype == dtype:
        return x
    return x.to(dtype)


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def conv2d_nhwc(x, w, stride: int = 1, pad: int = 0):
    """NHWC x, HWIO w -> NHWC conv (stock cuDNN / CPU conv). On an
    H-slab (-spatial) the halo rows its window needs come from the
    neighbours (zeros at the image's edges) and the conv pads W alone;
    the output is the slab of the output rows (a strided conv's brought
    to the rule's layout)."""
    g = axis.rows(x)
    if g is None:
        return nhwc(F.conv2d(nchw(x), w.permute(3, 2, 0, 1), stride=stride, padding=pad))
    k = w.shape[0]
    if x.shape[1] % stride or (g + 2 * pad - k) // stride + 1 != g // stride:
        return conv2d_nhwc(axis.gather_h(x), w, stride, pad)
    top, bottom = axis.window_rows(k, stride, pad)
    if top or bottom:
        x = axis.halo(x, top, bottom, fill=0)[0]
    y = axis.mark(nhwc(F.conv2d(nchw(x), w.permute(3, 2, 0, 1), stride=stride,
                                padding=(0, pad))), g // stride)
    return y if stride == 1 else axis.canonical(y)


class Int8Part:
    """A conv part already quantized: its int8 values ``x8`` at the conv's
    resolution (an "up" part's upsampled) and their scale ``sx``, as
    `quantize_layer` hands them to `ConvBN.apply_parts`."""

    __slots__ = ("x8", "sx")

    def __init__(self, x8: torch.Tensor, sx: torch.Tensor):
        self.x8, self.sx = x8, sx


def _int8_quantize(items) -> list:
    """The int8 inputs of quantized convs, all in one `quant.quant_i8_group`
    call (one launch a layer on the card with static scales): ``items``
    is [(conv, slot, xp, up)], each the raw part ``xp`` (no compute-dtype
    cast first) quantized as the JAX layers do, with slot ``slot``'s
    static scale or a dynamic one (the whole tensor's across ranks)
    reported to a running calibration; an "up" part (``up`` (oh, ow))
    quantized at coarse resolution and its int8 values nearest-upsampled
    (nearest only copies values, so this equals quantizing the upsampled
    part). Returns an `Int8Part` an item. An H-slab's int8 values are a
    slab of the same rows (an up part's, of twice the coarse slab's)."""
    out = quant.quant_i8_group([(xp, None if conv.sx is None else conv.sx[slot], up)
                                for conv, slot, xp, up in items])
    for (conv, slot, xp, up), (x8, sx) in zip(items, out):
        if conv.sx is None:
            quant.record_scale(conv, slot, sx)
        g = axis.rows(xp)
        if g is not None:
            axis.mark(x8, 2 * g if up else g)
    return [Int8Part(x8, sx) for x8, sx in out]


def quantize_layer(layers, parts_list) -> list:
    """The conv parts of a multigrid layer, ``layers[i]`` (a `ConvBN`)
    taking ``parts_list[i]`` (`mgtpu_torch.ops.mg.exchange_parts`' lists),
    with every part of a quantized conv replaced by its `Int8Part`: all
    of the layer's in one `_int8_quantize` call, before any conv runs
    (each input of a layer exists before its first conv). An
    un-normalized part is materialized with `bn_relu_plain` first. The
    lists of float convs come back as they are. The quantize is a span
    (`mgtpu_torch.trace`), ``quantize_layer``."""
    items, where = [], []
    for i, (layer, parts) in enumerate(zip(layers, parts_list)):
        if not layer.conv.quantized:
            continue
        oh, ow = _fine_size(parts)
        for slot, (kind, xp) in enumerate(parts):
            if isinstance(xp, tuple):  # un-normalized: (y_raw, scale, shift)
                xp = bn_relu_plain(*xp)
            items.append((layer.conv, slot, xp, (oh, ow) if kind == "up" else None))
            where.append((i, slot))
    if not items:
        return list(parts_list)
    out = [list(parts) for parts in parts_list]
    with trace.span("quantize_layer"):
        for (i, slot), q in zip(where, _int8_quantize(items)):
            out[i][slot] = (out[i][slot][0], q)
    return out


def _fine_size(parts) -> tuple:
    """(oh, ow) of a conv's parts: the size of its "same" and "down" parts
    (an "up" part is upsampled to it)."""
    oh = ow = None
    for kind, xp in parts:
        if kind != "up":
            xr = xp[0] if isinstance(xp, tuple) else xp
            oh, ow = xr.shape[1], xr.shape[2]
    return oh, ow


def _int8_conv(conv, x8, w8, **epilogue):
    """`conv_i8` of the int8 values ``x8`` against ``w8`` with ``conv``'s
    stride, padding, dequant vector and compute dtype, and ``epilogue``'s
    operands. On an H-slab (-spatial) as `conv2d_nhwc` on one: the halo
    rows its window needs come from the neighbours as int8 values (a
    quantize is elementwise once its scale is the whole tensor's, so
    these are the neighbours' rows quantized), left out at the image's
    edges, where the kernel pads (per-side padding); the output is the
    slab of the output rows, a strided conv's brought to the rule's
    layout; a window that does not divide the slab takes the gathered
    whole tensor."""
    s, p = conv.stride, conv.pad
    args = (w8, s, p, conv.scale, conv.compute_dtype or torch.float32)
    g = axis.rows(x8)
    if g is None:
        return cuda_conv_i8.conv_i8(x8, *args, wk=conv.wk, **epilogue)
    k = w8.shape[0]
    if x8.shape[1] % s or (g + 2 * p - k) // s + 1 != g // s:
        return _int8_conv(conv, axis.gather_h(x8), w8, **epilogue)
    top, bottom = axis.window_rows(k, s, p)
    pads = (p, p)
    if top or bottom:
        x8, at_top, at_bottom = axis.halo(x8, top, bottom)
        pads = (top * at_top, bottom * at_bottom)
    y = axis.mark(cuda_conv_i8.conv_i8(x8, *args, wk=conv.wk, pad_top=pads[0],
                                       pad_bottom=pads[1], **epilogue), g // s)
    return y if s == 1 else axis.canonical(y)


class Conv(nn.Module):
    """2D convolution with a bias, NHWC/HWIO, MSR (fan-out) init: std =
    sqrt(2 / (k*k*c_out)), zero bias. `mgtpu_torch.ops.quant.quantize_model`
    can replace the f32 weight ``w`` by the int8 buffers ``w8`` and
    ``scale`` (and, once calibrated, ``sx``: one static activation scale
    a slot) and the non-persistent ``wk``, ``w8`` packed K-major for the
    int8 kernel's sm90 design; quantized, it runs the int8 path
    (`_int8_quantize` of slot 0, then `_int8_conv`), whose conv launch
    adds the bias in the compute dtype."""

    calibration = None  # the calibration pass running on this conv, if any
    tp = None  # the -tensor mesh, where the weight holds this rank's output channels (ConvBN)

    def __init__(self, c_in, c_out, k=3, stride=1, pad=None, compute_dtype=None,
                 device=None, generator=None):
        super().__init__()
        self.c_in, self.c_out, self.k, self.stride = c_in, c_out, k, stride
        self.pad = (0 if k == 1 else 1) if pad is None else pad
        self.compute_dtype = compute_dtype
        w = math.sqrt(2.0 / (k * k * c_out)) * torch.randn((k, k, c_in, c_out),
                                                           generator=_generator(generator))
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(torch.zeros(c_out, device=device))

    def forward(self, x):
        if self.quantized:
            q, = _int8_quantize([(self, 0, x, None)])
            return _int8_conv(self, q.x8, self.w8, sx=q.sx, bias=self.b)
        y = conv2d_nhwc(cast_to(x, self.compute_dtype),
                        cast_to(self.w, self.compute_dtype), self.stride, self.pad)
        return y + self.b.to(y.dtype)

    @property
    def quantized(self) -> bool:
        return "w8" in self._buffers

    def set_quantized(self, w8: torch.Tensor, scale: torch.Tensor) -> None:
        """Drop the f32 weight for its int8 form, or replace the int8 form
        (dynamic scales until calibrated). The K-major copy ``wk`` is
        packed from ``w8`` here, each time: this is the one way to set
        ``w8`` (the bridge and `quantize_model` call it)."""
        if not self.quantized:
            del self.w
        self.register_buffer("w8", w8)
        self.register_buffer("wk", cuda_conv_i8.pack_weight(w8), persistent=False)
        self.register_buffer("scale", scale)
        self.register_buffer("sx", None)


class ConvTranspose(nn.Module):
    """2x2/2 transposed conv (VALID) with a bias, NHWC/HWIO, as
    ``jax.lax.conv_transpose`` computes it: input pixel (i, j) adds
    x[i, j] @ w[1 - a, 1 - b] to output pixel (2i + a, 2j + b).
    ``F.conv_transpose2d`` adds W[a, b] there, so the forward flips the
    kernel in space first. Torch-default uniform init of weight and
    bias, bound 1/sqrt(2*2*c_in). Runs the stock transposed conv on the
    channels_last view, as the JAX package leaves it to XLA."""

    tp = None  # the -tensor mesh, where the weight holds this rank's output channels

    def __init__(self, c_in, c_out, compute_dtype=None, device=None, generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        g = _generator(generator)
        s = 1.0 / math.sqrt(4 * c_in)
        w = (torch.rand((2, 2, c_in, c_out), generator=g) * 2 - 1) * s
        b = (torch.rand((c_out,), generator=g) * 2 - 1) * s
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(b.to(device))

    def forward(self, x):
        """On an H-slab (-spatial) each input row makes two output rows:
        the slab of twice the rows, local; the output in the rule's
        layout. Under -tensor, this rank's output channels (the caller
        gathers them)."""
        if self.tp is not None:
            x = axis.copy_t(x, self.tp)
        g = axis.rows(x)
        w = cast_to(self.w, self.compute_dtype).flip(0, 1).permute(2, 3, 0, 1)  # (Ci, Co, kh, kw)
        y = nhwc(F.conv_transpose2d(nchw(cast_to(x, self.compute_dtype)), w, stride=2))
        y = y + self.b.to(y.dtype)
        if g is not None:
            axis.mark_partial(self.w, self.b)
            axis.mark(y, 2 * g)
        return axis.canonical(y)


def _bn_axes_n(x):
    axes = tuple(range(x.dim() - 1))  # all but the channels
    return axes, math.prod(x.shape[:-1])


_BATCH_GROUP = None  # the data-parallel Mesh BatchNorm sums over, while one is active


@contextlib.contextmanager
def batch_group(mesh):
    """Within it, a train-mode BatchNorm takes its batch moments, and its
    backward its two reductions, over the global batch of ``mesh``'s
    ranks (each rank holding an equal slice): one all-reduce in the
    forward and one in the backward, sums in f32, the running variance's
    n / (n - 1) with the global n. This is the JAX step's BatchNorm under
    a sharded batch (GSPMD reduces over the whole 'data' axis). An
    H-slab's BatchNorm sums over every rank (data x model), a whole or a
    channel-sliced tensor's over the data group. The layers see the
    mesh's second axis (`axis.ACTIVE`) within it. A mesh of one rank, or
    None, changes nothing: every value is the group-less one, bit for
    bit."""
    global _BATCH_GROUP
    on = mesh is not None and (mesh.size > 1 or mesh.n_model > 1)
    old, _BATCH_GROUP = _BATCH_GROUP, mesh if on else None
    old_axis, axis.ACTIVE = axis.ACTIVE, mesh if on else None
    try:
        yield
    finally:
        _BATCH_GROUP, axis.ACTIVE = old, old_axis


def _bn_group(x):
    """(the group BatchNorm's sums over ``x`` take, its number of ranks),
    (None, 1) where they stay on the rank."""
    mesh = _BATCH_GROUP
    if mesh is None:
        return None, 1
    if axis.rows(x) is not None:  # an H-slab: every rank's rows of every batch slice
        return mesh.all_ranks, mesh.size * mesh.n_model
    if mesh.size > 1:
        return mesh.group, mesh.size
    return None, 1


def _bn_moments(x):
    """One-pass f32 batch moments: mean, the biased variance E[x^2] -
    E[x]^2 (as `mgtpu/nn.py::_bn_train_fwd`), and the count n they are
    over. Under `batch_group` the sums (sum x, sum x^2) are all-reduced
    over the group first (`_bn_group`), by the autograd-aware all-reduce:
    where the moments are differentiated (``batch_affine``), gradients
    reach every rank's x through them."""
    xf = x.float()
    axes, n = _bn_axes_n(x)
    group, ranks = _bn_group(x)
    if group is None:
        mean = xf.mean(dim=axes)
        return mean, torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0), n
    sums = dist_fn.all_reduce(torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]),
                              group=group)
    n *= ranks
    mean, sq = (sums / n).chunk(2)
    return mean, torch.clamp_min(sq - mean * mean, 0.0), n


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BN apply with the JAX package's custom VJP
    (`mgtpu/nn.py::_bn_train`): one-pass f32 moments E[x^2] - E[x]^2,
    normalize with the biased variance; the backward takes two
    reductions (sum dy, sum dy*xhat). mean and var feed only the
    running-stat update and are not differentiable."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, var, n = _bn_moments(x)
        inv = torch.rsqrt(var + eps)
        a = inv * scale
        y = (x.float() * a + (bias - mean * a)).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.mark_non_differentiable(mean, var)
        ctx.group, ctx.n = _bn_group(x)[0], n
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        """Under a group, dx takes the global sums, and scale and bias
        their rank's own: the step's mean over the ranks of those
        gradients is the global batch's."""
        x, mean, inv, scale = ctx.saved_tensors
        axes, _ = _bn_axes_n(x)
        n = ctx.n
        gf = gy.float()
        xhat = (x.float() - mean) * inv
        sum_dy = gf.sum(dim=axes)
        sum_dy_xhat = (gf * xhat).sum(dim=axes)
        g_dy, g_dy_xhat = sum_dy, sum_dy_xhat
        if ctx.group is not None:
            sums = torch.cat([sum_dy, sum_dy_xhat])
            dist.all_reduce(sums, group=ctx.group)
            g_dy, g_dy_xhat = sums.chunk(2)
        dx = (scale * inv) * (gf - g_dy / n - xhat * (g_dy_xhat / n))
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None


_RUNNING_STATS_HELD = False


@contextlib.contextmanager
def running_stats_held():
    """Within it, a train-mode BatchNorm normalizes with the batch's
    moments as ever but leaves its running stats as they are: a forward
    that is run again to rebuild activations for the backward
    (``make_train_step(remat=True)``) must not update them a second time.
    In the JAX package the stats are an output of the primal forward
    only."""
    global _RUNNING_STATS_HELD
    held, _RUNNING_STATS_HELD = _RUNNING_STATS_HELD, True
    try:
        yield
    finally:
        _RUNNING_STATS_HELD = held


class BatchNorm(nn.Module):
    """Spatial batch norm over the last axis, computed in f32, returning
    ``x.dtype``. Eval mode normalizes with the running stats. Train mode
    normalizes with the batch's one-pass moments (biased variance) and
    updates the running stats in place with momentum 0.1 and the
    unbiased variance. After `mgtpu_torch.ops.fold` folds it into the
    preceding conv, its parameters and stats are gone (the JAX package's
    empty-dict marker) and it is the identity, in eval mode only."""

    def __init__(self, c, eps=1e-5, momentum=0.1, device=None):
        super().__init__()
        self.c, self.eps, self.momentum = c, eps, momentum
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    @property
    def folded(self) -> bool:
        return self.scale is None

    def drop_folded(self) -> None:
        """Mark as folded: remove the parameters and stats."""
        self.scale = self.bias = self.mean = self.var = None

    def _check_trainable(self):
        if self.folded:
            raise ValueError("BatchNorm was folded (mgtpu_torch.ops.fold): folded "
                             "params serve eval/inference only, not training")

    @torch.no_grad()
    def _update_running(self, mean, var, n):
        if _RUNNING_STATS_HELD:
            return
        m = self.momentum
        self.mean.copy_((1 - m) * self.mean + m * mean)
        self.var.copy_((1 - m) * self.var + m * (var * (n / max(n - 1, 1))))

    def batch_affine(self, x):
        """Train mode, split: the batch's per-channel (scale, shift) f32
        with bn(x) = x * scale + shift, from the same one-pass moments,
        and the running-stat update. Gradients reach x, the affine and
        the moments by autograd, which is the function that the custom
        VJP of ``forward`` computes. For a caller that applies the BN
        elsewhere (the prologue of `conv3x3_bn_relu_in`)."""
        self._check_trainable()
        mean, var, n = _bn_moments(x)
        scale = torch.rsqrt(var + self.eps) * self.scale
        self._update_running(mean.detach(), var.detach(), n)
        if axis.rows(x) is not None:
            axis.mark_partial(self.scale, self.bias)
        return scale, self.bias - mean * scale

    def forward(self, x):
        if self.training:
            self._check_trainable()
            y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias, self.eps)
            self._update_running(mean, var, _bn_axes_n(x)[1] * _bn_group(x)[1])
            if axis.rows(x) is not None:
                axis.mark_partial(self.scale, self.bias)
            return y
        if self.folded:
            return x
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        y = x.float() * inv + (self.bias - self.mean * inv)
        return y.to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout (torch ``nn.Dropout`` semantics): in train mode
    each element is kept with probability 1 - rate and scaled by
    1 / (1 - rate); the identity in eval mode.

    The mask comes from an explicit ``torch.Generator`` on the
    activations' device, never from torch's global RNG. Its seed is
    drawn at construction from ``generator`` (the model's init
    generator), so a model seed gives the same sequence of masks on
    every run; each device's generator starts from that seed when the
    layer first runs there. The JAX package's key stream cannot be
    matched: parity with it is distributional only. Under -spatial an
    H-slab's mask is the rank's rows of the mask drawn at the whole
    height (what a rank without the model axis draws on its batch
    slice); a whole tensor draws the same mask on every model rank, as
    the ranks of a model group share the seed (`parallel.replicate`)."""

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.seed = int(torch.randint(0, 2**62, (), generator=_generator(generator)))
        self._generators: dict[torch.device, torch.Generator] = {}

    def seed_for_rank(self, rank: int) -> None:
        """The masks of data-parallel rank ``rank``: the seed offset by
        it (rank 0 keeps the one-rank masks), so that ranks that built
        the model from one seed drop different elements."""
        self.seed += rank
        self._generators.clear()

    def _generator_on(self, device: torch.device) -> torch.Generator:
        g = self._generators.get(device)
        if g is None:
            g = self._generators[device] = torch.Generator(device=device).manual_seed(self.seed)
        return g

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        g, gen = axis.rows(x), self._generator_on(x.device)
        if g is None:
            mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        else:
            h, j = x.shape[1], axis.spatial().model_rank
            whole = torch.rand((x.shape[0], g, *x.shape[2:]), generator=gen, device=x.device)
            mask = whole[:, j * h:(j + 1) * h] < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """Linear layer, (c_in, c_out) weight, torch-default uniform init,
    zero bias. Accumulates in f32 and adds the f32 bias."""

    tp = None  # the -tensor mesh, where the weight holds this rank's output columns

    def __init__(self, c_in, c_out, compute_dtype=None, device=None, generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        s = 1.0 / math.sqrt(c_in)
        w = (torch.rand((c_in, c_out), generator=_generator(generator)) * 2 - 1) * s
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(torch.zeros(c_out, device=device))

    def forward(self, x):
        # products of compute_dtype values are exact in f32: an f32
        # matmul of the cast operands is the f32-accumulating dot
        if self.tp is not None:
            x = axis.copy_t(x, self.tp)
        x = cast_to(x, self.compute_dtype).float()
        w = cast_to(self.w, self.compute_dtype).float()
        y = torch.matmul(x, w) + self.b
        return y if self.tp is None else axis.gather_c(y, self.tp)


class Sequential(nn.Module):
    """Composes layers; the JAX tree keys them '0', '1', ..."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ConvBN(nn.Module):
    """Conv -> BN [-> ReLU] [-> Dropout]. ``dropout_pos`` "after" drops
    the output behind the ReLU; "before" drops the conv's input (in
    ``conv_parts``, each part with its own mask). A 3x3/s1/p1 conv
    launches the `conv3x3` kernel in ``forward`` as in ``conv_parts``."""

    def __init__(self, c_in, c_out, k=3, stride=1, relu=True, eps=1e-5, dropout=0.0,
                 dropout_pos="after", compute_dtype=None, device=None, generator=None):
        super().__init__()
        if dropout_pos not in ("after", "before"):
            raise ValueError(f"dropout_pos {dropout_pos!r} is not 'after' or 'before'")
        self.k, self.relu, self.dropout_pos = k, relu, dropout_pos
        self.conv = Conv(c_in, c_out, k, stride, compute_dtype=compute_dtype,
                         device=device, generator=generator)
        self.bn = BatchNorm(c_out, eps=eps, device=device)
        self.drop = Dropout(dropout, generator) if dropout > 0 else None

    def _tail(self, y):
        y = self.bn(y)
        if self.relu:
            y = torch.relu(y)
        if self.conv.tp is not None:  # -tensor: the channel slices put together
            y = axis.gather_c(y, self.conv.tp)
        if self.drop is not None and self.dropout_pos == "after":
            y = self.drop(y)
        return y

    def forward(self, x):
        return self.apply_parts([("same", x)])

    @property
    def sums_in_kernel(self) -> bool:
        """Whether `conv_parts` sums the parts in the `conv3x3` kernel's
        epilogue: eval mode, a 3x3/s1/p1 conv, not quantized."""
        conv = self.conv
        return (not self.training and self.k == 3 and conv.stride == 1 and conv.pad == 1
                and not conv.quantized)

    @property
    def ends_in_kernel(self) -> bool:
        """Whether the last `conv3x3` launch of `conv_parts` may finish the
        layer's output (add a residual shortcut, apply the ReLU): it sums
        in the kernel, its BN is folded (the identity in eval mode, as
        dropout is) and it holds all channels (no -tensor)."""
        return self.sums_in_kernel and self.bn.folded and self.conv.tp is None

    def apply_parts(self, parts, short=None, relu=False):
        """Fused-exchange path: conv of the channel concat of ``parts``
        (see `conv_parts`), then BN [and ReLU] [and dropout]. With
        ``short`` (a residual layer's shortcut, as a function that
        computes it) the shortcut is added to that, and ``relu`` applied
        after it. A quantized conv in eval mode whose BN is folded (the
        identity there, as dropout is) takes its ReLU in the last
        `conv_i8` launch. A float one that `ends_in_kernel` takes its
        ReLU, or the shortcut and ``relu``, in the last `conv3x3` launch:
        the shortcut is computed before the conv there and after it
        elsewhere, so train mode runs its ops in their old order."""
        if self.ends_in_kernel and (short is None or not self.relu):
            if short is None:
                return self.conv_parts(parts, relu=self.relu)
            return self.conv_parts(parts, y_in=short(), relu=relu)
        if self.conv.quantized and self.bn.folded and not self.training:
            y = self._int8_parts(parts, relu=self.relu)
        else:
            y = self._tail(self.conv_parts(parts))
        if short is None:
            return y
        y = y + short().to(y.dtype)
        return torch.relu(y) if relu else y

    def conv_parts(self, parts, y_in=None, relu=False):
        """The conv (with its bias, before the BN) of the channel concat
        of ``parts`` (a list of ``(kind, tensor)`` from
        `mgtpu_torch.ops.mg.exchange_parts`) without building the concat,
        as the sum of one conv per part over its slice of the weight's
        input channels. Under "before" dropout in train mode each part
        is first dropped with its own mask, an "up" part materialized at
        fine resolution first (as the JAX layer does). Each part then
        goes one of four ways:

          * a "same" part that arrives un-normalized, as the tuple
            ``(y_raw, scale, shift)`` of the previous ConvBN's raw output
            and its BN's batch scale and shift, under a 3x3 conv: one
            launch of the `conv3x3_bn_relu_in` kernel, which applies
            relu(y_raw * scale + shift) as it reads (other convs take
            the materialized activation);
          * a 3x3/s1/p1 conv of a "same" or "down" part (or of an "up"
            part materialized for an odd partner): one launch of the
            `conv3x3` kernel;
          * an exact-2x "up" part under a 3x3 conv: `_conv_up3`, the
            upsample folded into a stride-2 transposed conv;
          * a k=1 "up" part: the conv at coarse resolution, then the
            upsample of the result.

        The first kernel launch carries the conv bias. Other convs go to
        the stock conv on the materialized part. Differentiable.

        Where the conv `sums_in_kernel` (eval mode) the exact-2x "up"
        part runs first and its output starts the sum, and each `conv3x3`
        launch adds its part to the running sum in its epilogue (its
        ``y_in``) instead of a stock add a part; in train mode the parts
        are summed by stock adds in part order. ``y_in`` (a residual
        layer's shortcut, cast to the compute dtype) starts the sum,
        added to the up part by a stock add, and ``relu`` applies the
        ReLU to the result in the last launch; `apply_parts` passes them
        where the conv `ends_in_kernel`.

        On H-slabs (-spatial; the parts in one layout, `exchange_parts`
        aligns the up part) each 3x3 launch reads the slab with its
        neighbours' edge rows (`axis.halo`) and pads only at the image's
        edges, `_conv_up3` reads one coarse halo row each side, and the
        output is the output rows' slab; the conv's parameters then take
        this rank's share of their gradient (`axis.mark_partial`). Under
        -tensor (``conv.tp``) each part passes `axis.copy_t` and the
        output holds this rank's channels."""
        from mgtpu_torch.ops.mg import materialize_part

        conv = self.conv
        if conv.quantized:
            return self._int8_parts(parts)
        dt = conv.compute_dtype
        w = cast_to(conv.w, dt)  # cast once; each part takes a view of its slice
        is3x3 = self.k == 3 and conv.stride == 1 and conv.pad == 1
        oh = ow = g = None
        for kind, xp in parts:
            if kind != "up":
                xr = xp[0] if isinstance(xp, tuple) else xp
                oh, ow, g = xr.shape[1], xr.shape[2], axis.rows(xr)
        drop = self.drop if self.dropout_pos == "before" and self.training else None
        summing = self.sums_in_kernel
        slices = []  # (kind, part, its first input channel)
        ofs = 0
        for kind, xp in parts:
            slices.append((kind, xp, ofs))
            ofs += (xp[0] if isinstance(xp, tuple) else xp).shape[-1]
        if ofs != w.shape[2]:
            raise ValueError(f"parts carry {ofs} channels, the conv takes {w.shape[2]}")
        if summing:  # the up part's output starts the sum
            slices.sort(key=lambda s: s[0] != "up")
        bias = conv.b
        y = None if y_in is None else cast_to(y_in, dt).contiguous()
        for j, (kind, xp, ofs) in enumerate(slices):
            summed = False
            bn_in = None
            if isinstance(xp, tuple):  # un-normalized: (y_raw, scale, shift)
                xp, *bn_in = xp
                if not is3x3 or drop is not None:
                    xp, bn_in = bn_relu_plain(xp, *bn_in), None
            if conv.tp is not None:
                xp = axis.copy_t(xp, conv.tp)
                bn_in = None if bn_in is None else [axis.copy_t(v, conv.tp) for v in bn_in]
            ws = w[:, :, ofs:ofs + xp.shape[-1], :]
            xp = cast_to(xp, dt)
            if drop is not None:
                if kind == "up":
                    xp, kind = materialize_part(kind, xp, oh, ow), "same"
                xp = drop(xp)
            exact2x = kind == "up" and (oh, ow) == (2 * xp.shape[1], 2 * xp.shape[2])
            if exact2x and is3x3:
                yy = _conv_up3(xp, ws, oh, ow)
            elif kind == "up" and self.k == 1 and conv.stride == 1 and conv.pad == 0:
                yy = upsample_nearest2(conv2d_nhwc(xp, ws), oh, ow)
            else:
                xp = materialize_part(kind, xp, oh, ow)
                if is3x3:
                    b = torch.zeros(ws.shape[3], device=xp.device) if bias is None else bias
                    bias = None
                    pads = (1, 1)
                    if g is not None:  # an H-slab: the neighbours' rows, pads at the edges
                        xp, *pads = axis.halo(xp, 1, 1)
                    if bn_in is None:
                        summed, relu_out = summing, relu and j == len(slices) - 1
                        yy, _ = conv3x3(xp, ws, b, relu_out=relu_out, with_stats=False,
                                        pad_top=pads[0], pad_bottom=pads[1],
                                        y_in=y if summing else None)
                        relu = relu and not relu_out
                    else:
                        yy, _ = conv3x3_bn_relu_in(xp, ws, b, *bn_in, with_stats=False,
                                                   pad_top=pads[0], pad_bottom=pads[1])
                else:
                    yy = conv2d_nhwc(xp, ws, conv.stride, conv.pad)
            y = yy if y is None or summed else y + yy
        if bias is not None:  # no kernel launch took it
            y = y + bias.to(y.dtype)
        if relu:  # no launch applied it
            y = torch.relu(y)
        if g is not None:
            axis.mark_partial(conv.w, conv.b)
            if conv.stride == 1:  # the slab's rows (a strided conv set its own layout)
                axis.mark(y, g)
        return y

    def _int8_parts(self, parts, relu=False):
        """`conv_parts` of a quantized conv, as the JAX layer's int8 branch
        computes it: slot i is part i; each part is quantized with its own
        scale (`quantize_layer`, unless the layer already did: its parts
        are then `Int8Part`s) against its slice of ``w8`` (int32 sums of
        slices add up to the sums of the concat), an un-normalized part
        first materialized with `bn_relu_plain`; the dequantized parts
        are summed in the compute dtype in part order, then the bias is
        added [and the ReLU applied]: each part's `conv_i8` launch adds
        into the sum, the last one adds the bias. Dropout does not apply:
        the int8 path serves only. On H-slabs (-spatial) each launch reads
        the slab with its neighbours' int8 edge rows and pads at the
        image's edges (`_int8_conv`), and the sum is the output rows'
        slab."""
        conv = self.conv
        if not all(isinstance(q, Int8Part) for _, q in parts):
            parts = quantize_layer([self], [parts])[0]
        y = None
        ofs = 0
        for slot, (_, q) in enumerate(parts):
            c = q.x8.shape[-1]
            last = slot == len(parts) - 1
            y = _int8_conv(conv, q.x8, conv.w8[:, :, ofs:ofs + c], sx=q.sx, y_in=y,
                           bias=conv.b if last else None, relu=relu and last)
            ofs += c
        if ofs != conv.w8.shape[2]:
            raise ValueError(f"parts carry {ofs} channels, the conv takes {conv.w8.shape[2]}")
        return y


class UpConvBN(nn.Module):
    """ConvTranspose 2x2/2 -> BN (eps 1e-3) -> ReLU. `mgtpu_torch.ops.fold`
    folds the BN into the transposed conv."""

    def __init__(self, c_in, c_out, compute_dtype=None, device=None, generator=None):
        super().__init__()
        self.conv = ConvTranspose(c_in, c_out, compute_dtype=compute_dtype, device=device,
                                  generator=generator)
        self.bn = BatchNorm(c_out, eps=1e-3, device=device)

    def forward(self, x):
        y = torch.relu(self.bn(self.conv(x)))
        return y if self.conv.tp is None else axis.gather_c(y, self.conv.tp)


def _conv_up3(xp, ws, oh: int, ow: int):
    """conv3x3(nearest_up2(xp), ws, pad=1) without the upsampled tensor:
    the JAX version's stride-2 lhs-dilated conv with the 4x4 kernel
    K[u, v] = sum_{a, b in {0, 1}} W[u-a, v-b] is a stride-2, padding-1
    transposed conv with K flipped in space and its in/out channels
    swapped. Exact-2x only: (oh, ow) == (2h, 2w). On a coarse H-slab
    (-spatial) it reads one neighbour row above and below (zeros at the
    image's edges: the fine conv's zero pad) and pads H by 3, which
    leaves the slab's 2h output rows. The 4x4 kernel's build and the
    transposed conv are a span (`mgtpu_torch.trace`), ``conv_up3``."""
    if (oh, ow) != (2 * xp.shape[1], 2 * xp.shape[2]):
        raise ValueError(f"_conv_up3 needs an exact 2x output, got {(oh, ow)} "
                         f"for input {tuple(xp.shape[1:3])}")
    with trace.span("conv_up3"):
        ci, co = ws.shape[2], ws.shape[3]
        k4 = torch.zeros((4, 4, ci, co), dtype=ws.dtype, device=ws.device)
        for a in (0, 1):
            for b in (0, 1):
                k4[a:a + 3, b:b + 3] += ws
        wt = k4.flip(0, 1).permute(2, 3, 0, 1)  # (Ci, Co, 4, 4)
        if axis.rows(xp) is None:
            return nhwc(F.conv_transpose2d(nchw(xp), wt, stride=2, padding=1))
        xh = axis.halo(xp, 1, 1, fill=0)[0]
        return nhwc(F.conv_transpose2d(nchw(xh), wt, stride=2, padding=(3, 1)))


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
