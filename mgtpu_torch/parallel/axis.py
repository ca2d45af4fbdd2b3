"""The mesh's second axis (counterpart of `constrain_spatial`,
`tp_sharding` and `shard_params_tp` in `mgtpu/parallel/mesh.py`).

The JAX package names the second axis of its data x model mesh 'model'
under ``-spatial`` and 'tensor' under ``-tensor`` and leaves the
collectives to GSPMD. The port makes them by hand, as autograd
Functions over the rank's model group (`Mesh.model_group`: the ranks
of one data index):

``-spatial`` (H-sharded activations). An image-shaped activation of
global height g is split over the group by rows, rank j holding rows
j*g/S .. (j+1)*g/S (a slab), where `spatial_split` says so (JAX's
`constrain_spatial` rule: g % 2S == 0 and g / S >= 8); every other
activation is whole on every rank (replicated). A slab carries its
global height as the attribute ``mg_rows`` (:func:`rows`); while the
forward runs under :func:`tagging`, a torch function mode copies it from
an operation's inputs to each output of the same rows, so elementwise
ops, channel concats and casts keep it. Operations that change the
height set it (:func:`mark`) and bring their output to the rule's
layout (:func:`canonical`). The boundaries:

  * `halo`: a slab with its neighbours' edge rows above and below
    (forward); the halo rows' gradients go back to the neighbours and
    are added to their edge rows (backward). At the image's edges the
    rows are a fill value, or left out (the conv kernels then pad);
  * `gather_h` (slab -> whole; backward: the rank's rows) and `split_h`
    (whole -> slab; backward: the gathered gradient).

A parameter used on slabs gets a partial gradient (its rows' share);
`mark_partial` flags it for the step, which sums those over the model
group. One on whole tensors has the whole gradient on every rank.

``-tensor`` (channel-sharded parameters). `tp_spec` is JAX's
`tp_sharding` rule; `shard_params_tp` keeps each eligible parameter's,
running stat's and momentum's trailing-dim slice on the rank, and marks
the conv, transposed conv and dense layers whose output channels it
sliced (``module.tp``). Such a layer's input goes through `copy_t`
(identity; backward: the sum over the tensor group) and its output,
after its BatchNorm and ReLU, through `gather_c` (all-gather along C;
backward: the rank's slice). Activations between layers are whole.

Every collective is an all-gather or an all-reduce, which gloo takes on
CUDA tensors as on CPU ones (point-to-point calls are not used).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

ACTIVE = None  # the Mesh the running forward's layers see (nn.batch_group sets it)


def spatial_split(h: int, n: int) -> bool:
    """JAX's `constrain_spatial` rule: an activation of global height h
    is split over n model ranks where each keeps >= 8 rows and the 2x2
    pools stay aligned (h % 2n == 0); n of 1 splits nothing."""
    return n > 1 and h % (2 * n) == 0 and h // n >= 8


def tp_spec(shape, n: int) -> tuple:
    """JAX's `tp_sharding` rule for one leaf, as its PartitionSpec's
    entries: the trailing dim (a conv's O, HWIO; a BatchNorm's C; a
    dense layer's outputs) over 'tensor' where it divides n and each
    slice keeps >= 8 channels; else replicated, ()."""
    shape = tuple(shape)
    if n > 1 and len(shape) >= 1 and shape[-1] % n == 0 and shape[-1] // n >= 8:
        return (None,) * (len(shape) - 1) + ("tensor",)
    return ()


def spatial() -> Optional[object]:
    """The active mesh under -spatial (a 'model' axis of more than one
    rank), else None."""
    m = ACTIVE
    return m if m is not None and m.n_model > 1 and m.axis == "model" else None


def rows(x) -> Optional[int]:
    """The global height of a slab, None for a whole tensor."""
    return getattr(x, "mg_rows", None)


def mark(x: torch.Tensor, g: Optional[int]) -> torch.Tensor:
    """Set (g) or clear (None) ``x``'s slab mark; returns ``x``."""
    x.mg_rows = g
    return x


def global_rows(x) -> int:
    g = rows(x)
    return x.shape[1] if g is None else g


def mark_partial(*params) -> None:
    """Flag parameters whose gradient is this rank's share of the rows."""
    for p in params:
        if p is not None:
            p.mg_partial = True


# ------------------------------------------------------------ the mode

def _first_slab(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            if rows(a) is not None:
                return a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor) and rows(b) is not None:
                    return b
    return None


class _Tagging(TorchFunctionMode):
    """Copies a slab's mark from the inputs of each torch call to each
    output tensor of the same batch and rows (NHWC)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        src = _first_slab(args) if args else None
        if src is None and kwargs:
            src = _first_slab(kwargs.values())
        if src is not None:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor) and t.dim() == 4 and t.shape[:2] == src.shape[:2]
                        and rows(t) is None):
                    mark(t, rows(src))
        return out


@contextlib.contextmanager
def tagging(mesh):
    """Within it (under -spatial only), slab marks flow through torch
    calls. The step runs each forward inside."""
    if mesh is None or mesh.n_model == 1 or mesh.axis != "model":
        yield
        return
    with _Tagging():
        yield


# ------------------------------------------------------- collectives

def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in group order."""
    t = t.contiguous()
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.view(n, *t.shape)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in place."""
    dist.all_reduce(t, group=group)
    return t


def _gather_rows(t, mesh):
    """The rows of every rank's ``t`` one after another (N, S*h, ...)."""
    got = _all_gather(t, mesh.model_group, mesh.n_model)
    return got.transpose(0, 1).reshape(t.shape[0], -1, *t.shape[2:])


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, top, bottom, fill):
        j, n = mesh.model_rank, mesh.n_model
        h = x.shape[1]
        if top > h or bottom > h:
            raise ValueError(f"a halo of {top} + {bottom} rows on a slab of {h}")
        # what the neighbours take: my first `bottom` rows (rank j-1's rows
        # below), my last `top` rows (rank j+1's rows above)
        got = _all_gather(torch.cat([x[:, :bottom], x[:, h - top:]], 1), mesh.model_group, n)
        parts = []
        if j > 0:
            parts.append(got[j - 1][:, bottom:])
        elif fill is not None:
            parts.append(x.new_full((x.shape[0], top, *x.shape[2:]), fill))
        parts.append(x)
        if j < n - 1:
            parts.append(got[j + 1][:, :bottom])
        elif fill is not None:
            parts.append(x.new_full((x.shape[0], bottom, *x.shape[2:]), fill))
        ctx.mesh, ctx.top, ctx.bottom, ctx.h = mesh, top, bottom, h
        ctx.above = top if (j > 0 or fill is not None) else 0
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        mesh, top, bottom, h, above = ctx.mesh, ctx.top, ctx.bottom, ctx.h, ctx.above
        j, n = mesh.model_rank, mesh.n_model
        gx = g[:, above:above + h].clone()
        g_top = g[:, :top] if j > 0 else g.new_zeros((g.shape[0], top, *g.shape[2:]))
        g_bot = (g[:, above + h:] if j < n - 1
                 else g.new_zeros((g.shape[0], bottom, *g.shape[2:])))
        got = _all_gather(torch.cat([g_top, g_bot], 1), mesh.model_group, n)
        if j < n - 1 and top:
            gx[:, h - top:] += got[j + 1][:, :top]
        if j > 0 and bottom:
            gx[:, :bottom] += got[j - 1][:, top:]
        return gx, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, fill=None):
    """A slab with ``top`` rows of the rank above and ``bottom`` of the
    rank below; at the image's top and bottom edge the rows are ``fill``,
    or, with ``fill`` None, left out. Returns (rows, pad_top, pad_bottom),
    the pads 1 where an edge's rows were left out (the conv kernels'
    per-side padding)."""
    mesh = spatial()
    j, n = mesh.model_rank, mesh.n_model
    y = _Halo.apply(x, mesh, top, bottom, fill)
    if fill is not None:
        return y, 0, 0
    return y, int(j == 0), int(j == n - 1)


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.h = mesh, x.shape[1]
        return _gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        j, h = ctx.mesh.model_rank, ctx.h
        return g[:, j * h:(j + 1) * h].contiguous(), None


class _SplitH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        n, j = mesh.n_model, mesh.model_rank
        h = x.shape[1] // n
        ctx.mesh = mesh
        return x[:, j * h:(j + 1) * h].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.mesh), None


def gather_h(x: torch.Tensor) -> torch.Tensor:
    """A slab -> the whole tensor on every rank of the model group (a
    whole tensor as it is)."""
    g = rows(x)
    if g is None:
        return x
    return mark(_GatherH.apply(x, spatial()), None)


def split_h(x: torch.Tensor) -> torch.Tensor:
    """A whole tensor -> this rank's slab (rows must divide)."""
    mesh = spatial()
    g = x.shape[1]
    if g % mesh.n_model:
        raise ValueError(f"{g} rows do not split over {mesh.n_model} model ranks")
    return mark(_SplitH.apply(x, mesh), g)


def whole_rows(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of this rank's rows ``t``, without autograd (the
    targets split like the images)."""
    return _gather_rows(t, spatial())


def canonical(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the rule's layout (`spatial_split` of its global height):
    a slab the rule keeps whole is gathered, a whole tensor it splits is
    split. The identity outside -spatial or on other than NHWC."""
    mesh = spatial()
    if mesh is None or x.dim() != 4:
        return x
    g = rows(x)
    want = spatial_split(global_rows(x), mesh.n_model)
    if g is not None and not want:
        return gather_h(x)
    if g is None and want:
        return split_h(x)
    return x


def aligned(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A coarser scale's tensor ``x`` in the layout of the finer ``like``
    it is upsampled to: a slab under a slab (x split if whole), whole
    under a whole tensor (x gathered if a slab)."""
    if spatial() is None:
        return x
    if rows(like) is None:
        return gather_h(x)
    return x if rows(x) is not None else split_h(x)


def window_rows(k: int, s: int, p: int) -> tuple[int, int]:
    """(rows above, rows below) a slab that a k x k / s window op with
    padding p needs for its output rows (the slab's rows / s): p above,
    k - s - p below."""
    bottom = k - s - p
    if bottom < 0 or p < 0:
        raise ValueError(f"-spatial: no halo plan for a {k}x{k}/{s} window, pad {p}")
    return p, bottom


# ------------------------------------------------------- tensor axis

class _CopyT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh.model_group), None


class _GatherC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.c = mesh, x.shape[-1]
        got = _all_gather(x, mesh.model_group, mesh.n_model)
        return got.movedim(0, -2).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        t, c = ctx.mesh.model_rank, ctx.c
        return g[..., t * c:(t + 1) * c].contiguous(), None


def copy_t(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a channel-sliced layer: the identity; its gradient
    summed over the tensor group (each rank's slice contributes)."""
    return _CopyT.apply(x, mesh)


def gather_c(x: torch.Tensor, mesh) -> torch.Tensor:
    """A channel slice -> the whole channels on every rank of the tensor
    group (the gradient: the rank's slice)."""
    return _GatherC.apply(x, mesh)


def _slice(t: torch.Tensor, mesh) -> torch.Tensor:
    per = t.shape[-1] // mesh.n_model
    return t[..., mesh.model_rank * per:(mesh.model_rank + 1) * per].contiguous()


def whole(t: torch.Tensor, mesh) -> torch.Tensor:
    """A channel slice's whole tensor (no autograd; a collective)."""
    got = _all_gather(t, mesh.model_group, mesh.n_model)
    return got.movedim(0, -2).reshape(*t.shape[:-1], -1)


def sliced(t) -> bool:
    """True for a parameter, buffer or momentum that -tensor sliced."""
    return getattr(t, "mg_sliced", False)


def shard_params_tp(mesh, model: torch.nn.Module, opt_state: Optional[dict] = None):
    """-tensor: keep this rank's trailing-dim slice of every parameter and
    buffer `tp_spec` shards (and of the matching momentum in
    ``opt_state``), in place, each marked ``mg_sliced``; mark each Conv,
    ConvTranspose and Dense whose weight was sliced (``module.tp =
    mesh``). Returns the SGD state with its sliced buffers. A leaf's
    bytes on the rank: 1/N of its whole."""
    from mgtpu_torch.nn import Conv, ConvTranspose, Dense

    if mesh.n_model == 1 or mesh.axis != "tensor":
        return opt_state
    ms = None if opt_state is None else list(opt_state["m"])
    for i, p in enumerate(model.parameters()):
        if tp_spec(p.shape, mesh.n_model):
            p.data = _slice(p.data, mesh)
            p.mg_sliced = True
            if ms is not None:
                ms[i] = _slice(ms[i], mesh)
                ms[i].mg_sliced = True
    for mod in model.modules():
        for name, b in mod._buffers.items():
            if b is not None and b.is_floating_point() and tp_spec(b.shape, mesh.n_model):
                mod._buffers[name] = _slice(b, mesh)
                mod._buffers[name].mg_sliced = True
        if isinstance(mod, (Conv, ConvTranspose, Dense)) and sliced(mod._parameters.get("w")):
            mod.tp = mesh
    return None if ms is None else {"m": ms}


@contextlib.contextmanager
def whole_tensors(mesh, model: torch.nn.Module, opt_state: Optional[dict] = None):
    """-tensor: within it, ``model``'s sliced parameters and buffers hold
    their whole tensors (all-gathered over the tensor group); yields the
    SGD state with its sliced momentum buffers whole (`gather_tree`'s
    already are): what a checkpoint writes, a one-rank run's. A
    collective: every rank enters it at one point."""
    if mesh is None or mesh.n_model == 1 or mesh.axis != "tensor":
        yield opt_state
        return
    params = list(model.parameters())
    saved = [(p, p.data) for p in params if sliced(p)]
    bufs = [(mod, name, b) for mod in model.modules() for name, b in mod._buffers.items()
            if sliced(b)]
    with torch.no_grad():
        ms = None if opt_state is None else [whole(m, mesh) if sliced(m) else m
                                             for m in opt_state["m"]]
        for p, d in saved:
            p.data = whole(d, mesh)
        for mod, name, b in bufs:
            mod._buffers[name] = whole(b, mesh)
    try:
        yield None if ms is None else {"m": ms}
    finally:
        for p, d in saved:
            p.data = d
        for mod, name, b in bufs:
            mod._buffers[name] = b
