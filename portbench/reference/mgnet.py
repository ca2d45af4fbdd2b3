"""Plain PyTorch multigrid nets: R-MG-18/34 (`ilsvrc/rnmg`) and P-NMG for
cluttered MNIST (`mnist-cluttered/pnmg.mnist`), written from the paper's
layer equations (Ke, Maire, Yu, CVPR 2017) and the published recipes,
with no kernel, no fused exchange and nothing of the program under test.

A net is a list of layer dicts (`rnmg`, `pnmg_mnist`). Its weights are
two trees in the published mgtpu-ckpt structure (`shape_tree`, `init_trees`): nested
dicts keyed '0', '1', ... as the checkpoints of both packages hold them,
conv kernels HWIO and BatchNorm's scale, bias, mean and var. `forward`
runs a batch of NHWC images through them in f32 (NCHW inside):

- ``mode="eval"``: each BatchNorm folded into its conv
  (``w * a``, ``bias + (b - mean) * a`` with ``a = scale / sqrt(var + eps)``);
- ``mode="train"``: batch moments, the running stats updated in place
  (momentum 0.1, unbiased variance), differentiable;
- ``mode="calib_bn"``: eval, with each BatchNorm's running stats first
  set to the moments of its input (a randomly drawn net given the scale
  of a trained one).

Every exchange conv is one conv over the materialized concat
{maxpool2_ceil(finer), self, nearest_up2(coarser)}. A `Quant` replaces
each conv's operands by their quantized values (per-part activation
scales, per-output-channel weight scales), which is what an int8 or
fp8 conv computes before its output is rescaled.

A net that `NETS` does not hold comes from its configuration's reference
module (``"reference": "<module>"``: `reference/<module>.py`, loaded by
the harness): the module's ``NETS`` ({net: builder}) and ``KINDS``
({layer type: `Kind`}), added by `register`. The built-in nets and layer
types are matched first, and a module may not name one. A kind's tree
builds on `_convbn_tree` and `_indexed`, its forward on `_convbn`,
`_exchange`, `_maxpool2_ceil` and `_up2`, so `conv_shapes`,
`macs_per_image`, a `Quant` and BatchNorm calibration see its convs.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

RMG_STEM = [64, 32, 16]
RMG_CFG = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3]}
RMG_BLOCKS = [([64, 32, 16], False), ([128, 64, 32], True), ([256, 128], True), ([512], False)]


def after_exchange(widths):
    n = len(widths)
    return [widths[i] + (widths[i - 1] if i else 0) + (widths[i + 1] if i + 1 < n else 0)
            for i in range(n)]


def rnmg(depth=34, classes=1000):
    """R-MG-``depth``: 7x7/2 stems {64, 32, 16}, residual multigrid
    blocks with plain or concat pools between them (shortcuts zero-pad
    when widening), average pool, dense, log-softmax."""
    layers = [{"type": "stem7", "widths": list(RMG_STEM), "c_in": 3}]
    widths = list(RMG_STEM)
    for bi, (ws, concat) in enumerate(RMG_BLOCKS):
        for _ in range(RMG_CFG[depth][bi]):
            layers.append({"type": "res", "in": widths, "out": list(ws), "eps": 1e-5})
            widths = list(ws)
        if bi < len(RMG_BLOCKS) - 1:
            layers.append({"type": "pool", "mode": "concat" if concat else "plain"})
            widths = widths[:-2] + [widths[-2] + widths[-1]] if concat else widths
    layers.append({"type": "classifier", "c_in": widths[0], "classes": classes, "pool": 7})
    return layers


def pnmg_mnist(n_layer=1, n_class=1):
    """P-NMG for cluttered MNIST: the pyramid prefix on grids {64, 32, 16, 8}
    at 64 px, then mg-conv blocks narrowing to 3, 2 and 1 grids, the last
    conv without ReLU, sigmoid of the finest grid."""
    grids = [64, 32, 16, 8]
    eps = 1e-3
    layers = [{"type": "input3", "widths": list(grids), "c_in": 1, "eps": eps}]
    n = len(grids)
    for n_grid in range(1, n + 1):
        for _ in range(n_layer):
            if n_grid == 1:
                layers.append({"type": "coarsest", "width": grids[-1], "n": n, "eps": eps})
            else:
                tail = grids[n - n_grid:]
                layers.append({"type": "tail", "n_pass": n - n_grid,
                               "op": {"type": "mgconv", "in": tail, "out": tail, "relu": True,
                                      "eps": eps}})
    plan = [(grids, False), (grids, False), (grids, False), ([64, 32, 16], True), ([64, 32], True),
            ([n_class], True)]
    widths = list(grids)
    for bi, (ws, drop) in enumerate(plan):
        for li in range(n_layer):
            if li == 0 and drop:
                layers.append({"type": "drop"})
                widths = widths[:-1]
            last = bi == len(plan) - 1 and li == n_layer - 1
            layers.append({"type": "mgconv", "in": widths, "out": list(ws), "relu": not last,
                           "eps": eps})
            widths = list(ws)
    layers.append({"type": "sigmoid", "scale": 0})
    return layers


NETS = {"ilsvrc/rnmg": lambda c: rnmg(c["depth"], c["classes"]),
        "mnist-cluttered/pnmg.mnist": lambda c: pnmg_mnist(c["nLayer"], c["classes"])}


# the layer types of the chain in `_layer_tree` and `_layer`
BUILT_IN_KINDS = ("stem7", "input3", "res", "mgconv", "coarsest", "tail", "classifier", "pool",
                  "drop", "sigmoid")


class Kind(NamedTuple):
    """A layer type that a reference module adds. ``tree(layer)``: its
    (params, stats) trees of (kind, shape) leaves, in the checkpoint's
    structure; ``forward(ctx, layer, p, s, pyr)``: its output;
    ``macs(layer)``: one image's multiply-adds outside its convs (a dense
    product), for `macs_per_image`."""

    tree: Callable
    forward: Callable
    macs: Callable = lambda layer: 0


ADDED_NETS = {}  # net -> builder, from the reference modules loaded
KINDS = {}  # layer type -> Kind, from the reference modules loaded


def register(nets: dict, kinds: dict) -> None:
    """Add a reference module's ``NETS`` and ``KINDS``; a name that is built
    in raises. Loading a module again registers its names again."""
    taken = sorted(set(nets) & set(NETS)) + sorted(set(kinds) & set(BUILT_IN_KINDS))
    if taken:
        raise ValueError(f"built in, not to be registered again: {taken}")
    ADDED_NETS.update(nets)
    KINDS.update(kinds)


def build(config: dict):
    net = config["net"]
    if net in NETS:
        return NETS[net](config)
    if net in ADDED_NETS:
        return ADDED_NETS[net](config)
    raise ValueError(f"configuration {config.get('name', '')!r}: net {net!r} is not built in, "
                     f"and no reference module registered it (its \"reference\": "
                     f"{config.get('reference')!r})")


def _kind(t):
    if t not in KINDS:
        raise ValueError(f"unknown layer {t!r}")
    return KINDS[t]


# --- parameter trees ---------------------------------------------------------

def _convbn_tree(ci, co, k):
    return ({"conv": {"w": ("conv", (k, k, ci, co)), "b": ("bias", (co,))},
             "bn": {"scale": ("scale", (co,)), "bias": ("shift", (co,))}},
            {"bn": {"mean": ("mean", (co,)), "var": ("var", (co,))}})


def _indexed(items):
    return ({str(i): p for i, (p, _) in enumerate(items)},
            {str(i): s for i, (_, s) in enumerate(items)})


def _layer_tree(layer):
    t = layer["type"]
    if t == "stem7":
        return _indexed([_convbn_tree(layer["c_in"], w, 7) for w in layer["widths"]])
    if t == "input3":
        return _indexed([_convbn_tree(layer["c_in"], w, 3) for w in layer["widths"]])
    if t == "res":
        m1, m2 = after_exchange(layer["in"]), after_exchange(layer["out"])
        s1 = _indexed([_convbn_tree(m1[i], w, 3) for i, w in enumerate(layer["out"])])
        s2 = _indexed([_convbn_tree(m2[i], w, 3) for i, w in enumerate(layer["out"])])
        sc = {str(i): {} for i in range(len(layer["in"]))}
        for i, (a, b) in enumerate(zip(layer["in"], layer["out"])):
            if a > b:  # a narrowing shortcut takes a 1x1 ConvBN
                sc[str(i)] = _convbn_tree(a, b, 1)
        return ({"s1": s1[0], "s2": s2[0], "sc": {k: v[0] if v else {} for k, v in sc.items()}},
                {"s1": s1[1], "s2": s2[1], "sc": {k: v[1] if v else {} for k, v in sc.items()}})
    if t == "mgconv":
        m = after_exchange(layer["in"])
        return _indexed([_convbn_tree(m[i], w, 3) for i, w in enumerate(layer["out"])])
    if t == "coarsest":
        p, s = _convbn_tree(layer["width"], layer["width"], 3)
        n = layer["n"]
        return ({**{str(i): {} for i in range(n - 1)}, str(n - 1): p},
                {**{str(i): {} for i in range(n - 1)}, str(n - 1): s})
    if t == "tail":
        return _layer_tree(layer["op"])
    if t == "classifier":
        return {"w": ("dense", (layer["c_in"], layer["classes"])),
                "b": ("bias", (layer["classes"],))}, {}
    if t in ("pool", "drop", "sigmoid"):
        return {}, {}
    return _kind(t).tree(layer)


def shape_tree(net):
    """(params, stats) trees whose leaves are (kind, shape)."""
    return _indexed([_layer_tree(layer) for layer in net])


def leaves(tree, path=""):
    """[(path, leaf)] in a fixed order."""
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += leaves(tree[k], f"{path}.{k}" if path else k)
        return out
    return [(path, tree)]


def map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def get(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def param_count(net) -> int:
    return sum(math.prod(shape) for _, (_, shape) in leaves(shape_tree(net)[0]))


@torch.no_grad()
def init_trees(net, generator: torch.Generator, device):
    """Weights drawn from ``generator`` on ``device`` in one call per
    distribution: conv kernels N(0, 2 / (k k c_out)) (MSR), dense U(+-1 /
    sqrt(c_in)), conv biases N(0, 0.05^2), BatchNorm scale U[0.5, 1.5)
    and shift N(0, 0.2^2) as `calibrate_bn` expects them; mean 0, var 1
    until `calibrate_bn` sets them."""
    shapes = shape_tree(net)
    out = []
    for tree in shapes:
        items = leaves(tree)
        by_kind = {}
        for path, (kind, shape) in items:
            by_kind.setdefault(kind, []).append((path, shape))
        values = {}
        for kind, group in by_kind.items():
            n = sum(math.prod(s) for _, s in group)
            if kind in ("conv", "bias", "shift"):
                flat = torch.randn(n, generator=generator, device=device)
            elif kind in ("dense", "scale"):
                flat = torch.rand(n, generator=generator, device=device)
            else:
                flat = torch.zeros(n, device=device) + (kind == "var")
            ofs = 0
            for path, shape in group:
                v = flat[ofs:ofs + math.prod(shape)].view(shape)
                ofs += v.numel()
                if kind == "conv":
                    v.mul_(math.sqrt(2.0 / (shape[0] * shape[1] * shape[3])))
                elif kind == "bias":
                    v.mul_(0.05)
                elif kind == "shift":
                    v.mul_(0.2)
                elif kind == "dense":
                    v.mul_(2).sub_(1).mul_(1.0 / math.sqrt(shape[0]))
                elif kind == "scale":
                    v.add_(0.5)
                values[path] = v
        out.append(_rebuild(tree, values))
    return tuple(out)


def _rebuild(tree, values, path=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{path}.{k}" if path else k) for k, v in tree.items()}
    return values[path]


# --- quantized operands ------------------------------------------------------

class _Straight(torch.autograd.Function):
    """q(x) forward; backward the straight-through gradient, itself
    quantized by ``gfn`` where it is given."""

    @staticmethod
    def forward(ctx, x, fn, gfn=None):
        ctx.gfn = gfn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.gfn is None else ctx.gfn(g)), None, None


def _int(levels):
    def act(x, s):
        return torch.clamp(torch.round(x / s), -levels, levels) * s

    return act


def _fp8(x, s):
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _fp8_grad(g):
    """A gradient in e5m2, scaled to its largest value (57,344)."""
    s = torch.clamp_min(g.abs().amax() / 57344.0, 1e-30)
    return (g / s).to(torch.float8_e5m2).float() * s


class Quant:
    """The operands of every conv as a quantized conv takes them. ``kind``:
    "int8" / "int4" (symmetric, 127 / 7 levels, round half to even),
    "fp8" (e4m3, scaled to 448; in training the gradient reaching each
    conv input in e5m2, as fp8 training runs its backward), "bf16" (in
    training its gradient in bf16 too).
    Activations: one scale per conv input part (the whole tensor, the
    batch included), static once `calibrate` froze them; weights: one
    scale per output channel."""

    LEVELS = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}

    def __init__(self, kind):
        self.kind = kind
        self.static = None  # {(conv index, part): scale}
        self.record = None  # during a calibration pass: {(conv index, part): absmax}

    def _apply(self, x, s):
        if self.kind == "fp8":
            return _fp8(x, s)
        return _int(self.LEVELS[self.kind])(x, s)

    def act(self, x, key):
        if self.kind == "bf16":
            return _Straight.apply(x, _bf16, _bf16)
        top = self.LEVELS[self.kind]
        if self.record is not None:
            m = float(x.detach().abs().amax())
            self.record[key] = max(self.record.get(key, 0.0), m)
        if self.static is not None and self.record is None:
            s = self.static[key]
        else:
            s = torch.clamp_min(x.detach().abs().amax() / top, 1e-12)
        return _Straight.apply(x, lambda t: self._apply(t, s),
                               _fp8_grad if self.kind == "fp8" else None)

    def weight(self, w):
        """w: OIHW."""
        if self.kind == "bf16":
            return _Straight.apply(w, _bf16)
        top = self.LEVELS[self.kind]
        s = torch.clamp_min(w.detach().abs().amax(dim=(1, 2, 3), keepdim=True) / top, 1e-12)
        return _Straight.apply(w, lambda t: self._apply(t, s))


# --- forward -----------------------------------------------------------------

class Ctx:
    def __init__(self, mode, quant=None, trace=None):
        self.mode, self.quant, self.trace = mode, quant, trace
        self.n_conv = 0


def _maxpool2_ceil(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up2(x, oh, ow):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)[:, :, :oh, :ow]


def _exchange(pyr, i):
    """[(kind, tensor)] of scale i: {maxpool2_ceil(finer), self, up(coarser)}."""
    oh, ow = pyr[i].shape[2:]
    parts = []
    if i > 0:
        parts.append(("down", _maxpool2_ceil(pyr[i - 1])))
    parts.append(("same", pyr[i]))
    if i + 1 < len(pyr):
        parts.append(("up", _up2(pyr[i + 1], oh, ow), pyr[i + 1]))
    return parts


def _convbn(ctx, p, s, parts, k, stride=1, pad=None, relu=True, eps=1e-5, stage2=False):
    """One ConvBN of the channel concat of ``parts`` [(kind, x[, coarse x])]."""
    pad = (k // 2) if pad is None else pad
    idx = ctx.n_conv
    ctx.n_conv += 1
    w = p["conv"]["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    b = p["conv"]["b"]
    bn, st = p["bn"], s["bn"]
    if ctx.trace is not None:
        ctx.trace.append({"k": k, "stride": stride, "pad": pad, "co": w.shape[0],
                          "parts": [(pt[0], pt[1].shape[1], *pt[1].shape[2:]) for pt in parts],
                          "stage2": stage2})
    if ctx.mode == "eval":  # the BatchNorm folded into the conv
        a = bn["scale"] * torch.rsqrt(st["var"] + eps)
        w = w * a[:, None, None, None]
        b = bn["bias"] + (b - st["mean"]) * a
    xs = [pt[1] for pt in parts]
    if ctx.quant is not None:
        xs = [ctx.quant.act(x, (idx, j)) for j, x in enumerate(xs)]
        w = ctx.quant.weight(w)
    x = xs[0] if len(xs) == 1 else torch.cat(xs, 1)
    y = F.conv2d(x, w, b, stride=stride, padding=pad)
    if ctx.mode == "train":
        y = F.batch_norm(y, st["mean"], st["var"], bn["scale"], bn["bias"], training=True,
                         momentum=0.1, eps=eps)
    elif ctx.mode == "calib_bn":
        st["mean"].copy_(y.mean(dim=(0, 2, 3)))
        st["var"].copy_(y.var(dim=(0, 2, 3), unbiased=False))
        y = F.batch_norm(y, st["mean"], st["var"], bn["scale"], bn["bias"], training=False,
                         eps=eps)
    return torch.relu(y) if relu else y


def _pyramid(x, n):
    xs = [x]
    for _ in range(n - 1):
        xs.append(F.avg_pool2d(xs[-1], 2))
    return xs


def _layer(ctx, layer, p, s, pyr):
    t = layer["type"]
    if t == "stem7":
        xs = _pyramid(pyr, len(layer["widths"]))
        return [F.max_pool2d(_convbn(ctx, p[str(i)], s[str(i)], [("same", x)], 7, 2, 3), 3, 2, 1)
                for i, x in enumerate(xs)]
    if t == "input3":
        xs = _pyramid(pyr, len(layer["widths"]))
        return [_convbn(ctx, p[str(i)], s[str(i)], [("same", x)], 3, eps=layer["eps"])
                for i, x in enumerate(xs)]
    if t == "res":
        def stage(key, pyr, relu, stage2):
            return [_convbn(ctx, p[key][str(i)], s[key][str(i)], _exchange(pyr, i), 3,
                            relu=relu, eps=layer["eps"], stage2=stage2)
                    for i in range(len(pyr))]

        h = stage("s2", stage("s1", pyr, True, False), False, True)
        out = []
        for i, (x, y) in enumerate(zip(pyr, h)):
            cin, cout = layer["in"][i], layer["out"][i]
            if p["sc"][str(i)]:
                short = _convbn(ctx, p["sc"][str(i)], s["sc"][str(i)], [("same", x)], 1,
                                relu=False, eps=layer["eps"])
            elif cin == cout:
                short = x
            else:  # widening: zero channels appended
                short = F.pad(x, (0, 0, 0, 0, 0, cout - cin))
            out.append(torch.relu(y + short))
        return out
    if t == "pool":
        if layer["mode"] == "plain":
            return [_maxpool2_ceil(x) for x in pyr]
        out = [_maxpool2_ceil(x) for x in pyr[:-1]]
        out[-1] = torch.cat([out[-1], pyr[-1]], 1)
        return out
    if t == "mgconv":
        return [_convbn(ctx, p[str(i)], s[str(i)], _exchange(pyr, i), 3, relu=layer["relu"],
                        eps=layer["eps"]) for i in range(len(pyr))]
    if t == "coarsest":
        last = str(layer["n"] - 1)
        return list(pyr[:-1]) + [_convbn(ctx, p[last], s[last], [("same", pyr[-1])], 3,
                                         eps=layer["eps"])]
    if t == "tail":
        n = layer["n_pass"]
        return list(pyr[:n]) + _layer(ctx, layer["op"], p, s, pyr[n:])
    if t == "drop":
        return list(pyr[:-1])
    if t == "classifier":
        x = pyr[0]
        if layer["pool"]:
            x = F.avg_pool2d(x, layer["pool"], 1)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        return torch.log_softmax(x @ p["w"] + p["b"], dim=-1)
    if t == "sigmoid":
        return torch.sigmoid(pyr[layer["scale"]]).permute(0, 2, 3, 1)
    return _kind(t).forward(ctx, layer, p, s, pyr)


def forward(net, params, stats, images, mode="eval", quant=None, trace=None):
    """images (B, H, W, C) NHWC f32 -> log-probs (B, classes) or NHWC
    probabilities. ``trace``: a list that receives each conv's shapes."""
    ctx = Ctx(mode, quant, trace)
    x = images.permute(0, 3, 1, 2).contiguous()
    for i, layer in enumerate(net):
        x = _layer(ctx, layer, params[str(i)], stats[str(i)], x)
    return x


@torch.no_grad()
def calibrate_bn(net, params, stats, images):
    """Each BatchNorm's running mean and (biased) variance set, layer by
    layer in one eval forward, to the moments of its input over
    ``images``: a drawn net with the activations of a trained one."""
    forward(net, params, stats, images, mode="calib_bn")


@torch.no_grad()
def calibrate_quant(net, params, stats, batches, quant: Quant):
    """Static activation scales: each conv part's largest absmax over
    ``batches`` (dynamic-scale forwards), over the quantizer's levels."""
    quant.static, quant.record = None, {}
    for x in batches:
        forward(net, params, stats, x, "eval", quant)
    top = Quant.LEVELS[quant.kind]
    quant.static = {k: max(v / top, 1e-12) for k, v in quant.record.items()}
    quant.record = None
    return quant


def conv_shapes(net, image_shape, mode="eval"):
    """Each conv of one image's forward: {k, stride, pad, co, parts [(kind,
    ci, h, w)] (a part's h, w at its own resolution: an "up" part's at
    the fine one), stage2}, from a forward on the meta device."""
    trace = []
    params, stats = (map_tree(t, lambda leaf: torch.zeros(leaf[1], device="meta"))
                     for t in shape_tree(net))
    h, w, c = image_shape
    with torch.no_grad():
        forward(net, params, stats, torch.zeros((1, h, w, c), device="meta"), mode, trace=trace)
    return trace


def macs_per_image(net, image_shape) -> int:
    """Multiply-adds of one image in the reference formulation: every conv
    as one dense conv over its materialized input (k k taps of all its
    input channels at every output pixel), the dense layer as its
    product, and what an added kind's ``macs`` counts."""
    total = 0
    for cv in conv_shapes(net, image_shape):
        kind, ci, h, w = cv["parts"][0]
        oh = (h + 2 * cv["pad"] - cv["k"]) // cv["stride"] + 1
        ow = (w + 2 * cv["pad"] - cv["k"]) // cv["stride"] + 1
        total += oh * ow * cv["co"] * cv["k"] ** 2 * sum(pt[1] for pt in cv["parts"])
    for layer in net:
        if layer["type"] == "classifier":
            total += layer["c_in"] * layer["classes"]
        elif layer["type"] in KINDS:
            total += KINDS[layer["type"]].macs(layer)
    return total
