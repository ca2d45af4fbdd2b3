"""PR-MG-30 (`ilsvrc/prnmgseg`, depth 30, ``-shortcutType A``) in plain
torch: the net and the two layer kinds `reference/mgnet.py` lacks,
registered by the configuration that names this module (`prmg30`).
Written from the paper's layer equations (Ke, Maire, Yu, Multigrid
Neural Architectures, CVPR 2017) and `scripts/ilsvrc/prnmgseg.sh`
(``-depth 30 -shortcutType A``), with no kernel and nothing of the
program under test. In f32, NCHW, a pyramid ``x[0..3]`` finest first:

- stems (`mgnet`'s ``stem7``): ``x[i] = maxpool3/2(relu(BN(conv7x7/2(
  avgpool2^i(image)))))`` with widths {64, 32, 16, 8}, at 56, 28, 14 and 7
  px; no layer pools the grids after that;
- the pyramid prefix, two layers a stage: on the coarsest grid alone
  (`resblock` below), then residual multigrid layers (`mgnet`'s ``res``)
  on the tails of the 2, 3 and 4 coarsest grids, each setting the
  tail's widths to its leading one ({.., 16, 16}, {.., 32, 32, 32},
  {64, 64, 64, 64});
- residual multigrid blocks {64, 64, 64, 128}, {64, 64, 128, 256},
  {64, 128, 256, 512}, two layers each. A layer is
  ``y[i] = relu(BN(conv3x3(E(h)[i])) + short(x[i]))`` with
  ``h[i] = relu(BN(conv3x3(E(x)[i])))``, where the exchange ``E(x)[i]``
  is the channel concat {maxpool2_ceil(x[i-1]), x[i], nearest_up2(x[i+1])}
  of the grids that exist; type A's ``short`` is the identity, with zero
  channels appended when widening (a 1x1 ConvBN when narrowing, which
  no layer of this net does);
- `resblock`: ``relu(BN(conv3x3(relu(BN(conv3x3(x))))) + short(x))`` on
  one grid, the others passed through;
- `classifier_at` on the coarsest grid (scale -1): average pool 7,
  dense 512 -> 1,000 (NHWC flatten order), log-softmax.

Departures: none from the paper. The Lua recipe's model file cannot
load as committed (a trailing comma in ``prnmgseg.lua``); this follows
its evident intent, as the port and the JAX package do, passing
``-shortcutType`` through to every shortcut.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import mgnet

STEM = [64, 32, 16, 8]
PER_BLOCK = 2
BLOCKS = [[64, 64, 64, 128], [64, 64, 128, 256], [64, 128, 256, 512]]


def prnmgseg(depth=30, classes=1000, shortcut="A"):
    """PR-MG-``depth``'s layer list; depth 30 with type A shortcuts only."""
    if (depth, shortcut) != (30, "A"):  # `res` takes type A's shortcuts
        raise ValueError(f"ilsvrc/prnmgseg: depth {depth} shortcut type {shortcut!r}, not 30 A")
    n = len(STEM)
    layers = [{"type": "stem7", "widths": list(STEM), "c_in": 3}]
    widths = list(STEM)
    for n_grid in range(1, n + 1):
        for _ in range(PER_BLOCK):
            if n_grid == 1:
                layers.append({"type": "resblock", "n": n, "scale": n - 1, "in": widths[-1],
                               "out": widths[-1], "eps": 1e-5})
            else:
                tail = [widths[n - n_grid]] * n_grid
                layers.append({"type": "tail", "n_pass": n - n_grid,
                               "op": {"type": "res", "in": widths[n - n_grid:], "out": tail,
                                      "eps": 1e-5}})
                widths = widths[:n - n_grid] + tail
    for ws in BLOCKS:
        for _ in range(PER_BLOCK):
            layers.append({"type": "res", "in": widths, "out": list(ws), "eps": 1e-5})
            widths = list(ws)
    layers.append({"type": "classifier_at", "scale": -1, "c_in": widths[-1], "classes": classes,
                   "pool": 7})
    return layers


# --- resblock: ConvBN-ReLU, ConvBN, plus the shortcut, then ReLU, on one
# grid of ``n``; the other grids pass through -----------------------------

def _resblock_tree(layer):
    ci, co = layer["in"], layer["out"]
    convs = {"c1": mgnet._convbn_tree(ci, co, 3), "c2": mgnet._convbn_tree(co, co, 3)}
    if ci > co:  # a narrowing shortcut takes a 1x1 ConvBN
        convs["sc"] = mgnet._convbn_tree(ci, co, 1)
    at = layer["scale"] % layer["n"]
    return tuple({str(i): {k: v[j] for k, v in convs.items()} if i == at else {}
                  for i in range(layer["n"])} for j in (0, 1))


def _resblock(ctx, layer, p, s, pyr):
    at = layer["scale"] % len(pyr)
    p, s, x, eps = p[str(at)], s[str(at)], pyr[at], layer["eps"]
    h = mgnet._convbn(ctx, p["c1"], s["c1"], [("same", x)], 3, eps=eps)
    h = mgnet._convbn(ctx, p["c2"], s["c2"], [("same", h)], 3, relu=False, eps=eps)
    if "sc" in p:
        short = mgnet._convbn(ctx, p["sc"], s["sc"], [("same", x)], 1, relu=False, eps=eps)
    else:  # the identity, zero channels appended when widening
        short = F.pad(x, (0, 0, 0, 0, 0, layer["out"] - layer["in"]))
    out = list(pyr)
    out[at] = torch.relu(h + short)
    return out


# --- classifier_at: the built-in classifier on grid ``scale`` -------------

def _classifier(layer):
    return {**layer, "type": "classifier"}


def _classifier_at(ctx, layer, p, s, pyr):
    return mgnet._layer(ctx, _classifier(layer), p, s, [pyr[layer["scale"]]])


NETS = {"ilsvrc/prnmgseg": lambda c: prnmgseg(c["depth"], c["classes"], c["shortcutType"])}
KINDS = {
    "resblock": mgnet.Kind(_resblock_tree, _resblock),
    "classifier_at": mgnet.Kind(lambda layer: mgnet._layer_tree(_classifier(layer)),
                                _classifier_at, lambda layer: layer["c_in"] * layer["classes"]),
}
