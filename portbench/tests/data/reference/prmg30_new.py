"""PR-MG-30 (`ilsvrc/prnmgseg`, depth 30, ``-shortcutType A``) for the reference:
a net that `reference/mgnet.py` lacks, added by a module of its own, as
the files-only test adds it. Written from the paper's layer equations
(Ke, Maire, Yu, CVPR 2017) and `scripts/ilsvrc/prnmgseg.sh`:

- 7x7/2 stems {64, 32, 16, 8} at (56, 28, 14, 7), kept through every
  layer with no pooling between blocks;
- the pyramid prefix: a single-grid residual block on the coarsest grid
  alone (`resblock`), then residual multigrid layers (`res`) on growing
  tails of the grids, each setting the tail's widths to its leading one;
- residual multigrid blocks {64, 64, 64, 128}, {64, 64, 128, 256},
  {64, 128, 256, 512}; type A shortcuts (zero-padded when widening, a
  1x1 ConvBN when narrowing);
- the classifier on the coarsest grid (`classifier_at`, scale -1):
  average pool 7, dense, log-softmax.

Two layers a block, the prefix's stages included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import mgnet

STEM = [64, 32, 16, 8]
PER_BLOCK = 2
BLOCKS = [[64, 64, 64, 128], [64, 64, 128, 256], [64, 128, 256, 512]]


def prnmgseg(depth=30, classes=1000, shortcut="A"):
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
