"""Weights between the JAX package and the port, without JAX.

``load_jax_tree`` copies the JAX package's parameter and stats trees
(nested dicts keyed '0', '1', ... with numpy or torch leaves: conv
``w`` HWIO and ``b``; BN ``scale``/``bias`` and stats ``mean``/``var``;
empty dicts for folded BNs, identity shortcuts and pools) into a port
module; ``export_jax_tree`` is its inverse. ``load_momentum`` and
``export_momentum`` carry the SGD state: the JAX ``{"m": tree}`` with the
parameter tree's structure, the port's ``{"m": [buffer per parameter]}``
(`mgtpu_torch.train.optim`). ``read_mgtpu_ckpt`` reads an mgtpu-ckpt npz
archive (a JSON ``__struct__`` plus arrays ``a0``, ``a1``, ...) with
numpy alone; leaves come back as torch tensors, bf16 and fp8 ones in
their real dtype.
"""

from __future__ import annotations

import json
import zipfile

import numpy as np
import torch
from torch import nn

from mgtpu_torch.models.common import LogSoftmaxClassifier, MgNet
from mgtpu_torch.nn import BatchNorm, Conv, ConvBN, Dense, Sequential
from mgtpu_torch.ops.mg import MgPool, MgResidual, MgStem7x7

CKPT_FORMAT = "mgtpu-ckpt"
CKPT_VERSION = 1

# checkpoint dtype name -> (numpy dtype to view the stored bits as, real torch dtype)
_VIEW_DTYPES = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def _expect_keys(tree: dict, keys: set, path: str) -> None:
    if set(tree) != keys:
        raise KeyError(f"{path or '<root>'}: tree keys {sorted(tree)} != expected {sorted(keys)}")


@torch.no_grad()
def _copy(dst: torch.Tensor, value, path: str) -> None:
    # np.array copies: a numpy view of a JAX array is read-only
    src = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


def _live(m: nn.Module, path: str = "") -> tuple[dict, dict]:
    """The JAX-structured (params, stats) trees of ``m`` with the port's
    own parameters and buffers as leaves."""
    if isinstance(m, Conv):
        if m.b is None:
            return {"w": m.w}, {}
        return {"w": m.w, "b": m.b}, {}
    if isinstance(m, BatchNorm):
        if m.folded:
            return {}, {}
        return {"scale": m.scale, "bias": m.bias}, {"mean": m.mean, "var": m.var}
    if isinstance(m, ConvBN):
        pb, sb = _live(m.bn, path + ".bn")
        return {"conv": _live(m.conv, path + ".conv")[0], "bn": pb}, {"bn": sb}
    if isinstance(m, Dense):
        return {"w": m.w, "b": m.b}, {}
    if isinstance(m, LogSoftmaxClassifier):
        return _live(m.dense, path)
    if isinstance(m, MgNet):
        return _live(m.seq, path)
    if isinstance(m, (Sequential, MgStem7x7)):
        subs = m.layers if isinstance(m, Sequential) else m.convs
        trees = [_live(sub, f"{path}.{i}") for i, sub in enumerate(subs)]
        return ({str(i): t[0] for i, t in enumerate(trees)},
                {str(i): t[1] for i, t in enumerate(trees)})
    if isinstance(m, MgResidual):
        p, s = {}, {}
        for name, layers in (("s1", m.stage1), ("s2", m.stage2)):
            trees = [_live(layer, f"{path}.{name}.{i}") for i, layer in enumerate(layers)]
            p[name] = {str(i): t[0] for i, t in enumerate(trees)}
            s[name] = {str(i): t[1] for i, t in enumerate(trees)}
        p["sc"], s["sc"] = {}, {}
        for i in range(len(m.in_widths)):
            k = str(i)
            sc = _live(m.shortcuts[k], f"{path}.sc.{k}") if k in m.shortcuts else ({}, {})
            p["sc"][k], s["sc"][k] = sc
        return p, s
    if isinstance(m, MgPool):
        return {}, {}
    raise TypeError(f"{path}: no JAX-tree mapping for {type(m).__name__}")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _zip(live, tree, fn, path: str = "") -> None:
    """fn(live leaf, tree leaf, path) over two trees of one structure."""
    if isinstance(live, dict):
        if not isinstance(tree, dict):
            raise KeyError(f"{path or '<root>'}: expected a dict, got {type(tree).__name__}")
        _expect_keys(tree, set(live), path)
        for k, v in live.items():
            _zip(v, tree[k], fn, f"{path}.{k}")
    elif isinstance(tree, dict):  # e.g. an int8 conv's {"w8", "scale", ...}
        raise NotImplementedError(f"{path}: the tree holds {sorted(tree)}, the port one "
                                  f"array (int8-quantized convs are not ported)")
    else:
        fn(live, tree, path)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def export_jax_tree(model: nn.Module) -> tuple[dict, dict]:
    """The inverse of ``load_jax_tree``: ``model``'s (params, stats) as
    numpy trees in the JAX package's structure."""
    p, s = _live(model)
    return _map(p, _numpy), _map(s, _numpy)


def export_momentum(model: nn.Module, opt_state: dict) -> dict:
    """The port's SGD state for ``model.parameters()`` as the JAX
    package's ``{"m": tree}``, numpy leaves."""
    m = {id(p): buf for p, buf in zip(model.parameters(), opt_state["m"], strict=True)}
    return {"m": _map(_live(model)[0], lambda p: _numpy(m[id(p)]))}


def load_momentum(model: nn.Module, opt_tree: dict) -> dict:
    """The JAX package's ``{"m": tree}`` as the port's SGD state for
    ``model.parameters()``, each buffer like its parameter. Raises on
    any key, shape or structure mismatch."""
    m = {}

    def take(p, value, path):
        buf = torch.zeros_like(p)
        _copy(buf, value, path)
        m[id(p)] = buf

    _zip(_live(model)[0], opt_tree["m"], take, "m")
    return {"m": [m[id(p)] for p in model.parameters()]}


def load_jax_tree(model: nn.Module, params: dict, stats: dict) -> nn.Module:
    """Copy a JAX (params, stats) tree into ``model`` in place (values
    are cast to each parameter's dtype and device); returns ``model``.
    A BN whose tree is an empty dict (folded in the JAX package) is
    folded in the port too. Raises on any key, shape or structure
    mismatch."""
    bns = {id(m.scale): m for m in model.modules()
           if isinstance(m, BatchNorm) and not m.folded}

    def fold_marked(live, tree):
        if tree == {} and "scale" in live:
            bns[id(live["scale"])].drop_folded()
        elif isinstance(tree, dict):
            for k in live.keys() & tree.keys():
                if isinstance(live[k], dict):
                    fold_marked(live[k], tree[k])

    fold_marked(_live(model)[0], params)
    p, s = _live(model)
    _zip(p, params, _copy)
    _zip(s, stats, _copy)
    return model


def _decode(node, arrays):
    if node is None:
        return None
    t = node["t"]
    if t == "d":
        return {k: _decode(v, arrays) for k, v in node["k"].items()}
    if t == "l":
        return [_decode(v, arrays) for v in node["c"]]
    if t == "u":
        return tuple(_decode(v, arrays) for v in node["c"])
    a = arrays[node["i"]]
    if "dtype" in node:
        np_view, torch_dtype = _VIEW_DTYPES[node["dtype"]]
        return torch.from_numpy(a.view(np_view)).view(torch_dtype)
    return torch.from_numpy(a)


def read_mgtpu_ckpt(path: str) -> dict:
    """Read an mgtpu-ckpt archive (never unpickles). Returns a dict with
    ``params``, ``stats``, ``opt_state``, ``epoch`` and ``meta``."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not an mgtpu-ckpt npz archive")
    with np.load(path, allow_pickle=False) as z:
        struct = json.loads(str(z["__struct__"]))
        if struct.get("format") != CKPT_FORMAT:
            raise ValueError(f"{path}: unknown checkpoint format {struct.get('format')!r}")
        if struct["version"] > CKPT_VERSION:
            raise ValueError(f"{path}: checkpoint version {struct['version']} is newer "
                             f"than this reader ({CKPT_VERSION})")
        n = sum(1 for k in z.files if k != "__struct__")
        arrays = [z[f"a{i}"] for i in range(n)]
    return {
        "params": _decode(struct["params"], arrays),
        "stats": _decode(struct["stats"], arrays),
        "opt_state": _decode(struct["opt_state"], arrays),
        "epoch": struct["epoch"],
        "meta": struct["meta"],
    }
