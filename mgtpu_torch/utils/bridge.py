"""Weights from the JAX package into the port, without JAX.

``load_jax_tree`` copies the JAX package's parameter and stats trees
(nested dicts keyed '0', '1', ... with numpy or torch leaves: conv
``w`` HWIO and ``b``; BN ``scale``/``bias`` and stats ``mean``/``var``;
empty dicts for folded BNs, identity shortcuts and pools) into a port
module. ``read_mgtpu_ckpt`` reads an mgtpu-ckpt npz archive (a JSON
``__struct__`` plus arrays ``a0``, ``a1``, ...) with numpy alone; leaves
come back as torch tensors, bf16 and fp8 ones in their real dtype.
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


def _load(m: nn.Module, p: dict, s: dict, path: str) -> None:
    if isinstance(m, Conv):
        if isinstance(p.get("w"), dict):
            raise NotImplementedError(f"{path}: int8-quantized convs are not ported")
        _expect_keys(p, {"w", "b"}, path)
        _copy(m.w, p["w"], path + ".w")
        _copy(m.b, p["b"], path + ".b")
    elif isinstance(m, BatchNorm):
        if not p and not s:  # folded in the JAX tree
            m.drop_folded()
            return
        if m.folded:
            raise ValueError(f"{path}: the port's BN is folded, the tree's is not")
        _expect_keys(p, {"scale", "bias"}, path)
        _expect_keys(s, {"mean", "var"}, path + " (stats)")
        for name, v in (("scale", p["scale"]), ("bias", p["bias"]),
                        ("mean", s["mean"]), ("var", s["var"])):
            _copy(getattr(m, name), v, f"{path}.{name}")
    elif isinstance(m, ConvBN):
        _expect_keys(p, {"conv", "bn"}, path)
        _load(m.conv, p["conv"], {}, path + ".conv")
        _load(m.bn, p["bn"], s["bn"], path + ".bn")
    elif isinstance(m, Dense):
        _expect_keys(p, {"w", "b"}, path)
        _copy(m.w, p["w"], path + ".w")
        _copy(m.b, p["b"], path + ".b")
    elif isinstance(m, LogSoftmaxClassifier):  # its tree is its Dense's
        _load(m.dense, p, s, path)
    elif isinstance(m, MgNet):
        _load(m.seq, p, s, path)
    elif isinstance(m, (Sequential, MgStem7x7)):
        subs = m.layers if isinstance(m, Sequential) else m.convs
        _expect_keys(p, {str(i) for i in range(len(subs))}, path)
        for i, sub in enumerate(subs):
            _load(sub, p[str(i)], s[str(i)], f"{path}.{i}")
    elif isinstance(m, MgResidual):
        _expect_keys(p, {"s1", "s2", "sc"}, path)
        for name, layers in (("s1", m.stage1), ("s2", m.stage2)):
            _expect_keys(p[name], {str(i) for i in range(len(layers))}, f"{path}.{name}")
            for i, layer in enumerate(layers):
                _load(layer, p[name][str(i)], s[name][str(i)], f"{path}.{name}.{i}")
        for i in range(len(m.in_widths)):
            k = str(i)
            if k in m.shortcuts:
                _load(m.shortcuts[k], p["sc"][k], s["sc"][k], f"{path}.sc.{k}")
            elif p["sc"].get(k):
                raise KeyError(f"{path}.sc.{k}: the tree has a conv shortcut, the port none")
    elif isinstance(m, MgPool):
        if p or s:
            raise KeyError(f"{path}: a pool has no parameters, the tree has {sorted(p)}")
    else:
        raise TypeError(f"{path}: no JAX-tree mapping for {type(m).__name__}")


def load_jax_tree(model: nn.Module, params: dict, stats: dict) -> nn.Module:
    """Copy a JAX (params, stats) tree into ``model`` in place (values
    are cast to each parameter's dtype and device); returns ``model``.
    Raises on any key, shape or structure mismatch."""
    _load(model, params, stats, "")
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
