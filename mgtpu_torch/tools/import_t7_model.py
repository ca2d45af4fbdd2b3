"""Import a reference-trained Torch7 model checkpoint (`model_<E>.t7`,
written by `saveDataParallel`, `multigpu.lua:105`) into an mgtpu-ckpt,
mapping nn.Sequential conv/BN/Linear parameters onto the port's model:
the port's counterpart of `tools/import_t7_model.py`.

    python -m mgtpu_torch.tools.import_t7_model model_200.t7 \\
        --netType cifar/nmg --dataset cifar100-whitened --nLayer 1 \\
        --out model_imported.ckpt

Matching is ORDER-based, by the JAX tool's rules: the torch graph is
flattened depth-first (containers expand `modules`; DataParallelTable
keeps replica 1 only, `multigpu.lua:33-51`), the model's JAX-layout
tree (`mgtpu_torch.utils.bridge.export_jax_tree`) is flattened in apply
order (`_key_order`), and the two sequences are zipped with strict
shape checking: any mismatch aborts with both flattened sequences
printed. Layout translation: conv weights (O,I,kH,kW) -> HWIO,
SpatialConvolutionMM's flattened (O, I*kH*kW) weights are unfolded
first, Linear (O,I) -> (I,O), BN weight/bias -> scale/bias with
running_{mean,var} (legacy running_std is converted). Every slot of the
tree starts as an unfilled placeholder; a slot the blob does not fill
aborts the import. The filled tree goes into the model through
`load_jax_tree` and out through `write_checkpoint`: an mgtpu-ckpt that
`mgtpu_torch.serve.Server(ckpt=...)` and the JAX package both read. A
file conversion: no device is used.
"""

from __future__ import annotations

import argparse

import numpy as np

from mgtpu_torch.utils import t7


class Unfilled:
    """A leaf of the tree that the blob has not filled yet: its shape
    only (the JAX tool's abstract ``eval_shape`` leaf)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def flatten_torch(obj, out):
    """Depth-first parameterized modules of an nn graph."""
    if isinstance(obj, t7.TorchObject):
        f = obj.fields
        cls = obj.torch_type.rsplit(".", 1)[-1]
        w = f.get("weight")
        if isinstance(w, np.ndarray):
            if "running_mean" in f or "running_std" in f:
                out.append(("bn", obj))
            elif "FullConvolution" in cls:
                out.append(("fullconv", obj))
            elif cls == "Linear":
                out.append(("linear", obj))
            else:
                out.append(("conv", obj))
        mods = f.get("modules")
        if isinstance(mods, list) and mods:
            if cls == "DataParallelTable":
                mods = mods[:1]  # replicas are copies (`multigpu.lua:33-51`)
            for m in mods:
                flatten_torch(m, out)
    elif isinstance(obj, list):
        for m in obj:
            flatten_torch(m, out)
    return out


def _key_order(keys):
    # numeric keys in numeric order; ConvBN's conv strictly before bn
    # (the torch Sequential is [Conv, BN, ReLU]); stage keys s1<s2<sc
    # and c1<c2<sc are already alphabetical
    pri = {"conv": 0, "bn": 1}
    return sorted(keys, key=lambda k: ((0, int(k), "") if k.isdigit()
                                       else (1, pri.get(k, 99), k)))


def flatten_mg(params, stats, out):
    """Depth-first parameter slots of a JAX-layout model tree, in apply
    order. Slots are the live sub-dicts, so filling them in place fills
    the whole tree."""
    if not isinstance(params, dict):
        raise ValueError(f"unexpected non-dict param node: {params!r}")
    if "w" in params:
        out.append(("conv" if params["w"].ndim == 4 else "linear", params, stats))
        return out
    if "scale" in params and "bias" in params:
        out.append(("bn", params, stats))
        return out
    for k in _key_order(params):
        s = stats.get(k, {}) if isinstance(stats, dict) else {}
        flatten_mg(params[k], s, out)
    return out


def _conv_weight(kind: str, mod: t7.TorchObject) -> np.ndarray:
    w = np.asarray(mod["weight"], np.float32)
    if w.ndim == 2:  # SpatialConvolutionMM stores (O, I*kH*kW)
        ci = int(mod["nInputPlane"])
        kh, kw = int(mod["kH"]), int(mod["kW"])
        w = w.reshape(w.shape[0], ci, kh, kw)
    if kind == "fullconv":  # (I, O, kH, kW) -> HWIO
        return np.ascontiguousarray(w.transpose(2, 3, 0, 1))
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # (O,I,kH,kW)


def fill_slot(kind, tkind, mod, p, s):
    if kind == "conv":
        w = _conv_weight(tkind, mod)
        if w.shape != tuple(p["w"].shape):
            raise SystemExit(
                f"conv weight shape mismatch: torch {w.shape} vs mgtpu "
                f"{tuple(p['w'].shape)} — flattening orders disagree"
            )
        p["w"] = w
        b = mod.get("bias")
        if "b" in p:
            p["b"] = (np.asarray(b, np.float32) if isinstance(b, np.ndarray)
                      else np.zeros(w.shape[-1], np.float32))
        elif isinstance(b, np.ndarray) and np.any(b):
            # dropping a trained non-zero bias would silently offset
            # every activation of this conv
            raise SystemExit(
                "torch conv carries a non-zero bias but the target "
                "mgtpu conv was built without one (bias=False)"
            )
    elif kind == "linear":
        w = np.asarray(mod["weight"], np.float32).T  # (O,I) -> (I,O)
        if w.shape != tuple(p["w"].shape):
            raise SystemExit(
                f"linear weight shape mismatch: torch {w.shape} vs "
                f"mgtpu {tuple(p['w'].shape)}"
            )
        p["w"] = w
        b = mod.get("bias")
        p["b"] = (np.asarray(b, np.float32) if isinstance(b, np.ndarray)
                  else np.zeros(w.shape[-1], np.float32))
    else:  # bn
        c = int(np.asarray(mod["running_mean"]).shape[0]) if "running_mean" in mod \
            else int(np.asarray(mod["running_std"]).shape[0])
        if c != int(p["scale"].shape[0]):
            raise SystemExit(
                f"BN width mismatch: torch {c} vs mgtpu {int(p['scale'].shape[0])}"
            )
        w, b = mod.get("weight"), mod.get("bias")
        p["scale"] = (np.asarray(w, np.float32) if isinstance(w, np.ndarray)
                      else np.ones(c, np.float32))
        p["bias"] = (np.asarray(b, np.float32) if isinstance(b, np.ndarray)
                     else np.zeros(c, np.float32))
        if "running_mean" in mod:
            s["mean"] = np.asarray(mod["running_mean"], np.float32)
        if "running_var" in mod:
            s["var"] = np.asarray(mod["running_var"], np.float32)
        elif "running_std" in mod:  # legacy nn stored 1/sqrt(var+eps)
            std = np.asarray(mod["running_std"], np.float64)
            s["var"] = (1.0 / std**2).astype(np.float32)


def _unfilled(tree):
    if isinstance(tree, dict):
        return {k: _unfilled(v) for k, v in tree.items()}
    return Unfilled(tree.shape)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def import_model(blob_path: str, opt) -> tuple:
    """The (params, stats) numpy trees of the net ``opt`` names
    (a `mgtpu_torch.models.base.NetOpts`), every leaf taken from the
    blob; raises SystemExit on any mismatch or unfilled slot."""
    from mgtpu_torch.models import create_model
    from mgtpu_torch.utils.bridge import export_jax_tree

    params, stats = (_unfilled(t) for t in export_jax_tree(create_model(opt)))
    torch_mods = flatten_torch(t7.load(blob_path), [])
    mg_slots = flatten_mg(params, stats, [])
    t_kinds = [k for k, _ in torch_mods]
    m_kinds = [k for k, _, _ in mg_slots]
    norm = ["conv" if k == "fullconv" else k for k in t_kinds]
    if norm != m_kinds:
        raise SystemExit(
            "module sequences disagree:\n"
            f"  torch ({len(t_kinds)}): {t_kinds}\n"
            f"  mgtpu ({len(m_kinds)}): {m_kinds}\n"
            "order-based import is not possible for this pair"
        )
    for (tkind, mod), (kind, p, s) in zip(torch_mods, mg_slots):
        fill_slot(kind, tkind, mod, p, s)

    # every placeholder left is a parameter the torch blob did not
    # provide: it would serve as garbage, so fail closed
    bad = [x for tree in (params, stats) for x in _leaves(tree) if isinstance(x, Unfilled)]
    if bad:
        raise SystemExit(f"{len(bad)} parameters were not filled by the import")
    return params, stats


def main(argv=None):
    from mgtpu_torch.models import create_model
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.utils.bridge import export_jax_tree, load_jax_tree
    from mgtpu_torch.utils.checkpoint import model_meta, write_checkpoint

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("blob")
    ap.add_argument("--netType", required=True)
    ap.add_argument("--dataset", default="cifar100-whitened")
    ap.add_argument("--nLayer", type=int, default=1)
    ap.add_argument("--depth", type=int, default=34)
    ap.add_argument("--shortcutType", default="A")
    ap.add_argument("--isDropout", action="store_true")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    opt = NetOpts(netType=args.netType, dataset=args.dataset, nLayer=args.nLayer,
                  depth=args.depth, shortcutType=args.shortcutType, isDropout=args.isDropout)
    params, stats = import_model(args.blob, opt)
    model = load_jax_tree(create_model(opt), params, stats)
    params, stats = export_jax_tree(model)
    write_checkpoint(args.out, params, stats, None, args.epoch, model_meta(opt))
    n = sum(int(np.prod(x.shape)) for x in _leaves(params))
    print(f"imported {args.blob} -> {args.out} ({n:,} params)")


if __name__ == "__main__":
    main()
