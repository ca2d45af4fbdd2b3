"""Write weights as an mgtpu-ckpt archive, the checkpoint format both the
JAX package and the port read (a ``__struct__`` JSON record of the
trees, each array leaf an ``a<i>`` entry of an uncompressed npz). The
benchmark hands its drawn weights to the program through this file, the
path a trained checkpoint takes."""

from __future__ import annotations

import json

import numpy as np


def _encode(tree, arrays):
    if isinstance(tree, dict):
        return {"t": "d", "k": {k: _encode(v, arrays) for k, v in tree.items()}}
    arrays.append(tree.detach().float().cpu().numpy())
    return {"t": "a", "i": len(arrays) - 1}


def write(path, params, stats, meta: dict) -> None:
    arrays = []
    struct = {"format": "mgtpu-ckpt", "version": 1, "epoch": 0, "meta": meta,
              "params": _encode(params, arrays), "stats": _encode(stats, arrays),
              "opt_state": None}
    with open(path, "wb") as f:
        np.savez(f, __struct__=json.dumps(struct), **{f"a{i}": a for i, a in enumerate(arrays)})
