"""Checkpoint save/load in the JAX package's mgtpu-ckpt format
(counterpart of `mgtpu/utils/checkpoint.py`).

A checkpoint is a versioned npz archive: a ``__struct__`` JSON record of
the trees (dicts, lists, tuples, None) with array leaves swapped for
indices ``a0``, ``a1``, ... into raw npy arrays, never a pickle. bf16
and float8 leaves are stored as same-width integer views, their real
dtype recorded in the structure. The trees are the JAX package's
(``utils/bridge.py``: parameters and BN stats in its structure, the SGD
momentum as ``{"m": tree}``), so a checkpoint the port writes loads in
`mgtpu.utils.checkpoint` and the other way round. Like the JAX format it
carries the flags that rebuild the net (``model_meta``), which the
``mnist-test`` harness reads.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from mgtpu_torch.utils.bridge import (CKPT_FORMAT, CKPT_VERSION, export_jax_tree,
                                      export_momentum, read_mgtpu_ckpt)

# real dtype -> (its name in the structure, the torch dtype of the same
# width to view it as, the numpy dtype the JAX package stores)
_VIEW_DTYPES = {
    torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8),
}


def _host(x) -> tuple[np.ndarray, Optional[str]]:
    """A leaf as a host array of its own (a copy, never a view of a live
    tensor), and the real dtype's name where the array holds its bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in _VIEW_DTYPES:
            name, view, stored = _VIEW_DTYPES[x.dtype]
            return x.cpu().view(view).numpy().view(stored).copy(), name
        x = x.cpu().numpy()
    return np.array(x, copy=True), None


def _encode(tree, arrays: list):
    """Tree -> JSON-able structure with array leaves swapped for indices
    into ``arrays`` (the leaves copied to the host)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        for k in tree:
            # keys round-trip as strings: a non-str key would load as a
            # different tree. A raise, not an assert (-O strips those).
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, got {k!r}")
        return {"t": "d", "k": {k: _encode(v, arrays) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"t": "l" if isinstance(tree, list) else "u",
                "c": [_encode(v, arrays) for v in tree]}
    x, dtype = _host(tree)
    entry: Dict[str, Any] = {"t": "a", "i": len(arrays)}
    if dtype is not None:
        entry["dtype"] = dtype
    arrays.append(x)
    return entry


# -- async write plumbing -------------------------------------------------
# At most one writer thread is pending: a new save (or any load) joins the
# previous one first, and mgtpu_torch.main joins in its `finally`, so a
# crash mid-run leaves at worst an orphaned `.tmp`, never a torn
# checkpoint (the visible file only ever appears through os.replace).
_pending_save: Optional[threading.Thread] = None
_pending_error: Optional[BaseException] = None


def pending_save_failed() -> bool:
    """Join any in-flight async write and report, without clearing or
    raising, whether it failed: a data-parallel run tells every rank, so
    that all stop together."""
    global _pending_save
    if _pending_save is not None:
        _pending_save.join()
        _pending_save = None
    return _pending_error is not None


def join_pending_saves() -> None:
    """Block until any in-flight async checkpoint write has completed.
    Re-raises a background write failure (ENOSPC, permissions, ...):
    otherwise a run would print 'checkpoint -> path' and exit 0 with no
    checkpoint on disk."""
    global _pending_save, _pending_error
    if _pending_save is not None:
        _pending_save.join()
        _pending_save = None
    if _pending_error is not None:
        err, _pending_error = _pending_error, None
        raise RuntimeError("async checkpoint write failed") from err


def _write_npz(path: str, struct_json: str, arrays: list) -> None:
    tmp = path + ".tmp"
    # savez on a file object, so numpy does not append ".npz" to the name
    with open(tmp, "wb") as f:
        np.savez(f, __struct__=struct_json, **{f"a{i}": x for i, x in enumerate(arrays)})
    os.replace(tmp, path)


def _write_npz_bg(path: str, struct_json: str, arrays: list) -> None:
    global _pending_error
    try:
        _write_npz(path, struct_json, arrays)
    except BaseException as e:  # surfaced by the next join_pending_saves
        _pending_error = e


def write_checkpoint(path: str, params, stats, opt_state=None, epoch: int = 0,
                     meta: Optional[Dict[str, Any]] = None, async_write: bool = False) -> None:
    """Write trees (numpy or torch leaves) as a checkpoint: the JAX
    package's ``save_checkpoint``. Every leaf is copied to the host here,
    before this returns, also with ``async_write``: the port's SGD
    updates the parameters in place, so the next step must not run under
    a copy still in flight. Only the npz serialisation and the disk write
    move to a background thread; at most one write is in flight."""
    global _pending_save
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: list = []
    struct = {
        "format": CKPT_FORMAT,
        "version": CKPT_VERSION,
        "epoch": int(epoch),
        "meta": meta or {},
        "params": _encode(params, arrays),
        "stats": _encode(stats, arrays),
        "opt_state": _encode(opt_state, arrays),
    }
    sjson = json.dumps(struct)
    if not async_write:
        _write_npz(path, sjson, arrays)
        return
    join_pending_saves()
    t = threading.Thread(target=_write_npz_bg, args=(path, sjson, arrays),
                         name="mgtpu-ckpt-writer", daemon=True)
    t.start()
    _pending_save = t


def save_checkpoint(path: str, model: torch.nn.Module, opt_state: Optional[dict] = None,
                    epoch: int = 0, meta: Optional[Dict[str, Any]] = None,
                    async_write: bool = False) -> None:
    """Write ``model``'s parameters and BN stats and, where given, its SGD
    state (`mgtpu_torch.train.optim`) in the JAX package's trees: see
    ``write_checkpoint``."""
    params, stats = export_jax_tree(model)
    momentum = export_momentum(model, opt_state) if opt_state is not None else None
    write_checkpoint(path, params, stats, momentum, epoch, meta, async_write)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint (``bridge.read_mgtpu_ckpt``: torch leaves, bf16
    and float8 in their real dtype), after any in-flight write. A file
    that is not an npz archive raises: legacy pickle checkpoints are not
    read."""
    join_pending_saves()
    return read_mgtpu_ckpt(path)


def model_meta(opt) -> Dict[str, Any]:
    """Flags a checkpoint needs to rebuild its architecture."""
    keys = ("netType", "dataset", "nLayer", "isDropout", "depth", "shortcutType", "dtype")
    return {k: getattr(opt, k) for k in keys if hasattr(opt, k)}
