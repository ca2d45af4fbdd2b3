"""The port's checkpoint writer (`mgtpu_torch/utils/checkpoint.py`): the
cases of tests/test_checkpoint.py, and the cross-package case: a
checkpoint the port writes loads in `mgtpu.utils.checkpoint` to the
same trees, epoch and meta. Every comparison is exact (bit for bit)."""

import json
import os
import pickle
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

from mgtpu.utils import opts as jax_opts
from mgtpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from mgtpu.utils.checkpoint import model_meta as jax_model_meta
from mgtpu_torch.models import create_model, get_spec
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.train.optim import sgd_init
from mgtpu_torch.train.step import make_train_step
from mgtpu_torch.utils import checkpoint as ck
from mgtpu_torch.utils import opts
from mgtpu_torch.utils.bridge import export_jax_tree, export_momentum

OPT = NetOpts(netType="cifar/nmg", dataset="cifar100-whitened")
META = {"netType": "cifar/nmg", "dataset": "cifar100-whitened", "nLayer": 1,
        "dtype": "float32"}


@pytest.fixture(scope="module")
def trained():
    """cifar/nmg (nLayer 1) after two f32 SGD steps on the CPU: model and
    momentum."""
    net = get_spec(OPT.netType)
    model = create_model(OPT, generator=torch.Generator().manual_seed(0)).train()
    state = sgd_init(model.parameters())
    step = make_train_step(model, net.create_loss(OPT), net)
    g = torch.Generator().manual_seed(1)
    batch = {"x": torch.randn(4, 32, 32, 3, generator=g), "y": torch.arange(4)}
    for _ in range(2):
        step(state, batch, 0.1, 5e-4)
    return model, state


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = (np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for v in (x, y))
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_checkpoint_roundtrip_bitexact(tmp_path, trained):
    model, state = trained
    path = str(tmp_path / "model_3.ckpt")
    ck.save_checkpoint(path, model, state, epoch=3, meta=META)
    got = ck.load_checkpoint(path)
    params, stats = export_jax_tree(model)
    assert got["epoch"] == 3 and got["meta"] == META
    _assert_trees_equal(got["params"], params)
    _assert_trees_equal(got["stats"], stats)
    _assert_trees_equal(got["opt_state"], export_momentum(model, state))


def test_port_checkpoint_loads_in_the_jax_package(tmp_path, trained):
    model, state = trained
    path = str(tmp_path / "model_1.ckpt")
    ck.save_checkpoint(path, model, state, epoch=1, meta=META)
    got = jax_load_checkpoint(path)
    params, stats = export_jax_tree(model)
    assert got["epoch"] == 1 and got["meta"] == META
    _assert_trees_equal(got["params"], params)
    _assert_trees_equal(got["stats"], stats)
    _assert_trees_equal(got["opt_state"], export_momentum(model, state))


def test_checkpoint_atomic_write(tmp_path, trained):
    model, state = trained
    path = str(tmp_path / "m.ckpt")
    ck.save_checkpoint(path, model, state)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_checkpoint_is_not_pickle(tmp_path):
    """A zip of raw npy arrays and a JSON structure, bf16 stored as its
    bits (read back as bf16 by both packages); a pickle file raises."""
    b16 = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b16": b16,
            "nest": {"t": (np.zeros(2), [np.ones(1)])}}
    path = str(tmp_path / "m.ckpt")
    ck.write_checkpoint(path, tree, {"s": np.float32(2.0)}, None, epoch=7,
                        meta={"netType": "cifar/nmg"})
    assert zipfile.is_zipfile(path)
    got = ck.load_checkpoint(path)
    assert got["epoch"] == 7 and got["opt_state"] is None
    assert got["params"]["b16"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["b16"], b16)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), tree["w"])
    assert isinstance(got["params"]["nest"]["t"], tuple)
    assert isinstance(got["params"]["nest"]["t"][1], list)
    jax_got = jax_load_checkpoint(path)
    assert jax_got["params"]["b16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jax_got["params"]["b16"].astype(np.float32), b16.float().numpy())
    with np.load(path) as z:
        struct = json.loads(str(z["__struct__"]))
    assert struct["format"] == "mgtpu-ckpt" and struct["version"] == 1

    legacy = str(tmp_path / "legacy.ckpt")
    with open(legacy, "wb") as f:
        pickle.dump({"params": {}, "stats": {}, "opt_state": None, "epoch": 1, "meta": {}}, f)
    with pytest.raises(ValueError, match="not an mgtpu-ckpt npz archive"):
        ck.load_checkpoint(legacy)


def test_checkpoint_rejects_non_str_keys(tmp_path):
    with pytest.raises(TypeError, match="keys must be str"):
        ck.write_checkpoint(str(tmp_path / "bad.ckpt"), {0: np.zeros(2)}, {}, None, 1, {})


def test_async_save_matches_sync(tmp_path, trained):
    model, state = trained
    p_sync, p_async = str(tmp_path / "sync.ckpt"), str(tmp_path / "async.ckpt")
    ck.save_checkpoint(p_sync, model, state, epoch=3, meta=META)
    ck.save_checkpoint(p_async, model, state, epoch=3, meta=META, async_write=True)
    a, s = ck.load_checkpoint(p_async), ck.load_checkpoint(p_sync)  # the load joins
    assert a["epoch"] == s["epoch"] == 3 and a["meta"] == s["meta"]
    for key in ("params", "stats", "opt_state"):
        _assert_trees_equal(a[key], s[key])
    # back-to-back async saves serialize (at most one in flight)
    ck.save_checkpoint(p_async, model, state, epoch=4, meta=META, async_write=True)
    ck.save_checkpoint(p_async, model, state, epoch=5, meta=META, async_write=True)
    assert ck.load_checkpoint(p_async)["epoch"] == 5


def test_async_save_copies_before_it_returns(tmp_path):
    """The SGD updates parameters in place: what an async save writes is
    the model as it was when save_checkpoint returned."""
    model = create_model(OPT, generator=torch.Generator().manual_seed(0))
    state = sgd_init(model.parameters())
    before = export_jax_tree(model)[0]
    path = str(tmp_path / "m.ckpt")
    ck.save_checkpoint(path, model, state, epoch=1, async_write=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ck.join_pending_saves()
    _assert_trees_equal(ck.load_checkpoint(path)["params"], before)


def test_async_save_failure_surfaces(tmp_path, monkeypatch):
    def boom(path, sjson, arrays):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ck, "_write_npz", boom)
    ck.write_checkpoint(str(tmp_path / "x.ckpt"), {"w": np.ones((2, 2), np.float32)}, {}, None,
                        epoch=1, meta={}, async_write=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.join_pending_saves()
    ck.join_pending_saves()  # the error is consumed


def test_model_meta_keys():
    """The JAX package's keys; -device is not among them."""
    argv = ["-netType", "ilsvrc/prnmgseg", "-depth", "52", "-dataset", "ilsvrc", "-train",
            "-dtype", "bfloat16"]
    meta = ck.model_meta(opts.parse(argv + ["-device", "cpu"]))
    assert meta == jax_model_meta(jax_opts.parse(argv))
    assert "device" not in meta
