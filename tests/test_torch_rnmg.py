"""R-MG-18/34 in the port (`mgtpu_torch.models`, `mgtpu_torch.serve`,
`mgtpu_torch.utils.bridge`) against the JAX package, on the CPU: the
size pins, the R-MG-18 eval forward at 1x224x224x3 unfolded and
BN-folded against jitted JAX, checkpoints written by
`mgtpu.utils.checkpoint`, and a port that never imports JAX."""

import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mgtpu.models import get_net as jax_get_net
from mgtpu.ops.fold import fold_batchnorm as jax_fold
from mgtpu.utils.checkpoint import save_checkpoint
from mgtpu_torch.models import NetOpts, create_model, get_spec
from mgtpu_torch.nn import param_count
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.serve import Server, calibrate_batchnorm
from mgtpu_torch.utils.bridge import (export_jax_tree, export_momentum, load_jax_tree,
                                      load_momentum, read_mgtpu_ckpt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jitter_bn(p, s, rng):
    """Non-trivial BN affines and running stats everywhere in a tree
    (numpy, in place), so the fold has something to absorb."""
    for k, v in p.items():
        if k == "bn" and v:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
            v["bias"] = rng.normal(0, 0.2, v["bias"].shape).astype(np.float32)
            s[k]["mean"] = rng.normal(0, 0.2, s[k]["mean"].shape).astype(np.float32)
            s[k]["var"] = rng.uniform(0.5, 1.5, s[k]["var"].shape).astype(np.float32)
        elif isinstance(v, dict):
            _jitter_bn(v, s.get(k, {}), rng)
    return p, s


@pytest.mark.parametrize("depth,n", [(34, 32_899_176), (18, 15_847_752)])
def test_param_count(depth, n):
    assert param_count(create_model(NetOpts(depth=depth))) == n


def test_registry():
    """The whole JAX zoo is registered, the saliency harness last; an
    unknown name is refused."""
    assert get_spec("mnist-cluttered/mnist-saliency").name == "mnist-cluttered/mnist-saliency"
    with pytest.raises(KeyError, match="unknown net"):
        get_spec("mnist-cluttered/nonesuch")


@pytest.fixture(scope="module")
def rmg18():
    """The JAX R-MG-18 with jittered BN, its log-probs on one image, and
    its BN-folded tree."""
    model = jax_get_net("ilsvrc/rnmg").create_model(types.SimpleNamespace(depth=18))
    p, s = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0)))
    p, s = _jitter_bn(p, s, np.random.default_rng(1))
    x = np.random.default_rng(2).standard_normal((1, 224, 224, 3), dtype=np.float32)
    fwd = jax.jit(lambda p, s, x: model.apply(p, s, x)[0])
    ref = np.asarray(fwd(p, s, jnp.asarray(x)))
    fp, fs = jax_fold(model, p, s)
    ref_folded = np.asarray(fwd(fp, fs, jnp.asarray(x)))
    return types.SimpleNamespace(p=p, s=s, fp=fp, fs=fs, x=x, ref=ref, ref_folded=ref_folded)


def _port18():
    return create_model(NetOpts(depth=18))


# f32 on both sides. Each of the 18 layers sums up to 4,608 products in
# another order than XLA, and the deep random-init net grows its logits
# to the thousands, so the bound is relative to the log-probs' scale
# (measured: 4e-7 of it).
def _assert_logprobs_close(got, ref):
    assert got.shape == ref.shape == (1, 1000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_rmg18_forward_matches_jax(rmg18):
    model = load_jax_tree(_port18(), rmg18.p, rmg18.s)
    with torch.inference_mode():
        got = model(torch.from_numpy(rmg18.x))
    _assert_logprobs_close(got, rmg18.ref)
    # each row is a distribution
    torch.testing.assert_close(got.exp().sum(-1), torch.ones(1), rtol=0, atol=1e-5)


def test_rmg18_folded_forward_matches_jax(rmg18):
    """The port's fold against JAX's folded forward, and the JAX-folded
    tree (its BNs empty dicts) loaded into the port."""
    model = fold_batchnorm(load_jax_tree(_port18(), rmg18.p, rmg18.s))
    folded_in_jax = load_jax_tree(_port18(), rmg18.fp, rmg18.fs)
    x = torch.from_numpy(rmg18.x)
    with torch.inference_mode():
        got = model(x)
        got_jax_folded = folded_in_jax(x)
    _assert_logprobs_close(got, rmg18.ref_folded)
    _assert_logprobs_close(got_jax_folded, rmg18.ref_folded)
    _assert_logprobs_close(got, rmg18.ref)


def _assert_trees_equal(got, ref):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("folded", [False, True])
def test_rmg18_bridge_round_trip(rmg18, folded):
    """export_jax_tree inverts load_jax_tree, folded BNs (empty dicts)
    included, and the SGD momentum tree carries across both ways."""
    p, s = (rmg18.fp, rmg18.fs) if folded else (rmg18.p, rmg18.s)
    model = load_jax_tree(_port18(), p, s)
    got_p, got_s = export_jax_tree(model)
    _assert_trees_equal(got_p, p)
    _assert_trees_equal(got_s, s)
    rng = np.random.default_rng(6)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), p)
    opt = load_momentum(model, {"m": m})
    assert [t.shape for t in opt["m"]] == [q.shape for q in model.parameters()]
    _assert_trees_equal(export_momentum(model, opt)["m"], m)


def test_server_from_jax_checkpoint(rmg18, tmp_path):
    """A checkpoint the JAX trainer writes serves in the port: read
    without JAX, BN folded, f32 on the CPU."""
    path = str(tmp_path / "model_1.ckpt")
    save_checkpoint(path, rmg18.p, rmg18.s, epoch=1,
                    meta={"netType": "ilsvrc/rnmg", "depth": 18})
    server = Server(ckpt=path, device="cpu", compute_dtype=torch.float32)
    assert server.opt.depth == 18
    got = server.predict(rmg18.x)
    _assert_logprobs_close(got, rmg18.ref)


def test_random_server_serves_calibrated_folded_net():
    """A seeded random server: BatchNorms calibrated to their inputs keep
    the log-probs at a trained net's scale, the fold leaves them as they
    were, and the same seed gives the same weights."""
    x = np.random.default_rng(3).standard_normal((2, 224, 224, 3), dtype=np.float32)
    kw = dict(opt=NetOpts(depth=18), seed=4, device="cpu", compute_dtype=torch.float32)
    y = Server(**kw).predict(x)
    # the same weights, unfolded
    gen = torch.Generator().manual_seed(4)
    unfolded = create_model(NetOpts(depth=18), generator=gen)
    calibrate_batchnorm(unfolded, gen)
    with torch.inference_mode():
        y_unfolded = unfolded(torch.from_numpy(x))
    assert y.shape == (2, 1000) and bool(torch.isfinite(y).all())
    assert y.abs().max() < 100
    torch.testing.assert_close(torch.logsumexp(y, -1), torch.zeros(2), rtol=0, atol=1e-5)
    # BN after the conv vs W*a folded into it: f32 reassociation
    torch.testing.assert_close(y, y_unfolded, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="NHWC"):
        Server(**kw).predict(x[:, :112])


def test_read_mgtpu_ckpt_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    params = {"0": {"w": rng.standard_normal((3, 3, 2, 4), dtype=np.float32),
                    "b": rng.standard_normal(4, dtype=np.float32).astype(ml_dtypes.bfloat16)},
              "1": {}}
    stats = {"0": {"bn": {"mean": np.zeros(4, np.float32)}}, "1": {}}
    opt = [np.arange(3, dtype=np.int32), (np.ones(2, np.float32),)]
    path = str(tmp_path / "t.ckpt")
    save_checkpoint(path, params, stats, opt_state=opt, epoch=7, meta={"depth": 34})
    blob = read_mgtpu_ckpt(path)
    assert blob["epoch"] == 7 and blob["meta"] == {"depth": 34}
    assert blob["params"]["1"] == {} and blob["stats"]["1"] == {}
    np.testing.assert_array_equal(blob["params"]["0"]["w"].numpy(), params["0"]["w"])
    b = blob["params"]["0"]["b"]
    assert b.dtype == torch.bfloat16  # stored as uint16 bits
    np.testing.assert_array_equal(b.float().numpy(), params["0"]["b"].astype(np.float32))
    assert isinstance(blob["opt_state"], list) and isinstance(blob["opt_state"][1], tuple)
    np.testing.assert_array_equal(blob["opt_state"][0].numpy(), opt[0])


def test_read_mgtpu_ckpt_refuses_other_files(tmp_path):
    path = tmp_path / "not.ckpt"
    path.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="not an mgtpu-ckpt"):
        read_mgtpu_ckpt(str(path))


def test_port_never_imports_jax(tmp_path):
    """Import every module of the port, run a small multigrid net on the
    CPU, serve and train a CIFAR net (cifar/prnmg with dropout), and run
    the CLI's train and test loop on a small net in a fresh interpreter:
    neither JAX nor the JAX package gets imported, nor h5py (the port
    writes and reads its HDF5 files through mgtpu_torch.utils.h5)."""
    code = textwrap.dedent("""
        import sys, numpy as np, torch
        import mgtpu_torch.serve, mgtpu_torch.kernels, mgtpu_torch.trainer
        import mgtpu_torch.main, mgtpu_torch.pipelines.standard, mgtpu_torch.data
        import mgtpu_torch.pipelines.saliency, mgtpu_torch.utils.h5, mgtpu_torch.ops
        from mgtpu_torch.tools import (download_mnist, generate_mnist_cluttered, ingest_cifar,
                                       render_predictions, render_saliency, seg_metrics,
                                       soak_chain)
        from mgtpu_torch.models import NetOpts
        from mgtpu_torch.models.common import LogSoftmaxClassifier, MgNet
        from mgtpu_torch.ops.fold import fold_batchnorm
        from mgtpu_torch.ops.mg import MgPool, MgResidual, MgStem7x7
        g = torch.Generator().manual_seed(0)
        net = MgNet([MgStem7x7([6, 5, 4], generator=g), MgResidual([6, 5, 4], [6, 5, 4], generator=g),
                     MgPool([6, 5, 4], "concat"), MgResidual([6, 9], [8, 8], generator=g),
                     LogSoftmaxClassifier(8, 10, pool=4, generator=g)]).eval()
        with torch.inference_mode():
            y = fold_batchnorm(net)(torch.randn(2, 32, 32, 3, generator=g))
        assert y.shape == (2, 10) and bool(torch.isfinite(y).all())
        opt = NetOpts(netType="cifar/prnmg", isDropout=True)
        x = np.zeros((2, 32, 32, 3), np.float32)
        y = mgtpu_torch.serve.Server(opt, device="cpu", compute_dtype=torch.float32).predict(x)
        assert y.shape == (2, 100) and bool(torch.isfinite(y).all())
        tr = mgtpu_torch.trainer.Trainer(opt, device="cpu", compute_dtype=torch.float32)
        assert np.isfinite(float(tr.step(x, np.array([1, 2]), 0.01, 5e-4)["loss"]))
        sess = mgtpu_torch.main.main(["-netType", "mnist-cluttered/unet", "-dataset", "mnist-sca",
                                      "-data", "synthetic", "-synthSize", "8", "-batchSize", "4",
                                      "-nEpochs", "1", "-epochSize", "1", "-cache", sys.argv[1],
                                      "-device", "cpu", "-train", "-test"])
        assert sess.epoch == 1
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "mgtpu", "ml_dtypes", "h5py"))
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stdout + r.stderr


def test_data_layer_imports_no_torch():
    """The data layer and the native loader import neither torch nor jax
    (process-mode donkeys import them and must not initialise CUDA), nor
    PIL until a loader needs it; the synthetic ILSVRC set needs none of
    them. Nor do the HDF5 layer and the data and file tools, as their
    JAX counterparts import no torch (and import PIL only to draw), nor
    h5py."""
    code = textwrap.dedent("""
        import sys
        import mgtpu_torch.data, mgtpu_torch.native, mgtpu_torch.data.prefetch
        import mgtpu_torch.utils.h5
        from mgtpu_torch.tools import (download_mnist, generate_mnist_cluttered, ingest_cifar,
                                       render_predictions, render_saliency, seg_metrics,
                                       soak_chain)
        from mgtpu_torch.data import get_loaders
        from types import SimpleNamespace
        opt = SimpleNamespace(dataset="ilsvrc", data="synthetic", synthSize=8, synthClasses=10)
        x, y = get_loaders(opt)["train"].gen_inputs(2, 1, 0)
        assert x.shape == (2, 224, 224, 3), x.shape
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "jaxlib", "mgtpu", "ml_dtypes", "PIL",
                                            "h5py"))
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr
