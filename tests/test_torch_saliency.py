"""The saliency harness of the port (`mgtpu_torch/pipelines/saliency.py`,
`mgtpu_torch/models/mnist_cluttered/mnist_saliency.py`) against the JAX
package's (`mgtpu/pipelines/saliency.py`), on the CPU.

- the host probe (`interest_point`, `saliency_map`, numpy copies) bit
  for bit;
- the device probe (`interest_points`, `saliency_maps`, torch, batched
  over a group) against jitted ``_interest_point_jnp`` /
  ``_saliency_map_jnp`` on the cases of tests/test_saliency.py: valid
  and points bit for bit, saliency at rtol 1e-5 / atol 1e-6;
- ``run`` with a tanh stub model through each of its three paths (the
  host probe on the whole stack; the stack built and probed on the
  device; a host-built stack probed on the device): the same
  testOutput.h5 as the JAX ``run`` and, in the port, at -saliencyBatch 1
  as at 3;
- the slice: a narrowed pnmg.mnist checkpoint (written by the JAX
  package, and the same weights written by the port) served by the
  mnist-saliency harness through both packages' ``main`` with
  ``-pipeline saliency`` at -saliencyDumpStack 1 and 0, on a loader whose
  occlusion masks are cut to a few windows (a JAX compile of the
  842-stack takes minutes).
"""

import contextlib
import io
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgtpu.data.mnist as jmnist
import mgtpu.main as jmain
import mgtpu.models.mnist_cluttered.pnmg_mnist as jpnmg_mnist
from mgtpu.data.prefetch import DonkeyPool as JaxDonkeyPool
from mgtpu.pipelines import saliency as jsal
from mgtpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
import mgtpu_torch.data.mnist as tmnist
import mgtpu_torch.main as tmain
import mgtpu_torch.models.mnist_cluttered.pnmg_mnist as tpnmg_mnist
from mgtpu_torch.data.prefetch import DonkeyPool
from mgtpu_torch.models import create_model, get_spec
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.pipelines import saliency as sal
from mgtpu_torch.serve import calibrate_batchnorm
from mgtpu_torch.utils import h5
from mgtpu_torch.utils.bridge import export_jax_tree
from mgtpu_torch.utils.checkpoint import save_checkpoint
from test_torch_cifar_models import few_torch_threads  # noqa: F401 (autouse fixture)

def _probe_cases():
    """tests/test_saliency.py's outputs: confident boxes (one clamped at
    the border), noise, nothing over the threshold, a single column."""
    rng = np.random.default_rng(5)
    cases = []
    for (r0, r1, c0, c1) in [(4, 12, 6, 10), (0, 15, 0, 15), (2, 3, 5, 9)]:
        o = np.zeros((16, 16, 1), np.float32)
        o[r0:r1 + 1, c0:c1 + 1, 0] = 0.9
        cases.append(o)
    cases.append(rng.random((16, 16, 1)).astype(np.float32))
    cases.append(np.zeros((16, 16, 1), np.float32))
    one_col = np.zeros((16, 16, 1), np.float32)
    one_col[:, 7, 0] = 1.0
    cases.append(one_col)
    mask = (rng.random((10, 16, 16, 1)) > 0.7).astype(np.float32)
    outputs = np.stack([np.concatenate([o[None], rng.random((10, 16, 16, 1)).astype(np.float32)])
                        for o in cases])  # (6, 11, 16, 16, 1)
    return outputs, mask


@pytest.mark.parametrize("case", range(6))
def test_host_probe_is_jax_bit_for_bit(case):
    outputs, mask = _probe_cases()
    o = outputs[case]
    got, ref = sal.interest_point(o[0]), jsal.interest_point(o[0])
    assert (got is None) == (ref is None) == (case >= 4)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(sal.saliency_map(o, got, mask),
                                      jsal.saliency_map(o, ref, mask))


def test_device_probe_matches_jax_and_the_host_probe():
    """The group's probe at once (k = 6): valid and points as jitted
    _interest_point_jnp gives them (and as the host probe, where valid),
    saliency as _saliency_map_jnp's at test_saliency.py's tolerance."""
    outputs, mask = _probe_cases()
    valid, points = sal.interest_points(torch.from_numpy(outputs[:, 0]))
    jv, jp = jax.jit(jax.vmap(jsal._interest_point_jnp))(jnp.asarray(outputs[:, 0]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(points.numpy(), np.asarray(jp))
    assert valid.tolist() == [True] * 4 + [False] * 2
    got = sal.saliency_maps(torch.from_numpy(outputs), points, torch.from_numpy(mask)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jsal._saliency_map_jnp, (0, 0, None)))(
        jnp.asarray(outputs), jp, jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for j in range(4):
        np.testing.assert_array_equal(points[j].numpy(), sal.interest_point(outputs[j, 0]))
        np.testing.assert_allclose(got[j], sal.saliency_map(outputs[j], points[j].numpy(), mask),
                                   rtol=1e-5, atol=1e-6)


class _JaxTanh:
    def apply(self, p, s, x, train=False, rng=None):
        return jnp.tanh(x), s


def _stub_session(jax_side, save, k, dump, expand):
    """A session of the stub model on 5 synthetic mnist-saliency samples,
    as tests/test_saliency.py builds one; ``expand`` "host" under dump 0
    swaps in a loader that builds the stacks on the host."""
    opt = types.SimpleNamespace(dataset="mnist-saliency", data="synthetic", synthSize=5,
                                saliencyBatch=k, saliencyDumpStack=dump, save=str(save))
    mod = jmnist if jax_side else tmnist
    loaders = {"test": mod.build_mnist_saliency(opt)["test"]}
    if loaders["test"].expand != expand:
        test = loaders["test"]
        loaders["test"] = mod.SaliencyDataset(test.inputs, test.targets, test.mask, expand)
    if jax_side:
        sess = types.SimpleNamespace(opt=opt, model=_JaxTanh(), params={}, stats={},
                                     loaders=loaders)
        sess.pool = JaxDonkeyPool(0, opt=opt, loaders=loaders)
    else:
        sess = types.SimpleNamespace(opt=opt, model=torch.tanh, device=torch.device("cpu"),
                                     loaders=loaders)
        sess.pool = DonkeyPool(0, opt=opt, loaders=loaders)
    return sess


def _read(path, reader=h5py) -> dict:
    """A dump's arrays through h5py, or through the port's HDF5 layer
    (``reader=h5``)."""
    with reader.File(path, "r") as f:
        return {gid: {ds: np.asarray(f[gid][ds]) for ds in f[gid]} for gid in f}


def _same_reads(path) -> dict:
    """The dump read through the port's layer, bit for bit h5py's read."""
    got, ref = _read(path, h5), _read(path)
    assert sorted(got) == sorted(ref)
    for gid in ref:
        assert sorted(got[gid]) == sorted(ref[gid])
        for ds, want in ref[gid].items():
            assert got[gid][ds].dtype == want.dtype and got[gid][ds].shape == want.shape
            assert got[gid][ds].tobytes() == want.tobytes(), f"{gid}/{ds}"
    return got


def _assert_dumps_match(got, ref, out_atol):
    """The same groups and datasets: points and input bit for bit,
    saliency at rtol 1e-5 / atol 1e-6 (a sum over the variants in
    another order), outputs within ``out_atol``."""
    assert sorted(got) == sorted(ref) and got
    for gid in ref:
        assert sorted(got[gid]) == sorted(ref[gid]), gid
        for ds, want in ref[gid].items():
            if ds == "saliency":
                np.testing.assert_allclose(got[gid][ds], want, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{gid}/{ds}")
            elif ds == "output":
                np.testing.assert_allclose(got[gid][ds], want, rtol=0, atol=out_atol,
                                           err_msg=f"{gid}/{ds}")
            else:
                np.testing.assert_array_equal(got[gid][ds], want, err_msg=f"{gid}/{ds}")


@pytest.mark.parametrize("dump,expand", [(1, "host"), (0, "device"), (0, "host")],
                         ids=["host-probe", "device-stack", "host-stack-device-probe"])
def test_run_matches_jax_and_the_group_size(dump, expand, tmp_path):
    """The port's run at -saliencyBatch 3 (a padded last group) writes
    the JAX run's h5, and at -saliencyBatch 1 the same h5 bit for bit.
    The stub is tanh, which torch and XLA round up to 2 ulps apart: the
    outputs (written by the whole-stack path) within 1e-6, the probes
    bit for bit."""
    jsal.run(_stub_session(True, tmp_path / "jax", 3, dump, expand))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sal.run(_stub_session(False, tmp_path / "k3", 3, dump, expand))
    sal.run(_stub_session(False, tmp_path / "k1", 1, dump, expand))
    ref = _read(tmp_path / "jax" / "testOutput.h5")
    got = _read(tmp_path / "k3" / "testOutput.h5")
    _assert_dumps_match(got, ref, out_atol=1e-6)
    # the same files through the port's HDF5 layer (JAX's written by h5py)
    _assert_dumps_match(_same_reads(tmp_path / "k3" / "testOutput.h5"),
                        _same_reads(tmp_path / "jax" / "testOutput.h5"), out_atol=1e-6)
    assert ("output" in next(iter(got.values()))) == bool(dump)
    k1 = _read(tmp_path / "k1" / "testOutput.h5")
    assert sorted(k1) == sorted(got)
    for gid in got:
        for ds in got[gid]:
            np.testing.assert_array_equal(k1[gid][ds], got[gid][ds], err_msg=f"{gid}/{ds}")
    lines = out.getvalue().splitlines()
    assert lines[:2] == ["==> doing epoch on testing data:", "==> online epoch # 1"]
    assert lines[2:2 + len(got)] == sorted(got)
    assert "samples/s, group size 3)" in lines[-2] and lines[-1].endswith("testOutput.h5")


@pytest.mark.parametrize("device", [None, "cpu"], ids=["no-device", "cpu"])
def test_a_session_names_its_device(device, tmp_path):
    """A session without a device is refused (no quiet fall-back to the
    CPU); one whose device is the CPU (-device cpu) runs its groups
    there and gives the JAX run's samples."""
    sess = _stub_session(False, tmp_path, 3, 1, "host")
    if device is None:
        del sess.device
        with pytest.raises(ValueError, match="names no device"):
            next(sal.saliency_samples(sess))
        return
    steps = []

    class Recorded(sal.GroupStep):
        def __init__(self, *args):
            super().__init__(*args)
            steps.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sal, "GroupStep", Recorded)
        got = dict(sal.saliency_samples(sess))
    assert len(steps) == 1 and steps[0].device == torch.device(device)
    jsal.run(_stub_session(True, tmp_path / "jax", 3, 1, "host"))
    ref = _read(tmp_path / "jax" / "testOutput.h5")
    assert sorted(ref) == [f"id{i:05d}" for i in sorted(got)]
    for i, arrays in got.items():
        np.testing.assert_array_equal(arrays["points"], ref[f"id{i:05d}"]["points"])


# the slice: pnmg.mnist narrowed as tests/test_torch_seg_train.py narrows it,
# on occlusion masks cut to the first WINDOWS of the 841 windows
NARROW = {"BLOCKS4": [8, 6, 5, 4]}
WINDOWS = 6
RECIPE = ["-netType", "mnist-cluttered/mnist-saliency", "-dataset", "mnist-saliency",
          "-data", "synthetic", "-synthSize", "2", "-nDonkeys", "1", "-batchSize", "1",
          "-pipeline", "saliency", "-test"]


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """The narrowed pnmg.mnist's seeded weights, its BatchNorms calibrated
    to their inputs as the serving tests calibrate them, in a checkpoint
    written by each package; both packages' mains on them at
    -saliencyDumpStack 1 and 0 (-saliencyBatch 2, one group). Returns
    {(package, dump, writer): h5 contents read by h5py, and under
    (package, dump, writer, h5) the same read through the port's HDF5
    layer} and the port's outputs."""
    tmp = tmp_path_factory.mktemp("saliency")
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jpnmg_mnist, tpnmg_mnist):
            mp.setattr(mod, "BLOCKS4", NARROW["BLOCKS4"])
        for mod in (jmnist, tmnist):
            full = mod.occlusion_masks
            mp.setattr(mod, "occlusion_masks", lambda full=full: full()[:WINDOWS])
        opt = NetOpts(netType="mnist-cluttered/pnmg.mnist", dataset="mnist-aff")
        gen = torch.Generator().manual_seed(0)
        model = create_model(opt, generator=gen)
        calibrate_batchnorm(model, gen, get_spec(opt.netType).image_shape)
        meta = {"netType": opt.netType, "dataset": opt.dataset, "dtype": "float32"}
        ckpts = {"jax": str(tmp / "jax.ckpt"), "port": str(tmp / "port.ckpt")}
        jax_save_checkpoint(ckpts["jax"], *export_jax_tree(model), epoch=1, meta=meta)
        save_checkpoint(ckpts["port"], model, None, 1, meta)
        runs, outs = {}, {}
        for dump in (1, 0):
            flags = RECIPE + ["-saliencyBatch", "2", "-saliencyDumpStack", str(dump)]
            for writer, path in ckpts.items():
                cache = tmp / f"port-{dump}-{writer}"
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    sess = tmain.main(flags + ["-trainedNet", path, "-cache", str(cache),
                                               "-device", "cpu"])
                runs["port", dump, writer] = _read(f"{sess.opt.save}/testOutput.h5")
                runs["port", dump, writer, h5] = _same_reads(f"{sess.opt.save}/testOutput.h5")
                outs[dump, writer] = buf.getvalue()
            cache = tmp / f"jax-{dump}"
            jmain.main(flags + ["-trainedNet", ckpts["jax"], "-cache", str(cache)])
            runs["jax", dump, "jax"] = _read(next(cache.rglob("testOutput.h5")))
            runs["jax", dump, "jax", h5] = _same_reads(next(cache.rglob("testOutput.h5")))
        return runs, outs
    finally:
        mp.undo()


def test_slice_matches_jax(slice_runs):
    """The port's h5 against the JAX run's on the same weights and data:
    points and input bit for bit, saliency at rtol 1e-5 / atol 1e-6, the
    outputs within 1e-5 of their scale; each sample's un-occluded output
    is at least that far from the 0.4 threshold, and each impact from
    0.1, so the probes and the gates are the JAX ones by the outputs'
    tolerance and not by the data's luck (the margins are printed)."""
    runs, _ = slice_runs
    for dump in (1, 0):
        ref = runs["jax", dump, "jax"]
        scale = max(np.abs(a["output"]).max() for a in runs["jax", 1, "jax"].values())
        _assert_dumps_match(runs["port", dump, "port"], ref, out_atol=1e-5 * scale)
        # through the port's HDF5 layer: its dump against JAX's (h5py's)
        _assert_dumps_match(runs["port", dump, "port", h5], runs["jax", dump, "jax", h5],
                            out_atol=1e-5 * scale)
    got = runs["port", 1, "port"]
    for gid, arrays in got.items():
        out = arrays["output"]
        tol = 1e-5 * np.abs(out).max()
        margin = np.abs(out[0] - 0.4).min()
        diff = np.abs(out[1:] - out[:1])
        impact = np.stack([(diff * arrays["points"][j]).reshape(WINDOWS, -1).max(1)
                           for j in range(7)], 1)
        impact_margin = np.abs(impact - 0.1).min()
        print(f"{gid}: output margin to 0.4 {margin:.3g}, impact margin to 0.1 "
              f"{impact_margin:.3g} (tolerance {tol:.3g}); {int((impact >= 0.1).sum())} of "
              f"{impact.size} impacts kept")
        assert margin > tol and impact_margin > tol


def test_slice_reads_either_writer_and_prints_the_harness_lines(slice_runs):
    """The port's run from the port-written checkpoint equals its run from
    the JAX-written one bit for bit, at both -saliencyDumpStack; its log
    has the JAX run's lines."""
    runs, outs = slice_runs
    for dump in (1, 0):
        a, b = runs["port", dump, "port"], runs["port", dump, "jax"]
        assert sorted(a) == sorted(b)
        for gid in a:
            for ds in a[gid]:
                np.testing.assert_array_equal(a[gid][ds], b[gid][ds])
        text = outs[dump, "port"]
        assert "==> online epoch # 1" in text and "group size 2)" in text, text[-500:]
        assert ("output" in next(iter(a.values()))) == bool(dump)


def test_harness_net():
    """The net is registered with its flag and refuses training and a
    missing -trainedNet, as the JAX NetSpec does."""
    spec = get_spec("mnist-cluttered/mnist-saliency")
    with pytest.raises(ValueError, match="requires -trainedNet"):
        spec.create_model(NetOpts(netType=spec.name, trainedNet=""))
    with pytest.raises(NotImplementedError, match="test-only"):
        spec.train_rule(1, NetOpts(netType=spec.name))
