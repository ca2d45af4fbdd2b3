"""The cluttered-MNIST nets and PR-MG in training against the JAX
package, in f32 on the CPU: one SGD step of each net, narrowed by
patching its ``BLOCKS`` / ``BLOCKS4`` / ``STEM`` / ``CFG`` in both
packages alike, at a small image size where the net allows one (the
mnist nets at 16x16; prnmgseg's 7x7 classifier pool needs 224 px):
loss, new parameters, running stats and momentum against jitted
`mgtpu.train.step.make_train_step`, with dense {0, 1} targets for the
BCE nets and ``iter_size`` 2 for prnmg.mnist and prnmgseg."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgtpu.models.ilsvrc.prnmgseg as jprnmgseg
import mgtpu.models.mnist_cluttered.pnmg_mnist as jpnmg_mnist
import mgtpu.models.mnist_cluttered.prnmg_mnist as jprnmg_mnist
import mgtpu.models.mnist_cluttered.unet as junet
import mgtpu.models.mnist_cluttered.unmg as junmg
from mgtpu.models import get_net as jax_get_net
from mgtpu.train.step import make_train_step as jax_make_train_step
import mgtpu_torch.models.ilsvrc.prnmgseg as tprnmgseg
import mgtpu_torch.models.mnist_cluttered.pnmg_mnist as tpnmg_mnist
import mgtpu_torch.models.mnist_cluttered.prnmg_mnist as tprnmg_mnist
import mgtpu_torch.models.mnist_cluttered.unet as tunet
import mgtpu_torch.models.mnist_cluttered.unmg as tunmg
from chip_smoke import SEG_RECIPES
from mgtpu_torch.models import create_model, get_spec
from mgtpu_torch.train.step import make_train_step
from mgtpu_torch.utils.bridge import export_jax_tree, export_momentum, load_jax_tree, load_momentum
from test_torch_cifar_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_cifar_train import _assert_tree_close, _jitter
from test_torch_seg_models import jax_opt

# net -> (JAX module, port module, {attribute: narrowed value}, image, micro-batch, iter_size)
NARROW = {
    "mnist-cluttered/unet": (junet, tunet, {"BLOCKS": [6, 8, 10, 12]}, (16, 16, 1), 8, 1),
    "mnist-cluttered/unmg": (junmg, tunmg, {"BLOCKS": [([6, 5, 4], False), ([8, 6, 5], True),
                                                       ([8, 6], True), ([10], None)]},
                             (16, 16, 1), 8, 1),
    # the output blocks' literal widths (64, 32, 16) stay
    "mnist-cluttered/pnmg.mnist": (jpnmg_mnist, tpnmg_mnist, {"BLOCKS4": [8, 6, 5, 4]},
                                   (16, 16, 1), 8, 1),
    "mnist-cluttered/prnmg.mnist": (jprnmg_mnist, tprnmg_mnist, {"BLOCKS4": [8, 6, 5, 4]},
                                    (16, 16, 1), 4, 2),
    "ilsvrc/prnmgseg": (jprnmgseg, tprnmgseg, {
        "STEM": [8, 6, 5, 4], "CFG": {30: [1, 1, 1, 1]},
        "BLOCKS": [([8, 6, 5, 4], [3] * 4), ([8, 8, 8, 10], [3] * 4), ([8, 8, 10, 12], [3] * 4),
                   ([8, 10, 12, 14], [3] * 4)]}, (224, 224, 3), 2, 2),
}


@pytest.mark.parametrize("net", sorted(NARROW))
def test_narrow_train_step_matches_jax(net, monkeypatch):
    """One SGD step at lr 0.1 with the net's weight decay from the port's
    narrowed init (BN and conv weights as test_torch_cifar_train.py
    jitters them) and random momentum."""
    jmod, tmod, patch, image, micro, iters = NARROW[net]
    for name, value in patch.items():
        monkeypatch.setattr(jmod, name, value)
        monkeypatch.setattr(tmod, name, value)
    opt = SEG_RECIPES[net][0]
    spec, jnet = get_spec(net), jax_get_net(net)
    model = create_model(opt, generator=torch.Generator().manual_seed(0))
    p, s = export_jax_tree(model)
    rng = np.random.default_rng(1)
    _jitter(p, s, rng)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, p)
    x = rng.standard_normal((iters, micro, *image), dtype=np.float32)
    target = spec.target_shape(opt)
    if target:  # the output's shape at this image size
        target = (*image[:2], target[-1])
        y = (rng.random((iters, micro, *target)) > 0.5).astype(np.float32)
    else:
        y = rng.integers(0, spec.n_classes(opt), (iters, micro))
    if iters == 1:
        x, y = x[0], y[0]
    lr, wd = 0.1, spec.train_rule(1, opt)["wd"]
    jm = jnet.create_model(jax_opt(opt))
    step = jax.jit(jax_make_train_step(jm, jnet.create_loss(None), jnet, iter_size=iters))
    ref_p, ref_s, ref_o, ref_m = jax.tree.map(np.asarray, step(
        p, s, {"m": m}, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, lr, wd,
        jax.random.PRNGKey(0)))

    model = load_jax_tree(model, p, s)
    opt_state = load_momentum(model, {"m": m})
    metrics = make_train_step(model, spec.create_loss(opt), spec, iter_size=iters)(
        opt_state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, lr, wd)
    assert sorted(metrics) == sorted(ref_m)
    for k, v in ref_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    got_p, got_s = export_jax_tree(model)
    _assert_tree_close(got_p, ref_p, rtol=1e-4, atol=1e-5)
    _assert_tree_close(got_s, ref_s, rtol=1e-4, atol=1e-5)
    _assert_tree_close(export_momentum(model, opt_state), ref_o, rtol=1e-4, atol=1e-5)
