"""Is one f32 training step of a CIFAR net as sensitive to rounding-sized
input changes in the JAX package as in the port? On the CPU, from the
init `chip_smoke.py` holds the card's f32 step to (phase 14: the port's
seed 0, carried into the JAX package by the bridge), one SGD step at lr
0.1 on 2 micro-batches of 8 images, four times: `mgtpu.train.step`
(jitted) on the images and on the images moved by one part in 1e6, and
the port's step on both. Each package's own change of the whole update
under the moved images is counted as `chip_smoke.step_error` counts it.

The test holds cifar/vgg, whose port step moves by ~2% (phase 14's
bound is three times that): the JAX step moves by as much, so the
sensitivity is the net's. Run as a script, it prints one JSON line per
net:

    JAX_PLATFORMS=cpu python3 tests/test_torch_step_sensitivity.py [cifar/vgg cifar/pnmg ...]
"""

import json
import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import CIFAR_IMAGE, CIFAR_RECIPES, cifar_opts, step_error  # noqa: E402
from mgtpu.models import get_net as jax_get_net  # noqa: E402
from mgtpu.train.optim import sgd_init as jax_sgd_init  # noqa: E402
from mgtpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from mgtpu_torch.trainer import Trainer, synthetic_batch  # noqa: E402
from mgtpu_torch.utils.bridge import export_jax_tree  # noqa: E402

LR, WD, MICRO = 0.1, 5e-4, 8


def _port_step(net, x, y):
    tr = Trainer(cifar_opts(net), seed=0, device="cpu", compute_dtype=torch.float32,
                 iter_size=2)
    before, stats = export_jax_tree(tr.model)
    loss = float(tr.step(x, y, LR, WD)["loss"])
    return (loss, before, *export_jax_tree(tr.model)), stats


def _jax_step(step, params, stats, x, y):
    batch = {"x": jnp.asarray(x.reshape(2, MICRO, *x.shape[1:])),
             "y": jnp.asarray(y.reshape(2, MICRO))}
    p, s, _, m = step(params, stats, jax_sgd_init(params), batch, LR, WD,
                      jax.random.PRNGKey(0))
    return (float(m["loss"]), params, *jax.tree.map(np.asarray, (p, s)))


def sensitivity(net) -> dict:
    """{"jax_moved_vs_jax", "port_moved_vs_port", "port_vs_jax"}: each a
    (loss, update, stats) triple of relative errors."""
    x, y = synthetic_batch(2 * MICRO, seed=2, n_classes=100, shape=CIFAR_IMAGE)
    moved = x * (1 + 1e-6 * np.random.default_rng(3).standard_normal(x.shape, dtype=np.float32))
    port, stats = _port_step(net, x, y)
    port_moved, _ = _port_step(net, moved, y)
    jnet = jax_get_net(net)
    jm = jnet.create_model(types.SimpleNamespace(dataset="cifar100", isDropout=False,
                                                 nLayer=CIFAR_RECIPES[net][0]))
    step = jax.jit(jax_make_train_step(jm, jnet.create_loss(None), jnet, iter_size=2))
    ref = _jax_step(step, port[1], stats, x, y)
    ref_moved = _jax_step(step, port[1], stats, moved, y)
    return {"jax_moved_vs_jax": step_error({"cuda": ref_moved, "cpu": ref}),
            "port_moved_vs_port": step_error({"cuda": port_moved, "cpu": port}),
            "port_vs_jax": step_error({"cuda": port, "cpu": ref})}


def test_vgg_step_sensitivity_is_the_nets():
    """The JAX step moves by over 0.5% of its update under the moved
    images (a well-conditioned step moves by ~1e-5), within a factor of
    three of the port's own change, and the two packages' steps agree
    within that sensitivity."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        res = sensitivity("cifar/vgg")
    finally:
        torch.set_num_threads(n)
    jax_own, port_own = res["jax_moved_vs_jax"][1], res["port_moved_vs_port"][1]
    assert jax_own > 5e-3
    assert port_own / 3 < jax_own < 3 * port_own
    assert res["port_vs_jax"][1] < 3 * max(jax_own, port_own)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    for name in sys.argv[1:] or ["cifar/vgg", "cifar/pnmg", "cifar/prnmg"]:
        t0 = time.perf_counter()
        out = sensitivity(name)
        print(json.dumps({"net": name, "batch": f"{MICRO} x 2", "device": "cpu", **{
            k: dict(zip(("loss", "update", "stats"), v)) for k, v in out.items()},
            "seconds": time.perf_counter() - t0}), flush=True)
