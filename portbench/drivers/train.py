"""Training traffic: `mgtpu_torch.trainer.Trainer.step` back to back on
resident batches, the loss read one step late (as the run loop's lagged
metric sync does).

Set-up builds one Trainer from the benchmark's weights (an mgtpu-ckpt)
and drives it through its first ``compare_steps`` steps on distinct
batches; those steps warm up every shape and are the ones the reference
follows: each step's loss, the norm of each leaf's first gradient as the
optimizer got it (its momentum after one step, less the weight decay),
each leaf's change and each running stat's change after the last of
them. The same Trainer then runs the window.

Traffic keys: batch, resident (batches on the card, cycled), lr, wd,
compare_steps."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.common import inputs
from portbench.common.harness import exact_f32, norm_gap
from portbench.reference import mgnet

DTYPES = {"bf16": torch.bfloat16, "tf32": torch.float32, "f32": torch.float32}
# the control: the reference one precision below the configuration's
# (f32 with TF32 allowed, as cuDNN runs the program's f32 convs: bf16)
CONTROL = {"bf16": "fp8", "tf32": "bf16"}


def _norms(tree, minus=None, scale=1.0):
    """{leaf path: L2 norm} of tree (- scale * minus), in f64."""
    out = {}
    for path, v in mgnet.leaves(tree):
        a = np.asarray(v, np.float64)
        if minus is not None:
            a = a - scale * np.asarray(mgnet.get(minus, path), np.float64)
        out[path] = float(np.sqrt(np.sum(a * a)))
    return out


def reference_steps(net, p0, s0, xs, ys, lr, wd, n, device, quant=None, rows=None):
    """The reference's first ``n`` SGD steps (momentum 0.9, coupled weight
    decay) from (p0, s0), in f32: (losses, first-gradient norms, change
    norms, running-stat change norms)."""
    params, stats = inputs.device(p0, device, grad=True), inputs.device(s0, device)
    leaves = mgnet.leaves(params)
    moms = [torch.zeros_like(t) for _, t in leaves]
    losses, first = [], None
    with exact_f32():
        for i in range(n):
            x, y = (xs[i], ys[i]) if rows is None else (xs[i][:rows], ys[i][:rows])
            out = mgnet.forward(net, params, stats, x, "train", quant)
            loss = -out.gather(1, y[:, None]).mean()
            grads = torch.autograd.grad(loss, [t for _, t in leaves])
            with torch.no_grad():
                if first is None:
                    first = {p: float(g.double().norm()) for (p, _), g in zip(leaves, grads)}
                for (_, p), g, m in zip(leaves, grads, moms):
                    m.mul_(0.9).add_(g + wd * p)
                    p.sub_(lr * m)
            losses.append(float(loss.detach()))
            del out, loss, grads
    change = _norms(inputs.host(params), p0)
    dstats = _norms(inputs.host(stats), s0)
    return losses, first, change, dstats


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _numbers(prog, ref):
    """(compared, worst): the program's (or a stand-in's) readings against
    the reference's. Leaves whose reference gradient is under a thousandth
    of the median leaf's (biases in front of a BatchNorm: no gradient but
    round-off) are left out of the gradient and the change. Compared: the
    widest step's loss gap, and for the first gradient, the change and the
    running stats the median leaf's gap of norms (over max(its norm, the
    median leaf's)); the first step's loss gap alone (its forward, before
    any update the steps could amplify); the worst leaf's gaps are
    reported beside them."""
    pl, pg, pc, ps = prog
    rl, rg, rc, rs = ref
    keep = [k for k, v in rg.items() if v >= 1e-3 * _median(rg.values())]

    def gaps(p, r, names):
        med = _median(r.values())
        return [abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in names]

    compared = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(pl, rl)),
                "loss1_gap": abs(pl[0] - rl[0]) / abs(rl[0]),
                "grad_gap_median": _median(gaps(pg, rg, keep)),
                "change_gap_median": _median(gaps(pc, rc, keep)),
                "stats_gap_median": _median(gaps(ps, rs, list(rs)))}
    worst = {"grad_gap_worst": norm_gap(pg, rg, keep), "change_gap_worst": norm_gap(pc, rc, keep),
             "stats_gap_worst": norm_gap(ps, rs)}
    return compared, worst


def run(h):
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.trainer import Trainer
    from mgtpu_torch.utils.bridge import export_jax_tree, export_momentum

    h.mark("imported")
    cfg, tr = h.config, h.traffic
    net = mgnet.build(cfg)
    shape = tuple(cfg["image_shape"])
    B, R, n_cmp = tr["batch"], tr["resident"], tr["compare_steps"]
    lr, wd = tr["lr"], tr["wd"]
    params, stats = inputs.weights(h, net)
    g = h.generator(1)
    xs = torch.randn((R, B, *shape), generator=g, device=h.device)
    ys = torch.randint(0, cfg["classes"], (R, B), generator=g, device=h.device)
    p0, s0 = inputs.host(params), inputs.host(stats)
    h.mark("inputs")
    with inputs.checkpoint(h, params, stats, cfg["opts"]) as path:
        trainer = Trainer(NetOpts(**cfg["opts"]), ckpt=path, device=h.device,
                          compute_dtype=DTYPES[cfg["dtype"]])
    del params, stats
    step = trainer.step
    h.mark("built")

    # the first steps: every shape warmed up, and what the reference follows
    prog_losses, first = [], None
    for i in range(n_cmp):
        m = step(xs[i], ys[i], lr, wd)
        prog_losses.append(m["loss"])
        if i == 0:
            with h.checking():
                mom = export_momentum(trainer.model, trainer.opt_state)["m"]
                first = _norms(mom, p0, wd)
    with h.checking():
        p3, s3 = export_jax_tree(trainer.model)
        prog = ([float(x) for x in prog_losses], first, _norms(p3, p0), _norms(s3, s0))
        del p3, s3, mom
    h.setup_done()

    i, steps, failed, prev = n_cmp, 0, 0, None
    start, over = h.window()
    while not over():
        with h.span("dispatch"):
            m = step(xs[i % R], ys[i % R], lr, wd)
        if prev is not None:
            with h.span("readback"):
                failed += not np.isfinite(float(prev["loss"]))
        prev, i, steps = m, i + 1, steps + 1
    with h.span("readback"):
        failed += not np.isfinite(float(prev["loss"]))
    wall = time.perf_counter() - start
    rate = steps * B / wall

    def body(warm):
        nonlocal i
        last = None
        for _ in range(1 if warm else 2):
            with h.span("dispatch"):
                m = step(xs[i % R], ys[i % R], lr, wd)
            if last is not None:
                with h.span("readback"):
                    float(last["loss"])
            last, i = m, i + 1
        with h.span("readback"):
            float(last["loss"])
        return 2

    dispatch = list(h.spans["dispatch"])
    h.profiled(body)
    peak = torch.cuda.max_memory_allocated(h.device) if h.device.type == "cuda" else 0
    h.info(window_steps=steps, window_s=wall, images=steps * B)
    del trainer, step, m, prev
    h.free()

    ref = reference_steps(net, p0, s0, xs, ys, lr, wd, n_cmp, h.device)
    compared, worst = _numbers(prog, ref)
    h.info(worst_leaves=worst)
    for name, value in compared.items():
        h.compare(name, value)
    if h.readings:  # the control and the fault of half a batch left out
        ctrl = _numbers(reference_steps(net, p0, s0, xs, ys, lr, wd, n_cmp, h.device,
                                        quant=mgnet.Quant(CONTROL[cfg["dtype"]])), ref)
        half = reference_steps(net, p0, s0, xs, ys, lr, wd, n_cmp, h.device, rows=B // 2)
        h.extra = {"worst": {k: v[0] for k, v in worst.items()},
                   "control": {**ctrl[0], **{k: v[0] for k, v in ctrl[1].items()}},
                   "half_batch": _numbers(half, ref)[0]}
    return {"attempted": steps, "failed": failed, "peak": peak, "dispatch": dispatch,
            "metrics": {"train_img_s": (rate, "img/s")}, "rate": rate,
            "work": {"kind": "train", "batch": B}}
