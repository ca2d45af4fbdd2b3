"""Train and eval steps (counterpart of `mgtpu/train/step.py`).

The train step runs forward, loss and backward, averages the gradients
over ``iter_size`` micro-batches, and takes one SGD step. BatchNorm
running stats are updated in place by each micro-batch's forward, in
order, as the JAX step threads them through its scan. The JAX step's
``remat``, ``zero1`` and ``bucket_sgd`` options are not ported.

The step asks cuDNN (the stock convs and every conv's backward) for its
deterministic algorithms while ``DETERMINISTIC_CUDNN`` is True, so that
a step on the card is the same bit for bit every time it runs. With
cuDNN's default choice the rounding changes from call to call, and a
pre-activation that lies on a ReLU's edge lands on either side: in the
f32 ``cifar/nmg`` step that ``chip_smoke.py`` holds to the CPU, one
lies 5.9e-6 of its tensor's largest value from 0, and in 2 of 40 steps
on an H100 it crossed, moving the whole update by 2.84%, as flipping its
sign on the CPU does (``probe_cifar_step.py --replay``, ``--edge``).
"""

from __future__ import annotations

import contextlib
import math

import torch

from mgtpu_torch.train.optim import sgd_update


DETERMINISTIC_CUDNN = True


@contextlib.contextmanager
def _cudnn_choice():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = DETERMINISTIC_CUDNN
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_train_step(model, loss_fn, net, iter_size: int = 1, momentum: float = 0.9,
                    log_grad_norm: bool = False):
    """Returns train_step(opt_state, batch, lr, wd) -> metrics.

    batch = {"x": ..., "y": ...}; with iter_size > 1 the leading axis of
    each entry is (iter_size, batch, ...). The step updates the model's
    parameters, its BatchNorm running stats and ``opt_state`` in place,
    and returns a dict of 0-dim f32 tensors (no host sync): the net's
    train metrics, averaged over the micro-batches, and with
    ``log_grad_norm`` also ``gradnorm`` (global L2 of the averaged raw
    gradients, before the weight-decay term), ``pnorm`` (global L2 of
    the updated parameters) and ``maxupd`` (largest |parameter change|)."""
    params = list(model.parameters())

    def grads_and_metrics(x, y):
        out = model(x)
        loss = loss_fn(out, y)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return grads, net.train_metrics(out.detach(), y, loss.detach())

    def train_step(opt_state, batch, lr, wd):
        model.train()
        with _cudnn_choice():
            if iter_size == 1:
                grads, metrics = grads_and_metrics(batch["x"], batch["y"])
            else:
                grads, ms = None, []
                for k in range(iter_size):
                    g, m = grads_and_metrics(batch["x"][k], batch["y"][k])
                    grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                    ms.append(m)
                grads = [g / iter_size for g in grads]
                metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        if log_grad_norm:
            metrics["gradnorm"] = _global_norm(grads)
            old = [p.detach().clone() for p in params]
        sgd_update(params, grads, opt_state, lr, wd, momentum)
        if log_grad_norm:
            with torch.no_grad():
                metrics["pnorm"] = _global_norm(params)
                metrics["maxupd"] = torch.stack([(p.float() - o.float()).abs().max()
                                                 for p, o in zip(params, old)]).max()
        return metrics

    return train_step


def make_eval_step(model, loss_fn, net, mode: str = "test"):
    """Returns eval_step(batch) -> (metrics, outputs): eval mode (BN
    running stats, no dropout), no gradients; the net's test metrics, or
    with ``mode`` "eval" its eval metrics."""
    metrics_fn = net.test_metrics if mode == "test" else net.eval_metrics

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        out = model(batch["x"])
        return metrics_fn(out, batch["y"], loss_fn(out, batch["y"])), out

    return eval_step


def make_tencrop_eval_step(model, loss_fn, net, mode: str = "test"):
    """10-crop evaluation: batch x is (N, 10, H, W, C); one forward of all
    N * 10 crops, the class probabilities averaged over the crops, and
    the loss and metrics on the log of that mean, in f32 (logsumexp over
    the crops - log 10: exp() alone underflows for confident log-probs).
    Returns eval_step(batch) -> (metrics, log-mean outputs (N, classes))."""
    metrics_fn = net.test_metrics if mode == "test" else net.eval_metrics

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        x, y = batch["x"], batch["y"]
        n, k = x.shape[0], x.shape[1]
        out = model(x.reshape(n * k, *x.shape[2:])).float().reshape(n, k, -1)
        log_mean = torch.logsumexp(out, dim=1) - math.log(k)
        return metrics_fn(log_mean, y, loss_fn(log_mean, y)), log_mean

    return eval_step
