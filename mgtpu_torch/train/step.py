"""Train and eval steps (counterpart of `mgtpu/train/step.py`).

The train step runs forward, loss and backward, averages the gradients
over ``iter_size`` micro-batches, and takes one SGD step. BatchNorm
running stats are updated in place by each micro-batch's forward, in
order, as the JAX step threads them through its scan. The JAX step's
``remat``, ``zero1`` and ``bucket_sgd`` options are not ported.
"""

from __future__ import annotations

import torch

from mgtpu_torch.train.optim import sgd_update


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


def make_eval_step(model, loss_fn, net):
    """Returns eval_step(batch) -> (metrics, outputs): eval mode (BN
    running stats, no dropout), no gradients."""

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        out = model(batch["x"])
        return net.test_metrics(out, batch["y"], loss_fn(out, batch["y"])), out

    return eval_step
