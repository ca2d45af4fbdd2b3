"""Train and eval steps (counterpart of `mgtpu/train/step.py`).

The train step runs forward, loss and backward, averages the gradients
over ``iter_size`` micro-batches, and takes one SGD step. BatchNorm
running stats are updated in place by each micro-batch's forward, in
order, as the JAX step threads them through its scan. ``remat`` runs
each micro-batch's forward under ``torch.utils.checkpoint``, layer by
layer, which keeps only the layers' inputs and runs the whole forward
again in the backward (`rematerialized`);
``bucket_sgd`` picks the multi-tensor SGD update (the default) or the
loop over tensors. With a ``mesh`` of several ranks (data parallelism,
`mgtpu_torch.parallel`) each rank steps on its slice of the global
batch, BatchNorm sums over the group, and the gradients are averaged
over the ranks once a step; ``zero1`` shards the momentum (ZeRO-1).
With the mesh's second axis (-spatial, -tensor; `mgtpu_torch.parallel.axis`)
the forward runs on H-slabs or channel slices, the output and dense
targets are whole rows before the loss, and the gradients are first
reduced over the model group (`_reduce_model_axis`).

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
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from mgtpu_torch.nn import Dropout, batch_group, running_stats_held
from mgtpu_torch.parallel import axis
from mgtpu_torch.parallel.mesh import (all_gather_slices, all_reduce_mean, all_reduce_sum,
                                       mean_metrics, own_slice, reduce_scatter_mean, zero1_spec)
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


def _global_norm(tensors, group=None, sliced=()) -> torch.Tensor:
    """The L2 norm of all ``tensors``; those at the indices ``sliced`` are
    each rank's slices of a whole (ZeRO-1's over the data group, -tensor's
    over the model group), summed over ``group``."""
    sq = [t.float().square().sum() for t in tensors]
    if not sliced:
        return torch.sqrt(sum(sq))
    part = torch.stack([sq[i] for i in sliced]).sum()
    dist.all_reduce(part, group=group)
    return torch.sqrt(part + sum(q for i, q in enumerate(sq) if i not in sliced))


def model_inputs(mesh, x, y):
    """Under -spatial (inside `batch_group`): the images ``x`` (this rank's
    rows, `parallel.shard_batch`) marked as the H-slab of the whole
    height and put in the rule's layout, and dense targets (split like
    the images) gathered whole, as the loss runs on the output's whole
    rows (`model_output`). Else ``x`` and ``y`` as they are."""
    if axis.spatial() is None:
        return x, y
    n = mesh.n_model
    if x.dim() == 4:
        x = axis.canonical(axis.mark(x, x.shape[1] * n))
    if y.dim() >= 4:
        y = axis.whole_rows(y)
    return x, y


def model_output(out):
    """The model's output with whole rows (an H-slab's gathered)."""
    return axis.gather_h(out) if isinstance(out, torch.Tensor) else out


def _reduce_model_axis(mesh, params, grads) -> None:
    """The gradients over the model group, in place, before the data
    group's mean: under -spatial a parameter used on H-slabs
    (``mg_partial``) holds its rows' share and is summed, one used on
    whole tensors holds the whole gradient on every rank and is averaged
    (the same values, so the copies cannot drift apart); under -tensor a
    channel-sliced parameter's gradient is its slice's whole and stays,
    the others are averaged."""
    n = mesh.n_model
    idx = [i for i, p in enumerate(params) if not axis.sliced(p)]
    div = [1 if getattr(params[i], "mg_partial", False) and mesh.axis == "model" else n
           for i in idx]
    all_reduce_sum(mesh.model_group, [grads[i] for i in idx], div)


def _remat_contexts(dropouts, device, mesh=None):
    """The two contexts ``checkpoint`` runs a rematerialized forward in:
    the first forward, and the run again in the backward. The run again
    draws the masks the first forward drew (each Dropout's generator is
    set back to its state before the first forward, and after the run to
    its state after it: ``checkpoint``'s own ``preserve_rng_state`` knows
    only torch's default generators), and it leaves the BatchNorms'
    running stats alone: the first forward updated them; under -spatial
    the slab marks flow in it as in the first forward."""
    gens = [d._generator_on(device) for d in dropouts]
    before = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def again():
        after = [g.get_state() for g in gens]
        for g, s in zip(gens, before):
            g.set_state(s)
        try:
            with running_stats_held(), axis.tagging(mesh):
                yield
        finally:
            for g, s in zip(gens, after):
                g.set_state(s)

    return contextlib.nullcontext(), again()


def rematerialized(model, mesh=None):
    """``model``'s forward under ``torch.utils.checkpoint``, one segment
    for each top-level layer of its sequence (``model.seq.layers``; the
    whole model where it has none, as the U-Nets): a segment keeps only
    its input, and the backward runs each segment again, whole (no early
    stop), before its own backward, with the first forward's dropout
    masks and without a second update of the BatchNorms' running stats.
    Every forward kernel runs twice, as under JAX's ``jax.checkpoint`` of
    the whole loss; one checkpoint of the whole forward would rebuild
    every saved activation before the backward frees one, and held the
    plain step's peak memory on the card (`probe_remat_memory.py`)."""
    seq = getattr(model, "seq", None)
    segments = list(seq.layers) if seq is not None else [model]
    dropouts = [[m for m in seg.modules() if isinstance(m, Dropout)] for seg in segments]

    def forward(x):
        device = next(model.parameters()).device
        for seg, drops in zip(segments, dropouts):
            with set_checkpoint_early_stop(False):
                x = checkpoint(seg, x, use_reentrant=False,
                               context_fn=lambda drops=drops: _remat_contexts(drops, device,
                                                                              mesh))
        return x

    return forward


def make_train_step(model, loss_fn, net, iter_size: int = 1, momentum: float = 0.9,
                    remat: bool = False, bucket_sgd: bool = True, log_grad_norm: bool = False,
                    mesh=None, zero1: bool = False):
    """Returns train_step(opt_state, batch, lr, wd) -> metrics.

    batch = {"x": ..., "y": ...}; with iter_size > 1 the leading axis of
    each entry is (iter_size, batch, ...). The step updates the model's
    parameters, its BatchNorm running stats and ``opt_state`` in place,
    and returns a dict of 0-dim f32 tensors (no host sync): the net's
    train metrics, averaged over the micro-batches, and with
    ``log_grad_norm`` also ``gradnorm`` (global L2 of the averaged raw
    gradients, before the weight-decay term), ``pnorm`` (global L2 of
    the updated parameters) and ``maxupd`` (largest |parameter change|).

    ``remat`` (the JAX step's ``jax.checkpoint`` of the loss): each
    micro-batch's forward keeps only its layers' inputs, and the backward
    runs it again, layer by layer, to rebuild the activations it needs
    (`rematerialized`); less memory for one more forward. The values are the plain step's: the same masks,
    and the running stats updated once. ``bucket_sgd`` True updates all
    tensors with PyTorch's multi-tensor ops, False loops over them
    (`mgtpu_torch.train.optim.sgd_update`); the values are the same.

    ``mesh`` (a `mgtpu_torch.parallel.Mesh` of several ranks): ``batch``
    is this rank's slice of the global batch (`parallel.shard_batch`);
    BatchNorm takes its moments over the group (`nn.batch_group`); after
    the micro-batches the gradients are averaged over the ranks in one
    all-reduce, so every rank takes the same update, and the metrics are
    too, so every rank reports the global batch's. ``zero1`` (the JAX
    step's ZeRO-1): ``opt_state`` holds, for each parameter that
    `parallel.zero1_spec` shards, only this rank's trailing-dim slice of
    its momentum (`parallel.shard_opt_zero1`); the gradients are
    reduce-scattered, each rank updates its slice of those parameters
    (the others whole), and the parameters are all-gathered."""
    params = list(model.parameters())
    forward = rematerialized(model, mesh) if remat else model
    ranks = 1 if mesh is None else mesh.size
    sharded = [i for i, p in enumerate(params) if zero1 and zero1_spec(p, ranks)]
    whole = [i for i in range(len(params)) if i not in sharded]
    # the slices a global norm sums over a group: -tensor's, then ZeRO-1's
    tp_slices = ((mesh.model_group, [i for i, p in enumerate(params) if axis.sliced(p)])
                 if mesh is not None and mesh.n_model > 1 else (None, []))
    norm_slices = tp_slices if tp_slices[1] else (
        (mesh.group, sharded) if sharded else (None, []))

    def grads_and_metrics(x, y):
        with axis.tagging(mesh):
            x, y = model_inputs(mesh, x, y)
            out = model_output(forward(x))
        loss = loss_fn(out, y)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return grads, net.train_metrics(out.detach(), y, loss.detach())

    def zero1_update(opt_state, grads, lr, wd):
        """ZeRO-1: this rank's slices of the sharded parameters and the
        whole others through `sgd_update`'s arithmetic, then the slices
        all-gathered into the parameters."""
        mine = [own_slice(mesh, params[i].data) for i in sharded]
        idx = sharded + whole
        sgd_update(mine + [params[i] for i in whole], [grads[i] for i in idx],
                   {"m": [opt_state["m"][i] for i in idx]}, lr, wd, momentum, foreach=False)
        all_gather_slices(mesh, mine, [params[i].data for i in sharded])

    def train_step(opt_state, batch, lr, wd):
        model.train()
        with _cudnn_choice(), batch_group(mesh):
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
        if mesh is not None and mesh.group is not None:
            metrics = mean_metrics(mesh, metrics)
            if mesh.n_model > 1:
                _reduce_model_axis(mesh, params, grads)
            all_reduce_mean(mesh, [grads[i] for i in whole])
            for i, g in zip(sharded, reduce_scatter_mean(mesh, [grads[i] for i in sharded])):
                grads[i] = g
        if log_grad_norm:
            metrics["gradnorm"] = _global_norm(grads, *norm_slices)
            old = [p.detach().clone() for p in params]
        if sharded:
            zero1_update(opt_state, grads, lr, wd)
        else:
            sgd_update(params, grads, opt_state, lr, wd, momentum, foreach=bucket_sgd)
        if log_grad_norm:
            with torch.no_grad():
                metrics["pnorm"] = _global_norm(params, *tp_slices)
                maxupd = torch.stack([(p.float() - o.float()).abs().max()
                                      for p, o in zip(params, old)]).max()
                if tp_slices[1]:
                    dist.all_reduce(maxupd, dist.ReduceOp.MAX, group=mesh.model_group)
                metrics["maxupd"] = maxupd
        return metrics

    return train_step


def _forward_whole(model, mesh, x, y):
    """The model's eval forward on ``x`` under ``mesh``'s second axis:
    (output with whole rows, targets with whole rows)."""
    with batch_group(mesh), axis.tagging(mesh):
        x, y = model_inputs(mesh, x, y)
        return model_output(model(x)), y


def make_eval_step(model, loss_fn, net, mode: str = "test", mesh=None):
    """Returns eval_step(batch) -> (metrics, outputs): eval mode (BN
    running stats, no dropout), no gradients; the net's test metrics, or
    with ``mode`` "eval" its eval metrics. Under ``mesh``'s second axis
    the outputs have whole rows (they differ by data rank only)."""
    metrics_fn = net.test_metrics if mode == "test" else net.eval_metrics

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        out, y = _forward_whole(model, mesh, batch["x"], batch["y"])
        return metrics_fn(out, y, loss_fn(out, y)), out

    return eval_step


def make_tencrop_eval_step(model, loss_fn, net, mode: str = "test", mesh=None):
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
        out = _forward_whole(model, mesh, x.reshape(n * k, *x.shape[2:]), y)[0]
        out = out.float().reshape(n, k, -1)
        log_mean = torch.logsumexp(out, dim=1) - math.log(k)
        return metrics_fn(log_mean, y, loss_fn(log_mean, y)), log_mean

    return eval_step
