"""Differential train-step cost breakdown for R-MG-34 on the card, the
port's counterpart of `tools/bench_step_breakdown.py`: times (1) the
eval-mode forward, (2) the train-mode forward (adds BN batch moments
and the running-stat update), (3) forward + backward (the gradients of
the loss), (4) the full step of `mgtpu_torch.trainer.Trainer` (forward,
backward and the SGD update), all bf16 on one fixed synthetic batch.
The deltas attribute the train step's cost beyond the inference
forward.

Usage: python -m mgtpu_torch.tools.bench_step_breakdown [batch] [-device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from mgtpu_torch.tools import card, sync


def timeit(fn, device, iters=20, warmup=3) -> float:
    """Seconds a call of ``fn``, over ``iters`` back-to-back calls after
    ``warmup``, synced at both ends."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters


def breakdown(batch: int, device, iters=20) -> dict:
    """{"eval", "train", "grad", "step"}: seconds a call of each pass."""
    from mgtpu_torch.models.base import NetOpts, imagenet_rule
    from mgtpu_torch.trainer import Trainer, synthetic_batch

    tr = Trainer(NetOpts(depth=34), seed=0, device=device)
    model, loss_fn = tr.model, tr.net.create_loss(tr.opt)
    params = list(model.parameters())
    xs, ys = synthetic_batch(batch, seed=1)
    x = torch.as_tensor(xs).to(device, torch.bfloat16)
    y = torch.as_tensor(ys).to(device)
    rule = imagenet_rule(1)

    @torch.no_grad()
    def fwd_eval():
        model.eval()
        return model(x).float().sum()

    @torch.no_grad()
    def fwd_train():
        model.train()
        return model(x).float().sum()

    def fwd_bwd():
        model.train()
        return torch.autograd.grad(loss_fn(model(x), y), params, allow_unused=True)

    times = {"eval": timeit(fwd_eval, device, iters), "train": timeit(fwd_train, device, iters),
             "grad": timeit(fwd_bwd, device, iters)}
    times["step"] = timeit(lambda: tr.step(x, y, rule["lr"], rule["wd"]), device, iters)
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("-device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    batch = args.batch
    t = breakdown(batch, device)
    t_eval, t_train, t_grad, t_step = t["eval"], t["train"], t["grad"], t["step"]

    def us(s):
        return s / batch * 1e6

    where = card(device)
    print(f"batch {batch} on {where['device']} (power limit {where['power_limit']})")
    print(f"fwd eval          : {t_eval*1e3:8.2f} ms  {us(t_eval):7.1f} us/img  {batch/t_eval:8.0f} img/s")
    print(f"fwd train (BN/mom): {t_train*1e3:8.2f} ms  {us(t_train):7.1f} us/img  (+{us(t_train-t_eval):.1f})")
    print(f"fwd+bwd           : {t_grad*1e3:8.2f} ms  {us(t_grad):7.1f} us/img  (+{us(t_grad-t_train):.1f} bwd)")
    print(f"full step (+sgd)  : {t_step*1e3:8.2f} ms  {us(t_step):7.1f} us/img  (+{us(t_step-t_grad):.1f} sgd)  {batch/t_step:8.0f} img/s")
    print(f"bwd/fwd ratio     : {(t_grad-t_train)/t_eval:.2f}x (ideal ~2x)")


if __name__ == "__main__":
    main()
