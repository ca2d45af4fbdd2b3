"""Time the SGD update (momentum 0.9, coupled weight decay) on the card
at R-MG-34's parameters (302 leaves, 32.9 M f32 values; the JAX tool's
help says 299, its tree has 302 too) in the port's forms: the port's
counterpart of `tools/bench_sgd.py`.

  per-leaf  `mgtpu_torch.train.optim.sgd_update(foreach=False)`: one
            update a leaf, a few elementwise kernels each
  foreach   `sgd_update(foreach=True)`, the train step's ``bucket_sgd``
            path: PyTorch's multi-tensor kernels over all leaves
  flat      the same arithmetic on one flat vector each for the
            parameters, gradients and momentum (the layout a flat
            parameter buffer would give; the concatenation is not timed)

Each form's time is the best of 3 windows of 30 updates; its first
update from the same state is held to the per-leaf form's. The floor is
the bytes the update must move, read p, g, m and write p, m (5 x 4
bytes a parameter), over the card's memory rate (the published peak of
its part, looked up by the card's full name in ``HBM_RATE``; printed as
not known for a card not listed there).

Usage: python -m mgtpu_torch.tools.bench_sgd [-device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from mgtpu_torch.tools import card, sync

# published memory rates (bytes/s) by the card's full name, as
# torch.cuda.get_device_name gives it: the H100's three parts differ
HBM_RATE = {"NVIDIA H100 80GB HBM3": 3.35e12,  # SXM5
            "NVIDIA H100 PCIe": 2.0e12,
            "NVIDIA H100 NVL": 3.9e12}
LR, WD, MU = 0.1, 1e-4, 0.9


def flat_update(p, g, m):
    """`sgd_update`'s arithmetic on flat vectors, in place."""
    g.add_(p, alpha=WD)
    m.mul_(MU).add_(g)
    p.add_(m, alpha=-LR)


def forms(params):
    """{form: (state, update)}: each form's own copy of the parameters,
    gradients (1e-4 everywhere; the update adds the decay term into
    them, as the step's own gradients take it) and zero momentum, and a
    call that updates it once in place."""
    from mgtpu_torch.train.optim import sgd_update

    def leaves():
        p = [t.detach().clone() for t in params]
        return p, [torch.full_like(t, 1e-4) for t in p], [torch.zeros_like(t) for t in p]

    out = {}
    for name, each in (("per-leaf", False), ("foreach", True)):
        p, g, m = leaves()
        out[name] = ((p, g, m), lambda p=p, g=g, m=m, each=each: sgd_update(
            p, g, {"m": m}, LR, WD, MU, foreach=each))
    flat = torch.cat([t.detach().reshape(-1) for t in params])
    fp, fg, fm = flat.clone(), torch.full_like(flat, 1e-4), torch.zeros_like(flat)
    out["flat"] = (([fp], [fg], [fm]), lambda: flat_update(fp, fg, fm))
    return out


def time_update(update, device, iters=30, warmup=5) -> float:
    for _ in range(warmup):
        update()
    sync(device)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            update()
        sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def one_step_error(params) -> dict:
    """{form: the largest |parameter| difference from the per-leaf form
    after one update from the same state}."""
    fs = forms(params)
    for _, update in fs.values():
        update()
    ref = torch.cat([t.reshape(-1) for t in fs["per-leaf"][0][0]])
    return {name: float((torch.cat([t.reshape(-1) for t in state[0]]) - ref).abs().max())
            for name, (state, _) in fs.items() if name != "per-leaf"}


def floor_text(traffic: int, device: str) -> str:
    """The update's floor: ``traffic`` bytes over the memory rate of the
    card named ``device``, or that the rate is not known for it."""
    rate = HBM_RATE.get(device)
    if rate is None:
        return f"not known for this device ({device}: no published memory rate listed)"
    return f"{traffic / rate * 1e3:.3f} ms at {rate / 1e12:.2f} TB/s"


def main(argv=None):
    from mgtpu_torch.models import create_model
    from mgtpu_torch.models.base import NetOpts

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    params = list(create_model(NetOpts(depth=34), device=device).parameters())
    n_par = sum(p.numel() for p in params)
    traffic = 5 * 4 * n_par
    where = card(device)
    floor = floor_text(traffic, where["device"])
    print(f"leaves={len(params)} params={n_par / 1e6:.2f}M traffic={traffic / 1e6:.0f}MB/step; "
          f"floor {floor}; on {where['device']} (power limit {where['power_limit']})")
    errors = one_step_error(params)
    times = {name: time_update(update, device) for name, (_, update) in forms(params).items()}
    for name, t in times.items():
        err = f"   max|dp|={errors[name]:.2e}" if name in errors else "   (the reference)"
        print(f"{name:>14}: {t * 1e3:8.3f} ms{err}")
    best = min(times, key=times.get)
    print(f"best: {best}  ({times[best] * 1e3:.3f} ms vs per-leaf {times['per-leaf'] * 1e3:.3f} ms)")


if __name__ == "__main__":
    main()
