"""How far apart may one f32 training step of a CIFAR net on the card and
the same step on the CPU be, and where does the difference sit?

For each net named (default: cifar/vgg, cifar/prnmg, cifar/pnmg) and each
micro-batch (default 8, 16 and 32, two micro-batches a step), take one
f32 SGD step at lr 0.1 from the init `chip_smoke.py` uses (phase 14)
three times: on the card, on the CPU's plain path, and on the CPU with
the images moved by one part in 1e6. Print one JSON line each: the
card's error against the CPU step (loss, the whole update relative to
its L2 norm, the running stats), the CPU's own change under the moved
images (the step's sensitivity to rounding-sized input changes), and
the parameters that hold most of the card's update error, with the
card's error and the moved images' change of each, relative to its
update.

With ``--repeat N``, N more card steps follow, with cuDNN's default
and its deterministic algorithms in turns (the train step's
``DETERMINISTIC_CUDNN``), and one more JSON line gives each one's
update error against the same CPU step. ``--warm`` first serves the six
CIFAR nets and takes their bf16 steps, as `chip_smoke.py` phases 13 and
14 do, so that the card steps run in the state those phases leave.

With ``--replay N``, N card steps with cuDNN's default choice follow,
each recording every call of the stock conv and its backward (the
inputs and outputs of ``aten.convolution`` and
``aten.convolution_backward``, the backward on the calling thread), and
each is held call by call to one step with the deterministic
algorithms. A step whose update is more than 1e-3 off the CPU step
prints the first calls whose outputs are more than 1e-3 off (relative
to their largest value), with their inputs' error, and the first such
call run again on its recorded inputs, five times with each choice.

With ``--edge N`` (the CPU alone), the N BatchNorm outputs of the CPU
step nearest 0, a ReLU's edge (relative to their tensor's largest
value), and for each one the step's change when its sign is flipped.

    python3 probe_cifar_step.py [--nets cifar/vgg] [--micro 8 16 32]
    python3 probe_cifar_step.py --nets cifar/nmg --micro 8 --repeat 24 --warm
    python3 probe_cifar_step.py --nets cifar/nmg --micro 8 --replay 40 --warm
    python3 probe_cifar_step.py --nets cifar/nmg --micro 8 --edge 5 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from chip_smoke import CIFAR_IMAGE, CIFAR_RECIPES, cifar_opts, step_error
from mgtpu_torch.nn import BatchNorm
from mgtpu_torch.train import step as train_step
from mgtpu_torch.trainer import Trainer, synthetic_batch
from mgtpu_torch.utils.bridge import export_jax_tree


class ConvCalls(TorchDispatchMode):
    """Records (op, args, outputs) of every stock conv call, tensors
    cloned."""

    OPS = (torch.ops.aten.convolution.default, torch.ops.aten.convolution_backward.default)

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.OPS:
            keep = lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
            self.calls.append((func, [keep(a) for a in args], [keep(o) for o in _outs(out)]))
        return out


def _outs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _rel(a, b) -> float:
    if not isinstance(a, torch.Tensor) or a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def _step(net, dev, x, y, deterministic=True, recorder=None, hook=None):
    """(loss, params before, params after, stats after) of one f32 step,
    and {parameter name: its update} for the error's breakdown. ``hook``
    is called with the model before the step."""
    train_step.DETERMINISTIC_CUDNN = deterministic
    tr = Trainer(cifar_opts(net), seed=0, device=dev, compute_dtype=torch.float32, iter_size=2)
    if hook is not None:
        hook(tr.model)
    before, _ = export_jax_tree(tr.model)
    named = {k: p.detach().cpu().clone() for k, p in tr.model.named_parameters()}
    with contextlib.ExitStack() as stack:
        if recorder is not None:
            stack.enter_context(torch.autograd.set_multithreading_enabled(False))
            stack.enter_context(recorder)
        loss = float(tr.step(x, y, 0.1, 5e-4)["loss"])
    train_step.DETERMINISTIC_CUDNN = True
    upd = {k: p.detach().cpu() - named[k] for k, p in tr.model.named_parameters()}
    return (loss, before, *export_jax_tree(tr.model)), upd


def replay(net, micro, x, y, cpu, n) -> None:
    """--replay: n default-choice card steps held call by call to a
    deterministic one."""
    ref = ConvCalls()
    _step(net, "cuda", x, y, True, ref)
    errs, found = [], []
    for i in range(n):
        rec = ConvCalls()
        err = step_error({"cuda": _step(net, "cuda", x, y, False, rec)[0], "cpu": cpu})[1]
        errs.append(err)
        if [c[0] for c in rec.calls] != [c[0] for c in ref.calls]:
            raise SystemExit("the recorded conv calls differ from the reference step's")
        if err <= 1e-3:
            continue
        bad = []
        for k, ((func, args, outs), (_, rargs, routs)) in enumerate(zip(rec.calls, ref.calls)):
            out_err = max(_rel(o, r) for o, r in zip(outs, routs))
            if out_err > 1e-3:
                bad.append({"call": k, "op": func.__name__, "out_err": [
                    _rel(o, r) for o, r in zip(outs, routs)], "in_err": [
                    _rel(a, r) for a, r in zip(args, rargs)], "shapes": [
                    list(a.shape) for a in args if isinstance(a, torch.Tensor)],
                    "args": [a for a in args if not isinstance(a, torch.Tensor)]})
        again = {}
        if bad:
            func, args, outs = rec.calls[bad[0]["call"]]
            routs = ref.calls[bad[0]["call"]][2]
            for mode in (False, True):
                torch.backends.cudnn.deterministic = mode
                again["deterministic" if mode else "default"] = [
                    [_rel(o, r) for o, r in zip(_outs(func(*args)), routs)] for _ in range(5)]
            torch.backends.cudnn.deterministic = False
        found.append({"step": i, "update_err": err, "calls": len(rec.calls),
                      "bad_calls": bad[:3], "n_bad_calls": len(bad), "run_again": again})
    print(json.dumps({"net": net, "batch": f"{micro} x 2", "replay_update_err": errs,
                      "over_1e-3": sum(e > 1e-3 for e in errs), "glitches": found},
                     default=str), flush=True)


def edge(net, micro, x, y, cpu, n) -> None:
    """--edge: the n BatchNorm outputs of the CPU step nearest 0 (a
    ReLU's edge), relative to their tensor's largest, and how far the
    step moves when each one's sign is flipped."""
    near, calls = [], {}

    def find(name):
        def hook(module, inp, out):
            a = out.detach().abs().flatten()
            k = int(a.argmin())
            near.append((float(a[k] / a.max()), name, calls.setdefault(name, 0), k,
                         float(out.detach().flatten()[k])))
            calls[name] += 1
        return hook

    def watch(model):
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                m.register_forward_hook(find(name))

    _step(net, "cpu", x, y, hook=watch)
    rows = []
    for rel, name, call, k, value in sorted(near)[:n]:
        def flip(model, name=name, call=call, k=k):
            seen = []

            def hook(module, inp, out):
                seen.append(1)
                if len(seen) == call + 1:
                    out = out.clone()
                    out.view(-1)[k] = -out.view(-1)[k]
                    return out
            model.get_submodule(name).register_forward_hook(hook)

        err = step_error({"cuda": _step(net, "cpu", x, y, hook=flip)[0], "cpu": cpu})
        rows.append({"bn": name, "micro_batch": call, "index": k, "value": value,
                     "of_its_largest": rel, "flipped": dict(zip(("loss", "update", "stats"),
                                                                err))})
    print(json.dumps({"net": net, "batch": f"{micro} x 2", "nearest_relu_edge": rows}),
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nets", nargs="+", default=["cifar/vgg", "cifar/prnmg", "cifar/pnmg"],
                    choices=sorted(CIFAR_RECIPES))
    ap.add_argument("--micro", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--repeat", type=int, default=0,
                    help="more card steps, cuDNN default and deterministic in turns")
    ap.add_argument("--replay", type=int, default=0,
                    help="card steps with cuDNN's default choice, held call by call to a "
                         "deterministic one")
    ap.add_argument("--edge", type=int, default=0,
                    help="the BatchNorm outputs nearest a ReLU's edge in the CPU step, each "
                         "flipped")
    ap.add_argument("--device", default="cuda",
                    help="where the first line's card step runs (cpu: for --edge alone)")
    ap.add_argument("--warm", action="store_true",
                    help="first chip_smoke.py's CIFAR serving and bf16 training phases")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.warm:
        rec = chip_smoke.record_cifar()
        name = torch.cuda.get_device_name(0)
        chip_smoke.check_cifar_serve(name, rec)
        for net, (_, micro, iters) in CIFAR_RECIPES.items():
            tr = Trainer(cifar_opts(net), seed=0, device="cuda", compute_dtype=torch.bfloat16,
                         iter_size=iters)
            xb, yb = synthetic_batch(micro * iters, seed=1, n_classes=100, shape=CIFAR_IMAGE)
            for _ in range(chip_smoke.TRAIN_STEPS):
                tr.step(xb, yb, chip_smoke.CIFAR_LR, 5e-4)
            del tr
    for net in args.nets:
        for micro in args.micro:
            t0 = time.perf_counter()
            x, y = synthetic_batch(2 * micro, seed=2, n_classes=100, shape=CIFAR_IMAGE)
            moved = x * (1 + 1e-6 * np.random.default_rng(3).standard_normal(x.shape,
                                                                            dtype=np.float32))
            gpu, upd_gpu = _step(net, args.device, x, y)
            cpu, upd_cpu = _step(net, "cpu", x, y)
            cpu_moved, upd_moved = _step(net, "cpu", moved, y)
            err = step_error({"cuda": gpu, "cpu": cpu})
            own = step_error({"cuda": cpu_moved, "cpu": cpu})
            sq = {k: float(((upd_gpu[k] - upd_cpu[k]) ** 2).sum()) for k in upd_cpu}
            total = sum(sq.values()) or 1.0
            top = sorted(sq, key=sq.get, reverse=True)[:5]
            print(json.dumps({
                "net": net, "batch": f"{micro} x 2", "card_vs_cpu": dict(zip(
                    ("loss", "update", "stats"), err)),
                "cpu_moved_vs_cpu": dict(zip(("loss", "update", "stats"), own)),
                "error_share": {k: sq[k] / total for k in top},
                "error_of_its_update": {k: float(np.sqrt(sq[k]) / max(
                    float(upd_cpu[k].norm()), 1e-30)) for k in top},
                "moved_change_of_its_update": {k: float((upd_moved[k] - upd_cpu[k]).norm() / max(
                    float(upd_cpu[k].norm()), 1e-30)) for k in top},
                "seconds": time.perf_counter() - t0}), flush=True)
            errs = {"default": [], "deterministic": []}
            for i in range(args.repeat):
                mode = ("default", "deterministic")[i % 2]
                errs[mode].append(step_error({"cuda": _step(net, "cuda", x, y, mode != "default")[0],
                                              "cpu": cpu})[1])
            if args.replay:
                replay(net, micro, x, y, cpu, args.replay)
            if args.edge:
                edge(net, micro, x, y, cpu, args.edge)
            if args.repeat:
                print(json.dumps({"net": net, "batch": f"{micro} x 2", "warm": args.warm,
                                  "card_vs_cpu_update": errs, "over_1e-3": {
                                      k: sum(e > 1e-3 for e in v) for k, v in errs.items()}}),
                      flush=True)


if __name__ == "__main__":
    main()
