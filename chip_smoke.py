#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`mgtpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card and nvcc

Builds the port's CUDA kernels from `mgtpu_torch/csrc/`, holds each one
against its plain PyTorch version at the shapes R-MG-34 gives it, serves
a few requests through `mgtpu_torch.serve.Server` (R-MG-34, BN folded,
bf16, seeded random weights), takes a few training steps through
`mgtpu_torch.trainer.Trainer` (R-MG-34, bf16, SGD), checks that both
paths went through the kernels and agree with the port's plain CPU path
in f32, and times the kernels, the serving forward and the training
step with CUDA events. Phases:

  1 device   the card, and its name and power limit from nvidia-smi
  2 build    nvcc over mgtpu_torch/csrc/*.cu, bound with ctypes
  3 conv3x3  kernel vs conv3x3_plain at every (H, W, Ci, Co) of the slice,
             batch 8, bf16 and f32, relu_out and with_stats on and off,
             each launch through the design cuda_conv._route picks (sm90:
             TMA + wgmma, for bf16 with Ci, Co multiples of 64; tile:
             the rest)
  4 maxpool2 kernel vs maxpool2_plain, exact, with odd sizes, NaN and -inf,
             each launch through the design cuda_pool._route picks (sm90:
             bulk copies into a ring, 16-byte lanes, for even H and
             16-byte pixels; simple: the rest), and the simple design
             beside it at every shape routed to sm90
  5 serve    batches of 1, 8 and 32 images: shape, finiteness, rows that
             are distributions, exactly 112 conv3x3 and 46 maxpool2
             launches per forward, each conv and pool through the design
             _route predicts from the shapes recorded on the CPU (all 46
             pools sm90); the f32 forward on the card vs the plain
             forward on the CPU
  6 times    each kernel vs its plain version (cuDNN) at batch 128 bf16,
             on the card's clock (queued behind a sleep kernel, so the
             host's launch rate does not set the pace), in turns, with the
             tile design beside the sm90 one at every shape routed to
             sm90 and cuDNN's one call (library); the pool at each shape
             through sm90, simple, its plain version and F.max_pool2d,
             each call on the next of enough copies of its input (over
             100 MB) that it reads from device memory, not the 50 MB L2,
             after a check at batch 128 that sm90 equals the plain
             version; ms, GB/s and share of the bound; each pool
             design's time split by least squares into a fixed cost a
             launch and a rate, beside an empty kernel's; the serving
             forward in images/s at batch 128 bf16, and its time per call
             at batch 1 (these two include the host)
  7 conv3x3_bn_relu_in  kernel vs its plain version at every (H, W, Ci,
             Co) of the training step, batch 8, bf16 and f32, relu_out
             and with_stats on and off, some shifts positive (the halo);
             at the shapes routed to sm90 also with exact zeros in the
             border rows and columns of x
  8 maxpool2_bwd  kernel vs maxpool2_bwd_plain, exact, both tie rules, at
             the training step's shapes and odd sizes; ties at zero and
             at positive values, NaN, all -inf windows
  9 grads    the conv3x3, conv3x3_bn_relu_in and maxpool2 autograd
             Functions vs autograd of their plain versions, f32, no TF32
 10 train    4 steps of R-MG-34 bf16 at batch 32 on one fixed batch: the
             loss stays finite and falls; exactly 76 conv3x3, 36
             conv3x3_bn_relu_in, 46 maxpool2 and 46 maxpool2_bwd launches
             per step, the convs and pools through the predicted designs;
             one f32 step on the card vs the plain CPU step
 11 times    the training step in images/s at batch 128 bf16; each new
             kernel's summed time per step vs its plain version (and the
             tile design's, as in phase 6); the pool backward on rotated
             inputs as in phase 6, beside aten's
             max_pool2d_with_indices_backward (indices made outside the
             timed calls: not quite the same function)

Any failed check exits non-zero. The second-to-last line of stdout is
one JSON object with the kernels: ``launches`` sums each kernel's
launches over the main-path runs (phase 5's serving forwards and phase
10's training steps), ``max_abs_err`` is its largest error against its
plain version (phases 3, 4, 7, 8), and ``ms`` / ``plain_ms`` /
``library_ms`` are the summed times of its launches (through the design
each takes), of its plain version and of one PyTorch call of the same
function (null where there is none) in one batch-128 bf16 serving
forward (conv3x3, maxpool2) or training step (conv3x3_bn_relu_in,
maxpool2_bwd). ``bound_ms`` is the least time the card could take for
the same launches (:func:`path_bounds`), ``bound_by`` which bound sets
most of it. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from mgtpu_torch import kernels
from mgtpu_torch.models import get_net
from mgtpu_torch.models.base import imagenet_rule
from mgtpu_torch.ops import cuda_conv, cuda_pool
from mgtpu_torch.ops.cuda_conv import (bn_relu_plain, conv3x3, conv3x3_bn_relu_in,
                                       conv3x3_bn_relu_in_plain, conv3x3_plain)
from mgtpu_torch.ops.cuda_pool import (maxpool2, maxpool2_backward, maxpool2_bwd_plain,
                                       maxpool2_plain)
from mgtpu_torch.ops.resample import nchw
from mgtpu_torch.serve import IMAGE_SHAPE, Server
from mgtpu_torch.trainer import Trainer, synthetic_batch
from mgtpu_torch.utils.bridge import export_jax_tree

DEPTH = 34
# launches per R-MG-34 serving forward (one per 3x3 same/down part; every
# maxpool2_ceil of the exchange and the MgPools)
PER_FORWARD = {"conv3x3": 112, "conv3x3_bn_relu_in": 0, "maxpool2": 46, "maxpool2_bwd": 0}
# launches per training step: stage 2's 36 same-scale parts take the
# prologue kernel instead of conv3x3; every pool is differentiated once
PER_STEP = {"conv3x3": 76, "conv3x3_bn_relu_in": 36, "maxpool2": 46, "maxpool2_bwd": 46}
# the (H, W, C) at which R-MG-34 pools, in either pass
RMG34_POOLS = [(14, 14, 16), (14, 14, 32), (14, 14, 64), (14, 14, 128), (14, 14, 256),
               (28, 28, 32), (28, 28, 64), (28, 28, 128), (56, 56, 64)]
KERNELS = {
    "conv3x3": dict(route="cuda", source="mgtpu_torch/csrc/conv3x3.cu",
                    replaces="mgtpu/ops/pallas_conv.py:220"),
    "conv3x3_bn_relu_in": dict(route="cuda", source="mgtpu_torch/csrc/conv3x3.cu",
                               replaces="mgtpu/ops/pallas_conv.py:259"),
    "maxpool2": dict(route="cuda", source="mgtpu_torch/csrc/maxpool2.cu",
                     replaces="mgtpu/ops/pallas_pool.py:63"),
    "maxpool2_bwd": dict(route="cuda", source="mgtpu_torch/csrc/maxpool2.cu",
                         replaces="mgtpu/ops/pallas_pool.py:84"),
}
CHECK_BATCH, TIME_BATCH = 8, 128
# the H100 SXM's published peaks (NVIDIA's data sheet): dense bf16 on the
# tensor cores and HBM3 bandwidth. Bounds and shares are against these,
# whatever power limit the card runs at (printed beside them).
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
# a timed pool call reads its input from device memory only if the other
# inputs it rotates through (more than this in all) have pushed it out of
# the 50 MB L2
COLD_BYTES = 100e6
SERVE_BATCHES = (1, 8, 32)
TRAIN_BATCH, TRAIN_STEPS, F32_STEP_BATCH = 32, 4, 2
# imagenet_rule's second stage (epoch 31): at the epoch-1 rate of 0.1 a
# fixed batch of 32 from a random init overshoots after the first step,
# in the JAX train step as in the port
TRAIN_RULE = imagenet_rule(31)
# f32 step, card vs CPU, same seed and batch: the L2 error of the whole
# parameter update relative to its L2 norm, and the running stats' error
# relative to their scale. Both sides compute in f32 (no TF32) in another
# summation order. One step of this net is sensitive to that: where a
# pre-activation rounds to the other side of a ReLU kink, or a BN's
# one-pass variance cancels, whole gradient terms change. On the CPU the
# same step in f32 against f64 moves the update by 1.6e-3 of its norm
# (4.7% of one tensor's largest change) and the stats by 4e-6; the
# bounds are about six times that and 25 times that.
F32_STEP_PARAM_BOUND, F32_STEP_STATS_BOUND = 1e-2, 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def record_kernel_shapes(train: bool):
    """One R-MG-34 f32 pass at batch 1 on the CPU (the plain path),
    recording the input shapes of every kernel entry point it calls:
    the serving forward (BN folded), or a training forward and backward.
    Returns {kernel: Counter of shapes}."""
    shapes = {k: Counter() for k in PER_STEP}
    hooks = {(cuda_conv, "conv3x3_forward"): ("conv3x3", lambda x, *a, **kw: (
                 x.shape[1], x.shape[2], x.shape[3], a[0].shape[3])),
             (cuda_conv, "conv3x3_bn_relu_in_forward"): ("conv3x3_bn_relu_in", lambda x, *a, **kw: (
                 x.shape[1], x.shape[2], x.shape[3], a[0].shape[3])),
             (cuda_pool, "maxpool2_forward"): ("maxpool2", lambda x, *a: tuple(x.shape[1:])),
             (cuda_pool, "maxpool2_backward"): ("maxpool2_bwd", lambda x, *a: tuple(x.shape[1:]))}
    originals = {key: getattr(*key) for key in hooks}

    def recording(key):
        name, shape_of = hooks[key]

        def fn(*a, **kw):
            shapes[name][shape_of(*a, **kw)] += 1
            return originals[key](*a, **kw)
        return fn

    if train:
        model = get_net("ilsvrc/rnmg")(depth=DEPTH).train()
    else:
        server = Server(DEPTH, seed=0, device="cpu", compute_dtype=torch.float32)
    for key in hooks:
        setattr(*key, recording(key))
    try:
        if train:
            model(torch.zeros((1, *IMAGE_SHAPE)))[:, 0].sum().backward()
        else:
            server.predict(np.zeros((1, *IMAGE_SHAPE), np.float32))
    finally:
        for key, fn in originals.items():
            setattr(*key, fn)
    return shapes


def predicted_routes(shapes) -> dict:
    """{(kernel, design): launches} that cuda_conv._route and
    cuda_pool._route give one pass's recorded conv and pool calls in
    bf16: stand-in CPU tensors of their shapes (on the card the
    activations and the weight slices, which start at a multiple of Co
    elements, are 16-byte aligned as they are)."""
    got = dict.fromkeys(kernels.ROUTES, 0)
    for kernel in ("conv3x3", "conv3x3_bn_relu_in"):
        for (h, w, ci, co), count in shapes[kernel].items():
            x = torch.empty((1, h, w, ci), dtype=torch.bfloat16)
            wt = torch.empty((3, 3, ci, co), dtype=torch.bfloat16)
            got[(kernel, cuda_conv._route(x, wt))] += count
    for shape, count in shapes["maxpool2"].items():
        got[("maxpool2", cuda_pool._route(torch.empty((1, *shape), dtype=torch.bfloat16)))] += count
    return got


def kernel_work(kernel, shape, batch, itemsize=2):
    """(operations, bytes) that one launch of `kernel` at a recorded shape
    must do at `batch`: each input read once, each output written once.
    A conv's operations are its multiply-adds (2 each) on taps inside
    the image: along H, 3H - 2 of the 3H taps (the first and the last
    row each miss one to the zero padding), and as many along W. A pool's
    comparisons are not counted (no peak rate of the card is theirs, and
    they are far below its bytes)."""
    if kernel.startswith("conv3x3"):
        h, w, ci, co = shape
        px = batch * h * w
        # x, w, y in the operand type; the f32 bias (and scale and shift)
        nbytes = itemsize * (px * ci + 9 * ci * co + px * co) + 4 * co
        if kernel == "conv3x3_bn_relu_in":
            nbytes += 8 * ci
        return 2 * batch * (3 * h - 2) * (3 * w - 2) * ci * co, nbytes
    h, w, c = shape
    x_el, y_el = batch * h * w * c, batch * -(-h // 2) * -(-w // 2) * c
    if kernel == "maxpool2":
        return 0, itemsize * (x_el + y_el)
    return 0, itemsize * (2 * x_el + 2 * y_el)  # maxpool2_bwd: x, y, g in; dx out


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take
    for this work, and which of the two sets it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def path_bounds(shapes, batch):
    """{kernel: (operations, bytes, bound ms, bound_by)} summed over one
    pass's launches (record_kernel_shapes' counts) at `batch` in bf16:
    the bound of each launch, summed; bound_by names the bound that sets
    most of that sum."""
    out = {}
    for kernel, counts in shapes.items():
        flops = nbytes = ms = ops_ms = 0
        for shape, count in counts.items():
            f, b = kernel_work(kernel, shape, batch)
            t, by = bound(f, b)
            flops, nbytes, ms = flops + count * f, nbytes + count * b, ms + count * t
            ops_ms += count * t * (by == "operations")
        out[kernel] = (flops, nbytes, ms, "operations" if ms and 2 * ops_ms >= ms else "bytes")
    return out


def rotating(fn, sets):
    """A function that calls fn on the next argument tuple of `sets` each
    time, in turn: with sets of more than COLD_BYTES in all, each call
    reads its inputs from device memory, not from the L2 cache."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def cold_copies(tensors):
    """`tensors` and enough copies of them to hold more than COLD_BYTES
    in all: argument tuples for :func:`rotating`."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(int(COLD_BYTES // nbytes) + 1)]


def routes_since(before: dict) -> dict:
    return {k: kernels.ROUTES[k] - before[k] for k in kernels.ROUTES}


def routed(kernel, x, wt, fn):
    """fn(), which must launch `kernel` once, through the design _route
    picks for (x, wt)."""
    before = dict(kernels.ROUTES)
    out = fn()
    want = {k: int(k == (kernel, cuda_conv._route(x, wt))) for k in kernels.ROUTES}
    check(routes_since(before) == want, f"{kernel} {tuple(x.shape)}->{wt.shape[3]} {x.dtype}: "
          f"launched {routes_since(before)}, expected {want}")
    return out


def conv_inputs(n, h, w, ci, co, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, ci), dtype=np.float32))
    wt = torch.from_numpy(rng.standard_normal((3, 3, ci, co), dtype=np.float32) / np.sqrt(9 * ci))
    b = torch.from_numpy(0.1 * rng.standard_normal(co, dtype=np.float32))
    return x.cuda().to(dtype), wt.cuda().to(dtype), b.cuda()


def pool_input(shape, dtype, seed, ties=False):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    if ties:  # ReLU outputs on a coarse grid: ties at zero and at positive values
        x = np.maximum(np.round(x * 2) / 2, 0)
    x[0, 0, 0, 0] = np.nan
    x[0, -1, -1, -1] = np.inf
    x[-1, :2, :2, :] = -np.inf  # a window of -inf only
    x[-1, -1, -1, -1] = np.nan  # in a clipped edge window when H or W is odd
    return torch.from_numpy(x).cuda().to(dtype)


def misaligned(t):
    """t's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary"""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    off = next(i for i in range(1, 16) if (flat.data_ptr() + i * t.element_size()) % 16 == 4)
    view = flat[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def pool_equal(y, y_ref):
    """(equal, largest abs difference): NaN equals NaN"""
    same = (y == y_ref) | (torch.isnan(y) & torch.isnan(y_ref))
    err = torch.where(same, 0.0, (y.float() - y_ref.float()).abs().nan_to_num(float("inf")))
    return bool(same.all()) and y.shape == y_ref.shape, err.max().item()


def pooled(x, design):
    """maxpool2's forward on x, which must launch once, through `design`:
    maxpool2 where that is the design cuda_pool._route picks, else the
    simple design's own entry."""
    before = dict(kernels.ROUTES)
    y = maxpool2(x) if design == cuda_pool._route(x) else cuda_pool._simple_forward(x)
    want = {k: int(k == ("maxpool2", design)) for k in kernels.ROUTES}
    check(routes_since(before) == want, f"maxpool2 {tuple(x.shape)} {x.dtype}: launched "
          f"{routes_since(before)}, expected {want}")
    return y


def check_pool(pool_shapes, max_err) -> None:
    """4: maxpool2 vs maxpool2_plain: a max selects one input, so exact,
    NaN included. Each launch through the design _route picks; at the
    shapes routed to sm90 also through the simple design and, from a
    misaligned copy of x, through the route that takes (simple)."""
    shapes = [(CHECK_BATCH, *s) for s in sorted(pool_shapes)]
    # odd H (simple), odd W (sm90 at 8x9x64), a last chunk of fewer row
    # pairs (280 pairs at 40x14x14x16: 3 a chunk on 132 SMs), a row pair
    # wider than a stage (4x300x64: simple)
    shapes += [(2, 7, 9, 3), (3, 15, 14, 130), (1, 1, 1, 4), (2, 57, 55, 64), (2, 8, 9, 64),
               (40, 14, 14, 16), (1, 4, 300, 64)]
    designs = Counter()
    for k, shape in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            x = pool_input(shape, dtype, seed=k)
            cases = [(x, cuda_pool._route(x))]
            if cases[0][1] == "sm90":
                cases += [(x, "simple"), (misaligned(x), "simple")]
            for xi, design in cases:
                y, y_ref = pooled(xi, design), maxpool2_plain(xi)
                torch.cuda.synchronize()
                same, err = pool_equal(y, y_ref)
                max_err["maxpool2"] = max(max_err["maxpool2"], err)
                check(same, f"maxpool2 {shape} {dtype} {design} (x at {xi.data_ptr() % 16} "
                      f"past 16 bytes): differs from the plain version")
                designs[design] += 1
    phase("maxpool2", f"{sum(designs.values())} cases at {len(shapes)} shapes (bf16 and f32; "
          f"odd sizes, NaN, +-inf; {designs['sm90']} through sm90, {designs['simple']} through "
          f"simple): equal to the plain version")


def bn_inputs(ci, seed):
    """A BN scale and shift; about three shifts in four are positive, so
    a kernel that normalized its zero halo would be caught."""
    rng = np.random.default_rng(seed)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, ci).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0.3, 0.5, ci).astype(np.float32))
    return scale.cuda(), shift.cuda()


def rel_share(got, ref, rtol):
    """Largest error as a share of its bound rtol*|ref| + 1e-5*max|ref|."""
    err = (got.float() - ref.float()).abs()
    return (err / (rtol * ref.float().abs() + 1e-5 * ref.float().abs().max())).max().item()


def device_ms(fns, windows=5):
    """Median and relative spread (max - min over median) of each
    function's per-call time on the card, timed in turns: each window
    times every function once, in an order that rotates from window to
    window. A window's back-to-back calls (enough to fill ~5 ms) are
    queued behind a sleep kernel that outlasts the host's enqueueing of
    them, so the CUDA events time the card, not the host's launch rate
    (which sets the pace of back-to-back calls of a short kernel).
    Returns [(median, spread)] in the order of fns."""
    reps, host_s = [], []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps.append(max(1, min(50, int(0.005 / max(time.perf_counter() - t0, 1e-6)))))
        t0 = time.perf_counter()
        for _ in range(reps[-1]):
            fn()
        host_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    per = [[] for _ in fns]
    for i in range(windows):
        for j in [(i + k) % len(fns) for k in range(len(fns))]:
            # ~2e9 cycles a second at the H100's boost clock; longer at a lower one
            torch.cuda._sleep(int(2e9 * (2 * host_s[j] + 1e-3)))
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps[j]):
                fns[j]()
            b.record()
            b.synchronize()
            per[j].append(a.elapsed_time(b) / reps[j])
    return [(statistics.median(p), (max(p) - min(p)) / statistics.median(p)) for p in per]


def time_conv(kname, shape, count, unit, fns, ms, plain_ms, tile_ms, library_ms) -> None:
    """Times of one conv shape at batch 128, in turns: the routed kernel,
    its plain version, cuDNN's one call where there is one (library)
    and, where the kernel is routed to sm90, the tile design, with their
    rates in the operations kernel_work counts. Adds count x each to the
    per-forward (or per-step) sums."""
    flops = kernel_work(kname, shape, TIME_BATCH)[0]
    names = list(fns)
    res = dict(zip(names, device_ms([fns[k] for k in names])))
    route = names[0]
    ms[kname] += count * res[route][0]
    plain_ms[kname] += count * res["plain"][0]
    tile_ms[kname] += count * res["tile" if "tile" in res else route][0]
    if "library" in res:
        library_ms[kname] += count * res["library"][0]
    h, w, ci, co = shape
    phase("times", f"{kname} {TIME_BATCH}x{h}x{w}x{ci}->{co} (x{count}/{unit}): " + ", ".join(
        f"{k} {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s, spread {sp:.1%})"
        for k, (t, sp) in res.items()))


def time_pool(pool_shapes, ms, plain_ms, library_ms) -> None:
    """6, the pool forward at each shape of the serving forward, batch 128
    bf16: first a check that the routed design (sm90) equals the plain
    version at this size (many chunks a block: the ring wraps), then the
    times of sm90, simple, the plain version and F.max_pool2d(ceil_mode)
    on the channels_last view, in turns, each call on the next of its
    rotated copies of the input (cold L2)."""
    simple_ms = bound_ms = 0.0
    points = {"sm90": [], "simple": []}  # (bytes, ms) of each design at each shape
    for k, ((h, w, c), count) in enumerate(sorted(pool_shapes.items())):
        x = pool_input((TIME_BATCH, h, w, c), torch.bfloat16, seed=k)
        same, _ = pool_equal(pooled(x, "sm90"), maxpool2_plain(x))
        check(same, f"maxpool2 {TIME_BATCH}x{h}x{w}x{c} sm90: differs from the plain version")
        sets = cold_copies([x])
        fns = {"sm90": rotating(maxpool2, sets),
               "simple": rotating(cuda_pool._simple_forward, sets),
               "plain": rotating(maxpool2_plain, sets),
               "max_pool2d": rotating(lambda t: F.max_pool2d(nchw(t), 2, 2, ceil_mode=True), sets)}
        res = dict(zip(fns, device_ms(list(fns.values()))))
        nbytes = kernel_work("maxpool2", (h, w, c), TIME_BATCH)[1]
        t_bound = bound(0, nbytes)[0]
        ms["maxpool2"] += count * res["sm90"][0]
        simple_ms += count * res["simple"][0]
        plain_ms["maxpool2"] += count * res["plain"][0]
        library_ms["maxpool2"] += count * res["max_pool2d"][0]
        bound_ms += count * t_bound
        for d, pts in points.items():
            pts.append((nbytes, res[d][0]))
        phase("times", f"maxpool2 {TIME_BATCH}x{h}x{w}x{c} (x{count}/forward; {nbytes / 1e6:.1f} "
              f"MB, bound {t_bound:.4f} ms; {len(sets)} rotated inputs): " + ", ".join(
                  f"{d} {t:.4f} ms ({nbytes / t / 1e6:.0f} GB/s, {t_bound / t:.0%} of the bound, "
                  f"spread {sp:.1%})" for d, (t, sp) in res.items()))
    phase("times", f"maxpool2 per batch-{TIME_BATCH} forward, cold L2: sm90 {ms['maxpool2']:.3f} "
          f"ms ({bound_ms / ms['maxpool2']:.0%} of its {bound_ms:.4f} ms bound), simple "
          f"{simple_ms:.3f} ms, plain {plain_ms['maxpool2']:.3f} ms, F.max_pool2d "
          f"{library_ms['maxpool2']:.3f} ms")
    # what a launch costs before it streams: each design's time as a fixed
    # cost plus its bytes at a rate, and the card's floor for any launch
    empty = device_ms([lambda: torch.cuda._sleep(0)])[0][0]
    for d, pts in points.items():
        slope, fixed = np.polyfit([b for b, _ in pts], [t for _, t in pts], 1)
        phase("times", f"maxpool2 {d}: {fixed * 1e3:.2f} us a launch + its bytes at "
              f"{1e-9 / slope:.2f} TB/s (least squares over the {len(pts)} shapes); an empty "
              f"kernel (torch.cuda._sleep(0)) takes {empty * 1e3:.2f} us back to back")


def cuda_time_ms(fn, windows=5, min_reps=1):
    """Median and relative spread (max - min over median) of the
    per-call device time, over `windows` windows of back-to-back calls
    (at least `min_reps`, enough to fill ~5 ms) timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(min_reps, min(50, int(0.005 / max(time.perf_counter() - t0, 1e-6))))
    per = []
    for _ in range(windows):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    med = statistics.median(per)
    return med, (max(per) - min(per)) / med


def check_prologue(shapes, max_err) -> None:
    """7: conv3x3_bn_relu_in vs its plain version. Reference: the plain
    version in f32 on the same inputs, its normalized input rounded to
    the kernel's operand type first (bn_relu_plain, then conv3x3_plain in
    f32), so that the bounds are conv3x3's (phase 3)."""
    n_cases = n_halo = 0
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for k, (h, w, ci, co) in enumerate(sorted(shapes)):
        scale, shift = bn_inputs(ci, seed=100 + k)
        for dtype in (torch.bfloat16, torch.float32):
            x, wt, b = conv_inputs(CHECK_BATCH, h, w, ci, co, dtype, seed=100 + k)
            # where the sm90 design runs, also with exact zeros in the border
            # rows and columns: TMA fills the halo with zeros too, and only
            # the position tells the two apart (relu(shift) > 0 inside)
            halos = (False, True) if cuda_conv._route(x, wt) == "sm90" else (False,)
            for halo in halos:
                if halo:
                    x = x.clone()
                    x[:, [0, -1]] = 0
                    x[:, :, [0, -1]] = 0
                xn = bn_relu_plain(x, scale, shift).float()
                for relu_out in (False, True):
                    for with_stats in (False, True):
                        y, st = routed("conv3x3_bn_relu_in", x, wt, lambda: conv3x3_bn_relu_in(
                            x, wt, b, scale, shift, relu_out=relu_out, with_stats=with_stats))
                        y_ref, st_ref = conv3x3_plain(xn, wt.float(), b, relu_out=relu_out,
                                                      with_stats=with_stats)
                        torch.cuda.synchronize()
                        what = (f"conv3x3_bn_relu_in {h}x{w}x{ci}->{co} {dtype} relu={relu_out} "
                                f"stats={with_stats} zero border={halo}")
                        share = rel_share(y, y_ref,
                                          2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)
                        err = (y.float() - y_ref).abs().max().item()
                        check(y.dtype == dtype and share <= 1.0, f"{what}: max abs err {err:.3g}")
                        worst[dtype] = max(worst[dtype], share)
                        if with_stats:
                            st_err = (st - st_ref).abs()
                            st_tol = 1e-4 * st_ref.abs() + 1e-5 * st_ref.abs().max()
                            check(bool((st_err <= st_tol).all()),
                                  f"{what}: stats max abs err {st_err.max().item():.3g}")
                        else:
                            check(not st.any(), f"{what}: stats not zero")
                        max_err["conv3x3_bn_relu_in"] = max(max_err["conv3x3_bn_relu_in"], err)
                        n_cases += 1
                        n_halo += halo
    phase("conv3x3_bn_relu_in", f"{n_cases} cases at {len(shapes)} shapes, batch {CHECK_BATCH} "
          f"({n_halo} with a zero border, sm90), each through its routed design: match the "
          f"plain version (max abs err {max_err['conv3x3_bn_relu_in']:.3g}; largest "
          f"error {worst[torch.bfloat16]:.2f} of its bound in bf16, "
          f"{worst[torch.float32]:.2f} in f32)")


def check_pool_bwd(shapes, max_err) -> None:
    """8: maxpool2_bwd vs maxpool2_bwd_plain. Both select g or 0 per
    element, so they must be equal, under either tie rule."""
    shapes = [(CHECK_BATCH, *s) for s in sorted(shapes)]
    shapes += [(2, 7, 9, 3), (3, 15, 14, 130), (1, 1, 1, 4), (2, 57, 55, 64)]
    n_cases = 0
    for k, shape in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            for ties in (False, True):
                x = pool_input(shape, dtype, seed=200 + k, ties=ties)
                y = maxpool2_plain(x)
                g = torch.randn(y.shape, device="cuda")
                for rule in ("all", "first"):
                    dx = maxpool2_backward(x, y, g, rule)
                    ref = maxpool2_bwd_plain(x, y, g, rule)
                    torch.cuda.synchronize()
                    err = (dx.float() - ref.float()).abs().max().item()
                    max_err["maxpool2_bwd"] = max(max_err["maxpool2_bwd"], err)
                    check(dx.dtype == dtype and bool(torch.equal(dx, ref)),
                          f"maxpool2_bwd {shape} {dtype} ties={rule}: differs from the plain "
                          f"version (max abs err {err:.3g})")
                    n_cases += 1
    phase("maxpool2_bwd", f"{n_cases} cases (bf16 and f32, both tie rules; odd sizes, ties at "
          f"0 and > 0, NaN, all -inf windows): equal to the plain version")


def check_grads() -> None:
    """9: the autograd Functions (kernel forward; cuDNN dgrad and wgrad
    and the elementwise reductions backward) vs autograd of the plain
    versions, f32 without TF32: summation order only. Without relu_out,
    as the training path calls them: with it, each side masks its
    gradient by its own y > 0, and the two forwards round some y to
    opposite sides of 0 (tests/test_torch_conv3x3.py holds relu_out's
    backward against jax.grad on the CPU)."""
    worst = 0.0
    for k, (n, h, w, ci, co) in enumerate([(4, 28, 28, 32, 32), (4, 14, 14, 64, 64),
                                           (2, 7, 7, 128, 128)]):
        x, wt, b = conv_inputs(n, h, w, ci, co, torch.float32, seed=300 + k)
        scale, shift = bn_inputs(ci, seed=300 + k)
        r = torch.randn((n, h, w, co), device="cuda")
        for fn, plain, extra in ((conv3x3, conv3x3_plain, ()),
                                 (conv3x3_bn_relu_in, conv3x3_bn_relu_in_plain, (scale, shift))):
            grads = []
            for f in (fn, plain):
                ins = [t.clone().requires_grad_() for t in (x, wt, b, *extra)]
                y, _ = f(*ins)
                (y * r).sum().backward()
                grads.append([t.grad for t in ins])
            for name, g, g_ref in zip("x w b scale shift".split(), *grads):
                share = rel_share(g, g_ref, 1e-4)
                check(share <= 1.0, f"{fn.__name__} {n}x{h}x{w}x{ci}->{co}: d{name} differs "
                      f"from the plain autograd's")
                worst = max(worst, share)
    # the first-tie rule is torch max_pool2d's own: its autograd is the reference
    for dtype in (torch.float32, torch.bfloat16):
        x = pool_input((4, 28, 28, 64), dtype, seed=310, ties=True).nan_to_num(0.0)
        grads = []
        for f in (lambda t: maxpool2(t, "first"), maxpool2_plain):
            xt = x.clone().requires_grad_()
            f(xt).float().sin().sum().backward()
            grads.append(xt.grad)
        check(torch.equal(*grads), f"maxpool2 (first-tie rule) {dtype}: gradient differs from "
              f"max_pool2d's")
    phase("grads", f"conv3x3 and conv3x3_bn_relu_in gradients match plain autograd (largest "
          f"error {worst:.2f} of its bound, rtol 1e-4); maxpool2 first-tie gradients equal "
          f"max_pool2d's")


def check_train(name, train_routes) -> dict:
    """10: the training path, through the entry point a user calls."""
    t0 = time.perf_counter()
    trainer = Trainer(DEPTH, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    x, y = synthetic_batch(TRAIN_BATCH, seed=1)
    phase("train", f"R-MG-{DEPTH}, seeded random weights, bf16 on {name}: built in "
          f"{time.perf_counter() - t0:.1f} s; {TRAIN_STEPS} steps at batch {TRAIN_BATCH} on one "
          f"batch, lr {TRAIN_RULE['lr']}, wd {TRAIN_RULE['wd']}")
    kernels.reset_launches()
    losses, prev = [], dict(kernels.LAUNCHES)
    for i in range(TRAIN_STEPS):
        prev_routes = dict(kernels.ROUTES)
        m = trainer.step(x, y, TRAIN_RULE["lr"], TRAIN_RULE["wd"])
        now = dict(kernels.LAUNCHES)
        got = {k: now[k] - prev[k] for k in now}
        check(got == PER_STEP, f"step {i}: kernel launches {got}, expected {PER_STEP}")
        check(routes_since(prev_routes) == train_routes, f"step {i}: conv and pool designs "
              f"{routes_since(prev_routes)}, predicted {train_routes}")
        prev = now
        losses.append({k: float(v) for k, v in m.items()})
    launches = dict(kernels.LAUNCHES)
    loss = [m["loss"] for m in losses]
    check(all(np.isfinite(loss)), f"non-finite loss {loss}")
    check(loss[-1] < loss[0], f"the loss did not fall: {loss}")
    phase("train", "losses " + ", ".join(f"{v:.4f}" for v in loss) + "; top-1 "
          + ", ".join(f"{m['top1']:.3f}" for m in losses)
          + f"; launches per step {PER_STEP}, total {launches}; conv and pool designs per step "
          f"as predicted")

    # one f32 step on the card (kernels + cuDNN without TF32) against the
    # same step of the port's plain path on the CPU
    x2, y2 = synthetic_batch(F32_STEP_BATCH, seed=2)
    res = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(DEPTH, seed=0, device=dev, compute_dtype=torch.float32)
        before, _ = export_jax_tree(tr.model)
        m = tr.step(x2, y2, TRAIN_RULE["lr"], TRAIN_RULE["wd"])
        res[dev] = (float(m["loss"]), before, *export_jax_tree(tr.model))
    (l_gpu, p0, p_gpu, s_gpu), (l_cpu, _, p_cpu, s_cpu) = res["cuda"], res["cpu"]
    # the f32 serving forward agrees to 1e-5 of the log-probs' scale
    # (phase 5); the loss is a mean of log-probs
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), f"f32 step loss: card {l_gpu} vs CPU {l_cpu}")
    # the update of all parameters together: |change on the card - change
    # on the CPU| / |change on the CPU| (L2 over every parameter); the
    # running stats relative to their scale
    d_gpu = np.concatenate([(a - o).ravel() for a, o in zip(flat(p_gpu), flat(p0))])
    d_cpu = np.concatenate([(c - o).ravel() for c, o in zip(flat(p_cpu), flat(p0))])
    upd = float(np.linalg.norm(d_gpu - d_cpu) / np.linalg.norm(d_cpu))
    st = max(float(np.abs(a - c).max() / max(np.abs(c).max(), 1e-12))
             for a, c in zip(flat(s_gpu), flat(s_cpu)))
    check(upd <= F32_STEP_PARAM_BOUND and st <= F32_STEP_STATS_BOUND,
          f"f32 step, card vs CPU: update err {upd:.3g} (bound {F32_STEP_PARAM_BOUND}), "
          f"running stats err {st:.3g} (bound {F32_STEP_STATS_BOUND})")
    phase("train", f"f32 step on the card vs the plain CPU step, batch {F32_STEP_BATCH}: loss "
          f"{l_gpu:.6f} vs {l_cpu:.6f}; parameter update err {upd:.3g} of its L2 norm (bound "
          f"{F32_STEP_PARAM_BOUND}); running stats err {st:.3g} of their scale (bound "
          f"{F32_STEP_STATS_BOUND})")
    return launches


def flat(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat(tree[k])]
    return [tree]


def time_train(name, train_shapes, ms, plain_ms, tile_ms, library_ms) -> None:
    """11: the training step and the two kernels it adds, at batch 128
    bf16; the pool backward on rotated inputs (cold L2), as the forward
    in phase 6."""
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(DEPTH, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    x, y = synthetic_batch(TIME_BATCH, seed=4)
    xt = torch.from_numpy(x).cuda().to(torch.bfloat16)
    yt = torch.from_numpy(y).cuda()
    t_step, s_step = cuda_time_ms(lambda: trainer.step(xt, yt, TRAIN_RULE["lr"],
                                                       TRAIN_RULE["wd"]), min_reps=3)
    phase("times", f"training step, R-MG-{DEPTH} bf16, batch {TIME_BATCH}: {t_step:.2f} ms "
          f"(spread {s_step:.1%}) = {TIME_BATCH / t_step * 1e3:.1f} img/s on {name}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del trainer
    for k, ((h, w, ci, co), count) in enumerate(sorted(train_shapes["conv3x3_bn_relu_in"].items())):
        x, wt, b = conv_inputs(TIME_BATCH, h, w, ci, co, torch.bfloat16, seed=400 + k)
        scale, shift = bn_inputs(ci, seed=400 + k)
        fns = {cuda_conv._route(x, wt): lambda: conv3x3_bn_relu_in(x, wt, b, scale, shift,
                                                                   with_stats=False),
               "plain": lambda: conv3x3_bn_relu_in_plain(x, wt, b, scale, shift,
                                                         with_stats=False)}
        if "sm90" in fns:
            fns["tile"] = lambda: cuda_conv._tile_forward(x, wt, b, scale, shift,
                                                          with_stats=False)
        time_conv("conv3x3_bn_relu_in", (h, w, ci, co), count, "step", fns, ms, plain_ms, tile_ms,
                  library_ms)
    bound_ms = 0.0
    for k, ((h, w, c), count) in enumerate(sorted(train_shapes["maxpool2_bwd"].items())):
        x = pool_input((TIME_BATCH, h, w, c), torch.bfloat16, seed=500 + k, ties=True)
        y = maxpool2_plain(x)
        g = torch.randn(y.shape, device="cuda").to(torch.bfloat16)
        # aten's backward starts from the first-tie indices, made here,
        # outside the timed calls: not quite the same function
        idx = F.max_pool2d(nchw(x), 2, 2, ceil_mode=True, return_indices=True)[1]
        sets = cold_copies([x, y, g, idx])
        res = dict(zip(("kernel", "plain", "aten"), device_ms([
            rotating(lambda x, y, g, i: maxpool2_backward(x, y, g, "first"), sets),
            rotating(lambda x, y, g, i: maxpool2_bwd_plain(x, y, g, "first"), sets),
            rotating(lambda x, y, g, i: torch.ops.aten.max_pool2d_with_indices_backward(
                nchw(g), nchw(x), [2, 2], [2, 2], [0, 0], [1, 1], True, i), sets)])))
        nbytes = kernel_work("maxpool2_bwd", (h, w, c), TIME_BATCH)[1]
        t_bound = bound(0, nbytes)[0]
        ms["maxpool2_bwd"] += count * res["kernel"][0]
        plain_ms["maxpool2_bwd"] += count * res["plain"][0]
        library_ms["maxpool2_bwd"] += count * res["aten"][0]
        bound_ms += count * t_bound
        phase("times", f"maxpool2_bwd {TIME_BATCH}x{h}x{w}x{c} (x{count}/step; "
              f"{nbytes / 1e6:.1f} MB, bound {t_bound:.4f} ms; {len(sets)} rotated inputs): "
              + ", ".join(f"{d} {t:.4f} ms ({nbytes / t / 1e6:.0f} GB/s, {t_bound / t:.0%} of the "
                          f"bound, spread {sp:.1%})" for d, (t, sp) in res.items()))
    phase("times", f"conv3x3_bn_relu_in per batch-{TIME_BATCH} training step: kernel "
          f"{ms['conv3x3_bn_relu_in']:.3f} ms (the tile design alone "
          f"{tile_ms['conv3x3_bn_relu_in']:.3f} ms), plain {plain_ms['conv3x3_bn_relu_in']:.3f} ms")
    phase("times", f"maxpool2_bwd per batch-{TIME_BATCH} training step, cold L2: kernel "
          f"{ms['maxpool2_bwd']:.3f} ms ({bound_ms / ms['maxpool2_bwd']:.0%} of its "
          f"{bound_ms:.4f} ms bound), plain {plain_ms['maxpool2_bwd']:.3f} ms, aten's "
          f"max_pool2d_with_indices_backward {library_ms['maxpool2_bwd']:.3f} ms")


def main() -> None:
    # 1 device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this smoke run "
          "needs an NVIDIA GPU (there is no CPU path)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    phase("device", f"{name}; {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # f32 references in full f32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2 build
    t0 = time.perf_counter()
    so, nvcc_s, log = kernels.build()
    kernels.library()
    phase("build", f"{so.name}: nvcc {nvcc_s:.1f} s, built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            phase("build", line.strip())

    serve_shapes, train_shapes = record_kernel_shapes(False), record_kernel_shapes(True)
    for what, shapes, want in (("serving forward", serve_shapes, PER_FORWARD),
                               ("training step", train_shapes, PER_STEP)):
        got = {k: sum(c.values()) for k, c in shapes.items()}
        check(got == want, f"the CPU {what} made kernel calls {got}, expected {want}")
        check(sorted(shapes["maxpool2"]) == RMG34_POOLS,
              f"the CPU {what} pooled at {sorted(shapes['maxpool2'])}, expected {RMG34_POOLS}")
    conv_shapes, pool_shapes = serve_shapes["conv3x3"], serve_shapes["maxpool2"]
    max_err = dict.fromkeys(KERNELS, 0.0)
    # the designs each pass's bf16 convs take, predicted from the shapes
    serve_routes, train_routes = predicted_routes(serve_shapes), predicted_routes(train_shapes)
    check(serve_routes[("conv3x3", "sm90")] >= 70
          and train_routes[("conv3x3_bn_relu_in", "sm90")] >= 26,
          f"too few convs routed to sm90: {serve_routes}, {train_routes}")
    check(serve_routes[("maxpool2", "sm90")] == PER_FORWARD["maxpool2"]
          and train_routes[("maxpool2", "sm90")] == PER_STEP["maxpool2"],
          f"not every pool routed to sm90: {serve_routes}, {train_routes}")
    for what, routes in (("serving forward", serve_routes), ("training step", train_routes)):
        phase("route", f"per {what}, predicted: " + ", ".join(
            f"{k} {r} {n}" for (k, r), n in routes.items()))

    # 3 conv3x3 vs plain. Reference: the plain version in f32 on the same
    # (bf16-rounded) inputs. f32 differs by summation order only; bf16 adds
    # one rounding of the f32 accumulator to bf16, up to 2^-8 relative (8
    # significant bits), so its bound is twice that. Stats sum N*H*W
    # values with atomics in a varying order.
    n_cases = 0
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}  # largest error / its bound
    for k, (h, w, ci, co) in enumerate(sorted(conv_shapes)):
        for dtype in (torch.bfloat16, torch.float32):
            x, wt, b = conv_inputs(CHECK_BATCH, h, w, ci, co, dtype, seed=k)
            for relu_out in (False, True):
                for with_stats in (False, True):
                    y, st = routed("conv3x3", x, wt, lambda: conv3x3(
                        x, wt, b, relu_out=relu_out, with_stats=with_stats))
                    y_ref, st_ref = conv3x3_plain(x.float(), wt.float(), b, relu_out=relu_out,
                                                  with_stats=with_stats)
                    torch.cuda.synchronize()
                    scale = y_ref.abs().max().item()
                    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
                    err = (y.float() - y_ref).abs()
                    share = (err / (rtol * y_ref.abs() + 1e-5 * scale)).max().item()
                    what = f"conv3x3 {h}x{w}x{ci}->{co} {dtype} relu={relu_out} stats={with_stats}"
                    check(y.dtype == dtype and share <= 1.0,
                          f"{what}: max abs err {err.max().item():.3g} (scale {scale:.3g})")
                    worst[dtype] = max(worst[dtype], share)
                    if with_stats:
                        st_err = (st - st_ref).abs()
                        st_tol = 1e-4 * st_ref.abs() + 1e-5 * st_ref.abs().max()
                        check(bool((st_err <= st_tol).all()),
                              f"{what}: stats max abs err {st_err.max().item():.3g}")
                    else:
                        check(not st.any(), f"{what}: stats not zero")
                    max_err["conv3x3"] = max(max_err["conv3x3"], err.max().item())
                    n_cases += 1
    phase("conv3x3", f"{n_cases} cases at {len(conv_shapes)} shapes, batch {CHECK_BATCH}, each "
          f"through its routed design: match the plain version (max abs err "
          f"{max_err['conv3x3']:.3g}; largest error {worst[torch.bfloat16]:.2f} of its bound in bf16, {worst[torch.float32]:.2f} in f32)")

    check_pool(pool_shapes, max_err)

    # 5 serve: the main path, through the entry point a user calls
    t0 = time.perf_counter()
    server = Server(DEPTH, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    phase("serve", f"R-MG-{DEPTH}, seeded random weights, BN folded, bf16 on {name}: "
          f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    requests = [rng.standard_normal((b, *IMAGE_SHAPE), dtype=np.float32) for b in SERVE_BATCHES]
    kernels.reset_launches()
    outs, prev = [], dict(kernels.LAUNCHES)
    for x in requests:
        prev_routes = dict(kernels.ROUTES)
        outs.append(server.predict(x))
        now = dict(kernels.LAUNCHES)
        got = {k: now[k] - prev[k] for k in now}
        check(got == PER_FORWARD, f"batch {len(x)}: kernel launches {got}, expected {PER_FORWARD}")
        check(routes_since(prev_routes) == serve_routes, f"batch {len(x)}: conv and pool "
              f"designs {routes_since(prev_routes)}, predicted {serve_routes}")
        prev = now
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for x, y in zip(requests, outs):
        lse = torch.logsumexp(y, dim=-1)
        check(y.shape == (len(x), 1000) and y.dtype == torch.float32,
              f"output {tuple(y.shape)} {y.dtype}")
        check(bool(torch.isfinite(y).all()), f"batch {len(x)}: non-finite log-probs")
        check(bool((lse.abs() < 1e-3).all()), f"batch {len(x)}: logsumexp {lse.abs().max().item():.3g}")
    phase("serve", f"batches {list(SERVE_BATCHES)}: (B, 1000) finite f32 log-probs, rows sum to 1; "
          f"launches per forward {PER_FORWARD}, total {launches}; conv and pool designs per "
          f"forward as predicted")

    # the f32 forward on the card (kernels + cuDNN without TF32) against the
    # port's plain path on the CPU, same weights: f32 summation order only,
    # carried through 34 layers, bounded relative to the log-probs' scale
    x = requests[0].repeat(2, axis=0)
    x[1] = rng.standard_normal(IMAGE_SHAPE, dtype=np.float32)
    y_gpu = Server(DEPTH, seed=0, device="cuda", compute_dtype=torch.float32).predict(x).cpu()
    y_cpu = Server(DEPTH, seed=0, device="cpu", compute_dtype=torch.float32).predict(x)
    err = (y_gpu - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    check(err <= 1e-5 * scale, f"f32 forward: card vs CPU max abs err {err:.3g} (scale {scale:.3g})")
    y_bf16 = server.predict(x).cpu()
    phase("serve", f"f32 forward on the card vs the plain CPU forward: max abs log-prob err "
          f"{err:.3g} (bound 1e-5 x {scale:.4g}); bf16 served vs f32: max abs "
          f"{(y_bf16 - y_cpu).abs().max().item():.4g}, top-1 agree "
          f"{int((y_bf16.argmax(-1) == y_cpu.argmax(-1)).sum())}/2")

    # 6 times at batch 128, bf16
    ms = dict.fromkeys(KERNELS, 0.0)
    plain_ms = dict.fromkeys(KERNELS, 0.0)
    tile_ms = dict.fromkeys(KERNELS, 0.0)  # the same launches, all through the tile design
    # one PyTorch call of the same function; conv3x3_bn_relu_in has none
    library_ms = {k: None if k == "conv3x3_bn_relu_in" else 0.0 for k in KERNELS}
    for k, ((h, w, ci, co), count) in enumerate(sorted(conv_shapes.items())):
        x, wt, b = conv_inputs(TIME_BATCH, h, w, ci, co, torch.bfloat16, seed=k)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = b.to(x.dtype)
        fns = {cuda_conv._route(x, wt): lambda: conv3x3(x, wt, b, with_stats=False),
               "plain": lambda: conv3x3_plain(x, wt, b, with_stats=False),
               "library": lambda: F.conv2d(nchw(x), w_lib, b_lib, padding=1)}
        if "sm90" in fns:
            fns["tile"] = lambda: cuda_conv._tile_forward(x, wt, b, with_stats=False)
        time_conv("conv3x3", (h, w, ci, co), count, "forward", fns, ms, plain_ms, tile_ms,
                  library_ms)
    phase("times", f"conv3x3 per batch-{TIME_BATCH} forward: kernel {ms['conv3x3']:.3f} ms "
          f"(the tile design alone {tile_ms['conv3x3']:.3f} ms), plain "
          f"{plain_ms['conv3x3']:.3f} ms, cuDNN's one call {library_ms['conv3x3']:.3f} ms")
    time_pool(pool_shapes, ms, plain_ms, library_ms)
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (TIME_BATCH, *IMAGE_SHAPE), dtype=np.float32)).cuda()
    t_fwd, s_fwd = cuda_time_ms(lambda: server.predict(images), min_reps=5)
    phase("times", f"serving forward, R-MG-{DEPTH} folded bf16, batch {TIME_BATCH}: "
          f"{t_fwd:.2f} ms (spread {s_fwd:.1%}) = {TIME_BATCH / t_fwd * 1e3:.1f} img/s on {name}")
    t_one, s_one = cuda_time_ms(lambda: server.predict(images[:1]), min_reps=5)
    phase("times", f"serving forward, batch 1: {t_one:.2f} ms per call (spread {s_one:.1%}), "
          f"back to back")
    del server, images

    check_prologue(train_shapes["conv3x3_bn_relu_in"], max_err)
    check_pool_bwd(train_shapes["maxpool2_bwd"], max_err)
    check_grads()
    train_launches = check_train(name, train_routes)
    launches = {k: launches[k] + train_launches[k] for k in KERNELS}
    time_train(name, train_shapes, ms, plain_ms, tile_ms, library_ms)

    # each kernel's bound over the pass its times sum: the serving forward
    # (conv3x3, maxpool2) or the training step (the other two)
    fwd_bounds = path_bounds(serve_shapes, TIME_BATCH)
    step_bounds = path_bounds(train_shapes, TIME_BATCH)
    bounds = {k: (fwd_bounds if PER_FORWARD[k] else step_bounds)[k] for k in KERNELS}
    for k, (flops, nbytes, t_bound, by) in bounds.items():
        lib = "none" if library_ms[k] is None else f"{library_ms[k]:.3f} ms"
        phase("bounds", f"{k} per batch-{TIME_BATCH} {'forward' if PER_FORWARD[k] else 'step'}: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB, bound {t_bound:.4f} ms (by {by}); "
              f"kernel {ms[k]:.3f} ms ({t_bound / ms[k]:.0%} of the bound), plain "
              f"{plain_ms[k]:.3f} ms, library {lib}")
    print(json.dumps({"kernels": [
        {"name": k, **KERNELS[k], "launches": launches[k], "max_abs_err": max_err[k],
         "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bounds[k][2],
         "bound_by": bounds[k][3], "library_ms": library_ms[k]} for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
