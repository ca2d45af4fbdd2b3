#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`mgtpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card and nvcc

Builds the port's CUDA kernels from `mgtpu_torch/csrc/`, holds each one
against its plain PyTorch version at the shapes R-MG-34 gives it, serves
a few requests through `mgtpu_torch.serve.Server` (R-MG-34, BN folded,
bf16, seeded random weights), checks that the forward went through the
kernels and agrees with the port's plain CPU path in f32, and times the
kernels and the serving forward with CUDA events. Phases:

  1 device   the card, and its name and power limit from nvidia-smi
  2 build    nvcc over mgtpu_torch/csrc/*.cu, bound with ctypes
  3 conv3x3  kernel vs conv3x3_plain at every (H, W, Ci, Co) of the slice,
             batch 8, bf16 and f32, relu_out and with_stats on and off
  4 maxpool2 kernel vs maxpool2_plain, exact, with odd sizes, NaN and -inf
  5 serve    batches of 1, 8 and 32 images: shape, finiteness, rows that
             are distributions, exactly 112 conv3x3 and 46 maxpool2
             launches per forward; the f32 forward on the card vs the
             plain forward on the CPU
  6 times    each kernel vs its plain version (cuDNN) at batch 128 bf16,
             the serving forward in images/s at batch 128 bf16, and its
             time per call at batch 1

Any failed check exits non-zero. The second-to-last line of stdout is
one JSON object with the kernels (their launches in phase 5, the largest
error of phases 3-4, and ``ms`` / ``plain_ms``: the summed time of one
batch-128 bf16 forward's launches of that kernel and of its plain
version); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from collections import Counter

import numpy as np
import torch

from mgtpu_torch import kernels
from mgtpu_torch.ops import cuda_conv, resample
from mgtpu_torch.ops.cuda_conv import conv3x3, conv3x3_plain
from mgtpu_torch.ops.cuda_pool import maxpool2, maxpool2_plain
from mgtpu_torch.serve import IMAGE_SHAPE, Server

DEPTH = 34
# launches per R-MG-34 forward (one per 3x3 same/down part; every
# maxpool2_ceil of the exchange and the MgPools)
PER_FORWARD = {"conv3x3": 112, "maxpool2": 46}
KERNELS = {
    "conv3x3": dict(route="cuda", source="mgtpu_torch/csrc/conv3x3.cu",
                    replaces="mgtpu/ops/pallas_conv.py:220"),
    "maxpool2": dict(route="cuda", source="mgtpu_torch/csrc/maxpool2.cu",
                     replaces="mgtpu/ops/pallas_pool.py:63"),
}
CHECK_BATCH, TIME_BATCH = 8, 128
SERVE_BATCHES = (1, 8, 32)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def record_kernel_shapes():
    """One R-MG-34 f32 forward at batch 1 on the CPU (the plain path),
    recording the input shape of every conv3x3 and maxpool2 call."""
    convs, pools = [], []
    orig_conv, orig_pool = cuda_conv.conv3x3, resample.maxpool2

    def rec_conv(x, w, b, **kw):
        convs.append((x.shape[1], x.shape[2], x.shape[3], w.shape[3]))
        return orig_conv(x, w, b, **kw)

    def rec_pool(x):
        pools.append(tuple(x.shape[1:]))
        return orig_pool(x)

    server = Server(DEPTH, seed=0, device="cpu", compute_dtype=torch.float32)
    cuda_conv.conv3x3, resample.maxpool2 = rec_conv, rec_pool
    try:
        server.predict(np.zeros((1, *IMAGE_SHAPE), np.float32))
    finally:
        cuda_conv.conv3x3, resample.maxpool2 = orig_conv, orig_pool
    return Counter(convs), Counter(pools)


def conv_inputs(n, h, w, ci, co, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, ci), dtype=np.float32))
    wt = torch.from_numpy(rng.standard_normal((3, 3, ci, co), dtype=np.float32) / np.sqrt(9 * ci))
    b = torch.from_numpy(0.1 * rng.standard_normal(co, dtype=np.float32))
    return x.cuda().to(dtype), wt.cuda().to(dtype), b.cuda()


def pool_input(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    x[0, 0, 0, 0] = np.nan
    x[0, -1, -1, -1] = np.inf
    x[-1, :2, :2, :] = -np.inf  # a window of -inf only
    x[-1, -1, -1, -1] = np.nan  # in a clipped edge window when H or W is odd
    return torch.from_numpy(x).cuda().to(dtype)


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

    conv_shapes, pool_shapes = record_kernel_shapes()
    check(sum(conv_shapes.values()) == PER_FORWARD["conv3x3"]
          and sum(pool_shapes.values()) == PER_FORWARD["maxpool2"],
          f"the CPU forward made {sum(conv_shapes.values())} conv3x3 and "
          f"{sum(pool_shapes.values())} maxpool2 calls, expected {PER_FORWARD}")
    max_err = {"conv3x3": 0.0, "maxpool2": 0.0}

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
                    y, st = conv3x3(x, wt, b, relu_out=relu_out, with_stats=with_stats)
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
    phase("conv3x3", f"{n_cases} cases at {len(conv_shapes)} shapes, batch {CHECK_BATCH}: match "
          f"the plain version (max abs err {max_err['conv3x3']:.3g}; largest error "
          f"{worst[torch.bfloat16]:.2f} of its bound in bf16, {worst[torch.float32]:.2f} in f32)")

    # 4 maxpool2 vs plain: a max selects one input, so exact, NaN included
    shapes = [(CHECK_BATCH, *s) for s in sorted(pool_shapes)]
    shapes += [(2, 7, 9, 3), (3, 15, 14, 130), (1, 1, 1, 4), (2, 57, 55, 64)]
    for k, shape in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            x = pool_input(shape, dtype, seed=k)
            y, y_ref = maxpool2(x), maxpool2_plain(x)
            torch.cuda.synchronize()
            check(y.shape == y_ref.shape, f"maxpool2 {shape} {dtype}: shape {tuple(y.shape)}")
            same = (y == y_ref) | (torch.isnan(y) & torch.isnan(y_ref))
            err = torch.where(same, 0.0, (y.float() - y_ref.float()).abs().nan_to_num(float("inf")))
            max_err["maxpool2"] = max(max_err["maxpool2"], err.max().item())
            check(bool(same.all()), f"maxpool2 {shape} {dtype}: differs from the plain version")
    phase("maxpool2", f"{2 * len(shapes)} cases (bf16 and f32; odd sizes, NaN, +-inf): "
          f"equal to the plain version")

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
        outs.append(server.predict(x))
        now = dict(kernels.LAUNCHES)
        got = {k: now[k] - prev[k] for k in now}
        check(got == PER_FORWARD, f"batch {len(x)}: kernel launches {got}, expected {PER_FORWARD}")
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
          f"launches per forward {PER_FORWARD}, total {launches}")

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
    ms = {"conv3x3": 0.0, "maxpool2": 0.0}
    plain_ms = {"conv3x3": 0.0, "maxpool2": 0.0}
    for k, ((h, w, ci, co), count) in enumerate(sorted(conv_shapes.items())):
        x, wt, b = conv_inputs(TIME_BATCH, h, w, ci, co, torch.bfloat16, seed=k)
        t_k, s_k = cuda_time_ms(lambda: conv3x3(x, wt, b, with_stats=False))
        t_p, s_p = cuda_time_ms(lambda: conv3x3_plain(x, wt, b, with_stats=False))
        ms["conv3x3"] += count * t_k
        plain_ms["conv3x3"] += count * t_p
        tflops = 2 * TIME_BATCH * h * w * 9 * ci * co / t_k / 1e9
        phase("times", f"conv3x3 {TIME_BATCH}x{h}x{w}x{ci}->{co} (x{count}/forward): kernel "
              f"{t_k:.4f} ms (spread {s_k:.1%}, {tflops:.1f} TFLOP/s), plain {t_p:.4f} ms "
              f"(spread {s_p:.1%})")
    for k, ((h, w, c), count) in enumerate(sorted(pool_shapes.items())):
        x = pool_input((TIME_BATCH, h, w, c), torch.bfloat16, seed=k)
        t_k, s_k = cuda_time_ms(lambda: maxpool2(x))
        t_p, s_p = cuda_time_ms(lambda: maxpool2_plain(x))
        ms["maxpool2"] += count * t_k
        plain_ms["maxpool2"] += count * t_p
        gbs = 2 * TIME_BATCH * c * (h * w + -(-h // 2) * -(-w // 2)) / t_k / 1e6
        phase("times", f"maxpool2 {TIME_BATCH}x{h}x{w}x{c} (x{count}/forward): kernel {t_k:.4f} ms "
              f"(spread {s_k:.1%}, {gbs:.0f} GB/s), plain {t_p:.4f} ms (spread {s_p:.1%})")
    for kname in ms:
        phase("times", f"{kname} per batch-{TIME_BATCH} forward: kernel {ms[kname]:.3f} ms, "
              f"plain {plain_ms[kname]:.3f} ms")
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (TIME_BATCH, *IMAGE_SHAPE), dtype=np.float32)).cuda()
    t_fwd, s_fwd = cuda_time_ms(lambda: server.predict(images), min_reps=5)
    phase("times", f"serving forward, R-MG-{DEPTH} folded bf16, batch {TIME_BATCH}: "
          f"{t_fwd:.2f} ms (spread {s_fwd:.1%}) = {TIME_BATCH / t_fwd * 1e3:.1f} img/s on {name}")
    t_one, s_one = cuda_time_ms(lambda: server.predict(images[:1]), min_reps=5)
    phase("times", f"serving forward, batch 1: {t_one:.2f} ms per call (spread {s_one:.1%}), "
          f"back to back")

    print(json.dumps({"kernels": [
        {"name": k, **KERNELS[k], "launches": launches[k], "max_abs_err": max_err[k],
         "ms": ms[k], "plain_ms": plain_ms[k]} for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
