"""Serving traffic: `mgtpu_torch.serve.Server.predict` in a closed loop
with ``in_flight`` batches outstanding (batch i + 1 is submitted before
batch i's log-probs are read to the host), on resident batches of f32
images cycled. A request is due when it is submitted; its latency ends
when its log-probs are on the host.

The Server loads the benchmark's weights from an mgtpu-ckpt and folds
its BatchNorms; with ``int8`` it quantizes, and with ``calib_batches``
its activation scales are calibrated (`mgtpu_torch.ops.quant.calibrate`)
on seeded batches of ``calib_batch`` images that the reference is given
too. After the window a sample of the requests, drawn from the seed, is
compared with the reference: every row of each, by the relative error of
its log-probs up to the row's constant (log-softmax's shift).

Traffic keys: batch, resident, in_flight, int8, calib_batches,
calib_batch, compare_requests."""

from __future__ import annotations

import random
import time
from collections import deque

import torch

from portbench.common import inputs
from portbench.common.harness import exact_f32, percentile
from portbench.reference import mgnet

DTYPES = {"bf16": torch.bfloat16, "tf32": torch.float32, "f32": torch.float32}


def logit_error(got, ref):
    """The widest row's relative error of log-probs (B, classes), each row
    centred first: ||(got - ref) - mean|| / ||ref - mean(ref)||."""
    d = got.double() - ref.double()
    d = d - d.mean(1, keepdim=True)
    r = ref.double() - ref.double().mean(1, keepdim=True)
    return float((d.norm(dim=1) / r.norm(dim=1)).max())


def reference(net, params, stats, x, quant, rows=256):
    """The reference's log-probs of x, in blocks of ``rows``."""
    with torch.no_grad(), exact_f32():
        return torch.cat([mgnet.forward(net, params, stats, x[i:i + rows], "eval", quant)
                          for i in range(0, x.shape[0], rows)])


def run(h):
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.ops.quant import calibrate
    from mgtpu_torch.serve import Server

    h.mark("imported")
    cfg, tr = h.config, h.traffic
    net = mgnet.build(cfg)
    shape = tuple(cfg["image_shape"])
    B, R, depth = tr["batch"], tr["resident"], tr["in_flight"]
    params, stats = inputs.weights(h, net)
    g = h.generator(1)
    xs = torch.randn((R, B, *shape), generator=g, device=h.device)
    calib = [torch.randn((tr["calib_batch"], *shape), generator=g, device=h.device)
             for _ in range(tr["calib_batches"])]
    h.mark("inputs")
    with inputs.checkpoint(h, params, stats, cfg["opts"]) as path:
        server = Server(NetOpts(**cfg["opts"]), ckpt=path, device=h.device,
                        compute_dtype=DTYPES[cfg["dtype"]], int8=tr["int8"])
    if tr["int8"] and calib:
        calibrate(server.model, calib)
    h.mark("built")

    outputs, latency = {}, []
    queue = deque()

    def submit(i):
        due = time.perf_counter()
        with h.span("dispatch"):
            queue.append((i, due, server.predict(xs[i % R])))

    def read():
        i, due, y = queue.popleft()
        with h.span("readback"):
            out = y.cpu()
        latency.append(time.perf_counter() - due)
        return i, out

    for i in range(depth + 1):  # warm-up: the window's shapes and pattern
        submit(i)
        if len(queue) == depth:
            read()
    while queue:
        read()
    h.setup_done()
    latency.clear()

    start, over = h.window()
    i = 0
    while not over():
        submit(i)
        i += 1
        if len(queue) == depth:
            j, out = read()
            outputs[j] = out
    while queue:
        j, out = read()
        outputs[j] = out
    wall = time.perf_counter() - start
    rate = len(outputs) * B / wall
    lat = list(latency)
    failed = sum(not torch.isfinite(o).all() for o in outputs.values())

    def body(warm):
        n = depth + 1 if warm else 5
        for k in range(n):
            submit(k)
            if len(queue) == depth:
                read()
        while queue:
            read()
        return n

    dispatch = list(h.spans["dispatch"])
    h.profiled(body)
    peak = torch.cuda.max_memory_allocated(h.device) if h.device.type == "cuda" else 0
    h.info(window_requests=len(outputs), window_s=wall, latency_samples=len(lat),
           latency_p50_ms=percentile(lat, 50) * 1e3, latency_max_ms=max(lat) * 1e3)
    del server, queue
    h.free()

    picks = random.Random(h.seed).sample(sorted(outputs), min(tr["compare_requests"],
                                                              len(outputs)))
    quant = None
    if tr["int8"]:
        quant = mgnet.calibrate_quant(net, params, stats, calib, mgnet.Quant("int8"))
    ref = {r % R: reference(net, params, stats, xs[r % R], quant) for r in picks}
    got = torch.cat([outputs[r] for r in picks])
    want = torch.cat([ref[r % R] for r in picks]).cpu()
    h.compare("logit_err", logit_error(got, want))
    if h.readings:  # the control: one precision below the configuration's
        low = (mgnet.calibrate_quant(net, params, stats, calib, mgnet.Quant("int4"))
               if tr["int8"] else mgnet.Quant("fp8"))
        ctrl = torch.cat([reference(net, params, stats, xs[r % R], low) for r in picks]).cpu()
        rolled = torch.cat([outputs[r].roll(1, 0) for r in picks])
        h.extra = {"control": {"logit_err": logit_error(ctrl, want)},
                   "answer_altered": {"logit_err": logit_error(rolled, want)}}
    return {"attempted": len(outputs), "failed": int(failed), "peak": peak,
            "dispatch": dispatch,
            "metrics": {"serve_img_s": (rate, "img/s"),
                        "serve_p95_ms": (percentile(lat, 95) * 1e3, "ms")},
            "rate": rate, "work": {"kind": "serve", "batch": B}}
