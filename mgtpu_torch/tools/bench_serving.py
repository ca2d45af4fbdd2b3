"""Serving latency/throughput sweep for the flagship R-MG-34 forward,
through `mgtpu_torch.serve.Server.predict`: the port's counterpart of
`tools/bench_serving.py`.

  python -m mgtpu_torch.tools.bench_serving [--int8] [--no-fold-bn] [--batches 1 8 32 128]

One JSON line per (dtype, batch) row: the p50 latency of 10
individually synced calls and the throughput of CHUNK back-to-back calls
with one sync, bf16 and with ``--int8`` int8 calibrated-static (the
``-int8 -int8Calib`` path: one batch of 8 seeded normal images), each
row with the card's name and power limit. Both include the host's
dispatch, which sets the pace of this forward on the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mgtpu_torch.tools import card, sync

CHUNK = 20


def measure(fwd, x, device):
    """(p50 latency in s of individually synced calls, images/s over
    CHUNK back-to-back calls)."""
    for _ in range(3):
        fwd(x)
    sync(device)
    lats = []
    for _ in range(10):
        t0 = time.perf_counter()
        fwd(x)
        sync(device)
        lats.append(time.perf_counter() - t0)
    lats.sort()
    p50 = lats[len(lats) // 2]
    t0 = time.perf_counter()
    for _ in range(CHUNK):
        fwd(x)
    sync(device)
    return p50, CHUNK * x.shape[0] / (time.perf_counter() - t0)


def servers(device, int8: bool, fold_bn: bool):
    """[(dtype label, Server)]: bf16, and with ``int8`` the int8 one with
    static scales from one seeded batch of 8 images."""
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.ops.quant import calibrate
    from mgtpu_torch.serve import Server

    opt = NetOpts(depth=34)
    out = [("bf16", Server(opt, device=device, fold_bn=fold_bn))]
    if int8:
        server = Server(opt, device=device, int8=True, fold_bn=fold_bn)
        rng = np.random.default_rng(3)
        calibrate(server.model, [rng.standard_normal((8, 224, 224, 3), dtype=np.float32)])
        out.append(("int8-static", server))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--no-fold-bn", action="store_true",
                    help="measure the unfolded eval graph instead of the BN-folded serving "
                         "graph mgtpu_torch.tools.export_model exports by default")
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 8, 32, 128])
    ap.add_argument("-device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    where = card(device)
    folded = not args.no_fold_bn
    for name, server in servers(device, args.int8, folded):
        for b in args.batches:
            x = torch.randn((b, 224, 224, 3), generator=torch.Generator().manual_seed(1))
            x = x.to(device, torch.float32 if server.int8 else server.compute_dtype)
            p50, thr = measure(server.predict, x, device)
            print(json.dumps({
                "dtype": name, "batch": b, "folded": folded,
                "p50_latency_ms": round(p50 * 1e3, 3),
                "throughput_img_s": round(thr, 1), **where,
            }), flush=True)


if __name__ == "__main__":
    main()
