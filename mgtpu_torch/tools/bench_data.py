"""Host input-pipeline throughput: images/s of the full per-sample path
(decode, augment, batch assembly) of `mgtpu_torch.data`'s donkeys for a
dataset, for each worker count, independent of any device. The port's
counterpart of `tools/bench_data.py`.

Usage:
  python -m mgtpu_torch.tools.bench_data [-dataset ilsvrc] [-data synthetic|DIR]
      [-batchSize 128] [-iters 20] [-workers 1 2 4 8] [-mode thread|process]

Prints one JSON line per worker count:
  {"dataset": ..., "workers": N, "mode": ..., "images_per_sec": X, "native": true}
(``native``: the port's native library, which it always uses: a failed
build raises).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-dataset", default="ilsvrc")
    ap.add_argument("-data", default="synthetic")
    ap.add_argument("-batchSize", type=int, default=128)
    ap.add_argument("-iters", type=int, default=20)
    ap.add_argument("-workers", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("-mode", default="thread", choices=["thread", "process"])
    ap.add_argument("-synthSize", type=int, default=4096)
    ap.add_argument("-imageSize", type=int, default=256)
    ap.add_argument("-imageCrop", type=int, default=224)
    args = ap.parse_args(argv)

    from mgtpu_torch import native
    from mgtpu_torch.data import get_loaders
    from mgtpu_torch.data.prefetch import DonkeyPool

    opt = types.SimpleNamespace(
        dataset=args.dataset, data=args.data, synthSize=args.synthSize,
        synthClasses=1000, imageSize=args.imageSize, imageCrop=args.imageCrop,
        colorspace="bgr", dataAug="default", manualSeed=1, tenCrop=False,
        nEpochs=10,
    )
    loaders = get_loaders(opt)
    has_native = native.library() is not None

    for n_workers in args.workers:
        pool = DonkeyPool(n_workers, mode=args.mode, opt=opt, loaders=loaders)

        def specs():
            for it in range(args.iters):
                yield ("gen", "train", args.batchSize, 1, it, 1)

        try:
            # warm up one batch per worker (lazy imports, loader build)
            for _ in pool.imap_specs(("gen", "train", 4, 1, 999 + w, 1)
                                     for w in range(max(n_workers, 1))):
                pass
            t0 = time.perf_counter()
            n = 0
            for batch in pool.imap_specs(specs()):
                n += batch["x"].shape[0]
            dt = time.perf_counter() - t0
        finally:
            pool.shutdown()
        print(json.dumps({
            "dataset": args.dataset,
            "workers": n_workers,
            "mode": args.mode,
            "images_per_sec": round(n / dt, 1),
            "native": has_native,
        }))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
