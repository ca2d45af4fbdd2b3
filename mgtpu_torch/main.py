"""Entry point of the port (counterpart of `mgtpu/main.py`, the rebuild
of the reference's `main.lua` + `run.lua`); takes the JAX CLI's flags:

    python -m mgtpu_torch.main -netType cifar/nmg -dataset cifar100-whitened \\
        -data synthetic -nLayer 2 -train -test ... [-device cpu]

Boot order as `main.lua:36-58`: parse the options (two-stage), seed
Python's, numpy's and torch's generators, make the run dir and write
``opts.json``, build the Session (net, model, SGD state, loaders, donkey
pool, steps), run the pipeline ``-pipeline`` names (the standard one, or
with ``saliency`` the saliency harness as epoch 1, `run.lua:1-33`), and
at the end, also on an error, wait for a pending checkpoint write and
shut the donkey pool down. Runs on ``-device`` (default cuda)."""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch


def main(argv=None):
    """Run the options ``argv`` (default: the command line) give, and
    return the Session."""
    from mgtpu_torch.utils.opts import parse

    opt = parse(argv)
    random.seed(opt.manualSeed)
    np.random.seed(opt.manualSeed)
    torch.manual_seed(opt.manualSeed)

    os.makedirs(opt.save, exist_ok=True)
    with open(os.path.join(opt.save, "opts.json"), "w") as f:
        json.dump(vars(opt), f, indent=2, default=str)
    print(f"==> run dir: {opt.save}")

    from mgtpu_torch.pipelines import saliency, standard
    from mgtpu_torch.utils.checkpoint import join_pending_saves

    sess = standard.Session(opt)
    # shut down in finally: an exception mid-run must not leave
    # process-mode donkeys alive
    try:
        if opt.pipeline == "saliency":
            sess.epoch = 1
            saliency.run(sess)
        else:
            standard.run(sess)
    finally:
        try:
            # don't exit under an in-flight checkpoint write; re-raises a
            # background write failure (ENOSPC, ...)
            join_pending_saves()
        finally:
            # a failed write must not skip the pool's teardown
            sess.pool.shutdown()
    return sess


if __name__ == "__main__":
    main()
