"""Run a launch-script recipe as a CHAIN of resuming processes: the
port's counterpart of `tools/soak_chain.py`, chaining ``python -m
mgtpu_torch.main`` processes where the JAX tool chains ``sh <recipe>``
(every recipe under scripts/ calls the JAX package's main).

The recipe's argv is taken from its ``.sh`` (`recipe_argv`: its
``${NAME:-default}`` resolved from the environment as ``sh`` resolves
it); each chunk runs it through the framework's own
``-retrain``/``-epochNumber``/``-stopAfter`` resume, with the recipe's
``-nEpochsSave`` overridden to the chunk size so every chunk ends on a
checkpoint. A chunk over its wall budget (``SOAK_CHUNK_BUDGET_S``,
default 5400 s) is killed with its whole process group and the next
chunk resumes from its last checkpoint; a chunk that saves no new
checkpoint ends the chain. Run dirs accumulate under the one --cache
root (one stamped dir per chunk); chain.log summarizes. Extra args after
``--`` go to every chunk, after the recipe's (so ``-- -device cpu`` runs
the chain on the CPU; without it the port runs on the card).

    python -m mgtpu_torch.tools.soak_chain scripts/mnist-cluttered/prnmg.mnist.sh \\
        --cache runs/full_x --epochs 200 --chunk 25 [--deadline-ts T] \\
        [-- extra recipe args...]

Imports neither torch nor the JAX package (the chunks do import torch).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path


def recipe_argv(path, env=os.environ) -> list:
    """The ``python -m mgtpu.main ...`` argv of a recipe under scripts/,
    each ``${NAME:-default}`` resolved from ``env`` as ``sh`` resolves it
    (the default where NAME is unset or empty) and the trailing ``"$@"``
    dropped; the script is not run."""
    body = Path(path).read_text()
    m = re.search(r"python -m mgtpu\.main(.*)", body, re.S)
    if m is None:
        raise ValueError(f"{path}: no `python -m mgtpu.main` invocation")
    txt = re.sub(r"\$\{(\w+):-([^}]*)\}", lambda v: env.get(v[1]) or v[2],
                 m.group(1).replace("\\\n", " "))
    return [t for t in txt.split() if t != '"$@"']


def find_latest_ckpt(cache_root: str):
    ckpts = glob.glob(os.path.join(cache_root, "**", "model_*.ckpt"), recursive=True)
    best = None
    for c in ckpts:
        m = re.search(r"model_(\d+)\.ckpt$", c)
        if m:
            e = int(m.group(1))
            if best is None or e > best[0] or (e == best[0] and
                                               os.path.getmtime(c) > best[2]):
                best = (e, c, os.path.getmtime(c))
    return (best[0], best[1]) if best else (0, None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("recipe")
    ap.add_argument("--cache", required=True)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--deadline-ts", type=float, default=None,
                    help="unix time after which no new chunk starts")
    ap.add_argument("rest", nargs="*", help="extra recipe args (after --)")
    args = ap.parse_args(argv)

    os.makedirs(args.cache, exist_ok=True)
    log_path = os.path.join(args.cache, "chain.log")
    recipe = recipe_argv(args.recipe)

    def log(msg):
        line = f"{time.strftime('%m/%d %H:%M:%S')} {msg}"
        print(line, flush=True)
        with open(log_path, "a") as f:
            f.write(line + "\n")

    while True:
        done, ckpt = find_latest_ckpt(args.cache)
        if done >= args.epochs:
            log(f"chain complete: epoch {done}/{args.epochs}")
            return 0
        if args.deadline_ts and time.time() > args.deadline_ts:
            log(f"deadline reached at epoch {done}/{args.epochs}; stopping")
            return 0
        start = done + 1
        end = min(done + args.chunk, args.epochs)
        cmd = [sys.executable, "-m", "mgtpu_torch.main", *recipe,
               "-cache", args.cache,
               "-nEpochs", str(args.epochs),
               "-epochNumber", str(start),
               "-stopAfter", str(end),
               "-nEpochsSave", str(args.chunk)]
        if ckpt:
            cmd += ["-retrain", ckpt]
        cmd += args.rest
        log(f"chunk: epochs {start}..{end} "
            f"(resume {os.path.basename(ckpt) if ckpt else 'fresh'})")
        # budget: generous per-chunk wall bound so one wedged chunk
        # cannot eat the chain; a killed chunk resumes from its last
        # checkpoint on the next iteration
        budget = int(os.environ.get("SOAK_CHUNK_BUDGET_S", 5400))
        t0 = time.time()
        with open(os.path.join(args.cache, f"chunk_{start:03d}.txt"), "w") as f:
            # own session so a timeout kills the whole tree (the main
            # process, its data-parallel ranks and donkeys)
            p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                 start_new_session=True)
            try:
                rc = p.wait(timeout=budget)
            except subprocess.TimeoutExpired:
                # the group can exit between the timeout and the kill:
                # a vanished group is success, not a chain-fatal error
                def killpg(sig):
                    try:
                        os.killpg(p.pid, sig)
                    except ProcessLookupError:
                        pass

                killpg(signal.SIGTERM)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    killpg(signal.SIGKILL)
                    p.wait()
                rc = 124
        new_done, _ = find_latest_ckpt(args.cache)
        log(f"chunk rc={rc} wall={time.time() - t0:.0f}s "
            f"ckpt-epoch {done} -> {new_done}")
        if new_done <= done:
            log("no forward progress; aborting chain")
            return 1


if __name__ == "__main__":
    sys.exit(main())
