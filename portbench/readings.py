"""The readings a cell's limits are set from: for each seed, in one
process, a short run of the cell (its own sizes and load) with the
numbers the program's window gives against the reference, and beside
them the control's (the reference one precision below the configuration
states, in the program's place) and each fault's the driver plants.

    python3 -m portbench.readings --workload <cell> --seconds 3 --seeds <n> [<n> ...]

One JSON line a seed. The benchmark's runs never run this.
"""

import argparse
import gc
import json
import sys

import torch

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        h, res = run.execute(args.workload, seed, args.seconds, False, readings=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": {n: v for n, v, _ in h.checks}, **h.extra,
                          "rate": res["rate"], "setup_s": h.setup_s}), flush=True)
        del h, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
