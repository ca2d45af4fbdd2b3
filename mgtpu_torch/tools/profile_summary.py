"""Sum the card's time in a ``torch.profiler`` trace by category: the
port's counterpart of `tools/profile_summary.py`.

Companion to ``-profile DIR`` (`mgtpu_torch/pipelines/standard.py`:
iterations 2..9 of the first epoch, written to ``DIR/trace.json``).
Only device events are summed, the kernels, copies and sets on the
card's timeline, never the host's ops (``key_averages()``' sums count a
kernel launched by a torch op twice). Categories: each of the port's
kernels by its name (``conv3x3``, ``conv3x3_bn_relu_in``, ``maxpool2``,
``maxpool2_bwd``, ``conv_i8``, ``quant_i8``), cuDNN convs, BN and
elementwise (PyTorch's own kernels), collectives (NCCL), copies
(memcpy and memset) and other. The idle share is the part of the window,
from the first device event's start to the last one's end, in which no
device event runs.

Usage:
  python -m mgtpu_torch.tools.profile_summary <profile_dir> [--top N] [--steps K]

<profile_dir> is the directory passed to -profile (or the trace file).
Durations are summed over the whole capture; --steps divides by the
number of steps it holds (8 for -profile).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_PRO = re.compile(r"conv3x3_\w+_kernel<([^>]*)>")


def find_trace(profile_dir: str) -> str:
    if os.path.isfile(profile_dir):
        return profile_dir
    for pat in (os.path.join(profile_dir, "trace.json"), os.path.join(profile_dir, "**", "*.json")):
        hits = sorted(glob.glob(pat, recursive=True))
        if hits:
            return hits[-1]
    raise FileNotFoundError(f"no trace.json under {profile_dir}")


def device_events(trace: dict):
    """The complete events on the card's timeline: kernels, copies, sets."""
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            yield ev


def category(ev: dict) -> str:
    name = ev.get("name", "")
    if ev.get("cat") != "kernel":
        return "copies"
    if "conv3x3" in name:  # the last template argument is the BN-ReLU prologue
        m = _PRO.search(name)
        pro = m is not None and m.group(1).split(",")[-1].strip() == "true"
        return "conv3x3_bn_relu_in" if pro else "conv3x3"
    if "maxpool2_bwd" in name:
        return "maxpool2_bwd"
    if "maxpool2" in name:
        return "maxpool2"
    if "conv_i8" in name:
        return "conv_i8"
    if "quant_kernel" in name or "absmax_kernel" in name:
        return "quant_i8"
    if "nccl" in name.lower():
        return "collectives"
    if any(k in name.lower() for k in ("conv", "dgrad", "wgrad", "fprop", "cudnn", "implicit")):
        return "cuDNN convs"
    if "at::native" in name or "elementwise" in name or "reduce" in name:
        return "BN/elementwise"
    return "other"


def busy_us(events) -> tuple[float, float]:
    """(the union of the events' intervals, the window from the first
    start to the last end), in microseconds."""
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
                   for ev in events)
    if not spans:
        return 0.0, 0.0
    busy, (start, end) = 0.0, spans[0]
    window = (spans[0][0], max(e for _, e in spans))
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    return busy, window[1] - window[0]


def summarize(trace: dict) -> dict:
    """{"by_category", "by_kernel" (Counters of us), "total", "busy",
    "window" (us), "events"}."""
    evs = list(device_events(trace))
    by_cat, by_op = collections.Counter(), collections.Counter()
    for ev in evs:
        dur = float(ev.get("dur", 0.0))
        by_cat[category(ev)] += dur
        by_op[ev.get("name", "?")] += dur
    busy, window = busy_us(evs)
    return {"by_category": by_cat, "by_kernel": by_op, "total": sum(by_cat.values()),
            "busy": busy, "window": window, "events": len(evs)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("profile_dir")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--steps", type=int, default=0,
                    help="divide totals by this step count for per-step ms")
    args = ap.parse_args(argv)

    path = find_trace(args.profile_dir)
    with open(path) as f:
        s = summarize(json.load(f))
    div = args.steps if args.steps else 1
    unit = "ms/step" if args.steps else "ms total"
    total = s["total"]
    print(f"trace: {path}")
    if not s["events"]:
        print("device time: 0.00 (the trace holds no device events: a run without a card)")
        return
    idle = 1 - s["busy"] / s["window"] if s["window"] else 0.0
    print(f"device time: {total / 1000 / div:.2f} {unit} in {s['events']} events; the card "
          f"busy {s['busy'] / 1000 / div:.2f} {unit} of a {s['window'] / 1000 / div:.2f} "
          f"{unit} window, idle {idle:.1%}\n")
    print(f"{'category':40s} {unit:>10s}  share")
    for cat, dur in s["by_category"].most_common():
        print(f"{cat:40s} {dur / 1000 / div:10.2f}  {dur / total:6.1%}")
    print(f"\ntop individual kernels ({unit}):")
    for op, dur in s["by_kernel"].most_common(args.top):
        print(f"  {dur / 1000 / div:8.2f}  {op[:90]}")


if __name__ == "__main__":
    main()
