"""The profiled slice of a traced run, read from `torch.profiler`'s trace.

The profiler records the device's activity alone (CUDA, not the host's
ops: recording every host op slowed R-MG-34's dispatch of a step by 58%,
the device's alone by 24%). The trace is written by the profiler's own
exporter and read as JSON: the kernels, copies and sets inside the
slice, whose ends and the benchmark's host spans (which label the
device's idle gaps) are taken on the host's wall clock; an event's time
on that clock is the trace's ``baseTimeNanoseconds`` plus its ``ts``."""

from __future__ import annotations

import json
import os

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Trace:
    def __init__(self, tmpdir):
        self.path = os.path.join(tmpdir, f"portbench_trace_{os.getpid()}.json")
        self.trace = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.path)
            try:
                with open(self.path) as f:
                    self.trace = json.load(f)
            finally:
                os.remove(self.path)
        return False

    def summary(self, slice_ns, spans):
        return summarise(self.trace, slice_ns, spans)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(trace, slice_ns, spans, top=10):
    """{window_s, busy_s, by_name {device op: seconds}, device_ops, idle_gaps}
    of the slice ``slice_ns`` (host wall-clock ns); ``spans`` [(name, start
    ns, end ns)] label each idle gap by the innermost one around it."""
    base = float(trace.get("baseTimeNanoseconds", 0))
    s0, s1 = slice_ns
    dev, by_name = [], {}
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t = base + float(e["ts"]) * 1e3
        a, b = max(t, s0), min(t + float(e.get("dur", 0)) * 1e3, s1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) / 1e9
    busy = _merge(dev)
    gaps, t = [], s0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < s1:
        gaps.append((t, s1))

    def label(a, b):
        mid = (a + b) / 2
        inner = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        return min(inner)[1] if inner else "host"

    labelled = sorted(((label(a, b), (b - a) / 1e9) for a, b in gaps), key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (s1 - s0) / 1e9, "busy_s": sum(b - a for a, b in busy) / 1e9,
            "by_name": by_name,
            "device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in labelled[:top]]}


def class_seconds(by_name, patterns):
    """Device seconds of the ops whose names contain any of ``patterns``."""
    return sum(s for n, s in by_name.items() if any(p in n for p in patterns))

