"""What every run of a cell shares: the seed's generators, the host spans
the benchmark records around its calls into the program, the numbers
compared with the reference and their limits, the context lines, and
the profiled slice of a traced run."""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch

from portbench.common import trace


class Harness:
    """One run: ``seed``, ``seconds``, ``tracing``; ``config`` and
    ``traffic`` are the cell's files. Drivers call `setup_done` when the
    first timed request is due, and `compare` for each number checked
    against the reference."""

    def __init__(self, cell, config, traffic, seed, seconds, tracing, t0, device, readings=False,
                 marks=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.tracing = seed, seconds, tracing
        self.t0, self.device, self.readings = t0, torch.device(device), readings
        self.spans = defaultdict(list)
        self.limits = {}  # the cell's: {name: limit}
        self.checks = []  # (name, value, limit or None)
        self.extra = {}  # readings of the control and the faults (readings mode)
        self.check_s = 0.0
        self.setup_s = None
        self.marks = dict(marks or {})  # set-up's stages: {name: seconds from process start}
        self.profile = None
        self._host_spans = None  # while profiling: [(name, start ns, end ns)]
        self.tmp = tempfile.gettempdir()
        # the configuration's precision for the program's f32 convs: "tf32"
        # allows TF32 in cuDNN (PyTorch's default), "f32" does not
        torch.backends.cudnn.allow_tf32 = config["dtype"] != "f32"
        self.mark("cuda")

    # --- inputs ---------------------------------------------------------
    def generator(self, stream=0):
        """A generator on the device for ``stream`` of this seed."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1000003 + stream) % (2 ** 63))
        return g

    # --- time -----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name):
        """Host time of the block under ``name``; in the profiled slice also
        on the wall clock, to label the device's idle gaps."""
        t, ns = time.perf_counter(), time.time_ns()
        yield
        self.spans[name].append(time.perf_counter() - t)
        if self._host_spans is not None:
            self._host_spans.append((name, ns, time.time_ns()))

    @contextlib.contextmanager
    def checking(self):
        """Work done during set-up only for the comparison (snapshots of
        the program's state): not counted in ``setup_s``."""
        t = time.perf_counter()
        yield
        self.check_s += time.perf_counter() - t

    def mark(self, stage):
        """The end of a stage of set-up, for the context lines."""
        self.sync()
        self.marks[stage] = time.perf_counter() - self.t0

    def setup_done(self):
        self.mark("warm")
        self.setup_s = time.perf_counter() - self.t0 - self.check_s
        self.spans.clear()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self):
        """(the window's start, a function that tells whether it is over)."""
        start = time.perf_counter()
        return start, lambda: time.perf_counter() - start >= self.seconds

    def profiled(self, body):
        """Run ``body(warm)`` under the profiler: once untimed (a trace can
        miss a call's first kernels), then as the slice, which ends when
        the device has; its device events go into ``self.profile``, with
        the units of work (steps, batches, groups) the slice ran."""
        if not self.tracing:
            return
        with trace.Trace(self.tmp) as tr:
            body(warm=True)
            self.sync()
            self._host_spans = []
            try:
                t0 = time.time_ns()
                units = body(warm=False)
                self.sync()
                t1 = time.time_ns()
                spans = self._host_spans
            finally:
                self._host_spans = None
        self.profile = tr.summary((t0, t1), spans)
        self.profile["units"] = units

    # --- correctness ----------------------------------------------------
    def compare(self, name, value):
        """``value`` of ``name`` against the cell's limit for it; a number
        the cell gives no limit reads as not correct."""
        limit = self.limits.get(name)
        self.checks.append((name, float(value), None if limit is None else float(limit)))

    def correct(self):
        return bool(self.checks) and all(lim is not None and math.isfinite(v) and v <= lim
                                         for _, v, lim in self.checks)

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- reporting ------------------------------------------------------
    @staticmethod
    def info(**kv):
        print("portbench " + json.dumps(kv), flush=True)


@contextlib.contextmanager
def exact_f32(tf32_convs=False):
    """f32 convs and products without TF32, as the references compute;
    with ``tf32_convs`` the convs in TF32, as a "tf32" configuration allows."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_convs, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def card_context():
    """The card's name, power limit, clocks, draw and temperature, and the
    host's CPU, for the lines before the result."""
    out = {}
    try:
        q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        out["nvidia_smi"] = r.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    try:  # the first processor's identity (its model name may read "unknown")
        with open("/proc/cpuinfo") as f:
            first = f.read().split("\n\n")[0]
        fields = {k.strip(): v for k, v in (ln.split(":", 1) for ln in first.splitlines()
                                            if ":" in ln)}
        out["cpu"] = " / ".join(fields[k].strip() for k in ("vendor_id", "cpu family", "model",
                                                            "model name") if k in fields)
    except OSError:
        out["cpu"] = "unknown"
    out["cpus"] = os.cpu_count()
    out["torch"] = torch.__version__
    out["python"] = sys.version.split()[0]
    return out


def percentile(values, q):
    """The q-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def norm_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between two norms: max |prog - ref| over
    max(ref, the median leaf's ref), over the leaves ``keep`` (all by
    default); with the leaf it is at."""
    names = list(ref if keep is None else keep)
    med = sorted(ref[k] for k in ref)[len(ref) // 2] if ref else 0.0
    worst, at = 0.0, ""
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst:
            worst, at = g, k
    return worst, at
