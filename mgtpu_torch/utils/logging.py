"""Run-dir loggers (a copy of `mgtpu/utils/logging.py`) — rebuild of
optim.Logger usage: train.log / test.log / eval.log accumulate one row
per epoch (`pipelines/standard/train.lua:34,106`)."""

from __future__ import annotations

import os
import time
from typing import Dict


class EpochLogger:
    """Appends tab-separated rows with a header, optim.Logger-style.

    Columns evolve: resuming into an existing log adopts its header,
    and a row introducing NEW metric keys (e.g. switching -tenCrop on
    resume) rewrites the file with the extended header — old rows get
    nan for the new columns — instead of silently dropping the values.
    """

    def __init__(self, path: str):
        self.path = path
        self._names = None
        os.makedirs(os.path.dirname(path), exist_ok=True)

    def _rewrite(self, merged):
        """Re-header the existing file, padding old rows with nan."""
        rows = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                lines = f.read().splitlines()
            for line in lines[1:]:
                rows.append(dict(zip(self._names, line.split("\t"))))
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\t".join(merged) + "\n")
            for vals in rows:
                f.write("\t".join(vals.get(n, "nan") for n in merged) + "\n")
        os.replace(tmp, self.path)
        print(f"{self.path}: metric columns extended to {merged}")
        self._names = merged

    def add(self, row: Dict[str, float]):
        if self._names is None:
            if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
                with open(self.path) as f:  # resume: adopt the header
                    self._names = f.readline().rstrip("\n").split("\t")
            else:
                self._names = sorted(row)
                with open(self.path, "a") as f:
                    f.write("\t".join(self._names) + "\n")
        if any(k not in self._names for k in row):
            self._rewrite(sorted(set(self._names) | set(row)))
        with open(self.path, "a") as f:
            f.write("\t".join(f"{row.get(n, float('nan')):.6f}"
                              for n in self._names) + "\n")


def now() -> str:
    return time.strftime("%x %X")


def fmt_metrics(metrics: Dict[str, float], prefix: str = "") -> str:
    return " ".join(f"{prefix}{k}:{v:.5f}" for k, v in metrics.items())
