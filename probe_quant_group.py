#!/usr/bin/env python3
"""The activation quantizer's group design built other ways, on one CUDA card.

    python3 probe_quant_group.py     # from the repository root; needs one card and nvcc

Builds `mgtpu_torch/csrc/quant_i8.cu` as shipped and in variants, each a
copy of the source with one choice changed: 16 members a table (its
parameter block twice the bytes), plain loads and stores instead of the
streaming hints, one item a thread at 4 and at 6 blocks an SM, two items
at 4 blocks an SM (64 registers). Each build goes to a temporary
directory and is loaded beside the port's own library; the repository's
sources are not changed. Over every quantizer group of R-MG-34's int8
serving forward at batch 128 (chip_smoke.record_kernel_shapes), with
static and with dynamic scales, every variant is first checked bit for
bit against the plain group, then all are timed in turns on the card's
clock (chip_smoke.device_ms) beside the per-part design
(quant._part_forward). Prints the card's name and power limit, each
build's ptxas lines for the group kernels, one line a group and mode,
and each variant's sum per forward with its share of the byte bound.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from mgtpu_torch import kernels
from mgtpu_torch.ops import quant

SOURCE = kernels.CSRC / "quant_i8.cu"
SHIPPED = {"members": 8, "blocks": 3, "items": 2, "stream": True}
VARIANTS = {"shipped": {}, "16 members": {"members": 16}, "no hints": {"stream": False},
            "4x1": {"blocks": 4, "items": 1}, "6x1": {"blocks": 6, "items": 1},
            "4x2": {"blocks": 4}}
STREAM = [("u[g] = __ldcs(p + g);", "u[g] = __ldg(p + g);"),
          ("__stcs(reinterpret_cast<uint4*>(y + (size_t)item * 16), q8);",
           "*reinterpret_cast<uint4*>(y + (size_t)item * 16) = q8;"),
          ("__stcs(reinterpret_cast<uint4*>(yp), q8);", "*reinterpret_cast<uint4*>(yp) = q8;")]


def source(members, blocks, items, stream) -> str:
    """The shipped source with the variant's constants (and without the
    streaming hints where ``stream`` is False)."""
    src = SOURCE.read_text()
    for name, value in (("MAX_MEMBERS", members), ("MIN_BLOCKS", blocks), ("MAX_ITEMS", items)):
        old = f"constexpr int {name} = {SHIPPED[name.split('_')[-1].lower()]};"
        assert old in src, old
        src = src.replace(old, f"constexpr int {name} = {value};")
    for hinted, plain in ([] if stream else STREAM):
        assert hinted in src, hinted
        src = src.replace(hinted, plain)
    return src


def build(tmp: Path) -> dict:
    """{variant: (its ctypes library, its settings)}, built in parallel."""
    procs = {}
    for name, change in VARIANTS.items():
        cfg = {**SHIPPED, **change}
        cu = tmp / f"v{len(procs)}.cu"
        cu.write_text(source(cfg["members"], cfg["blocks"], cfg["items"], cfg["stream"]))
        procs[name] = (cfg, cu, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cfg, cu, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = "quantize" if "group_quant" in line else "absmax" if "group_abs" in line \
                    else ""
            if entry and ("registers" in line or "spill" in line):
                print(f"{name}: group {entry} kernel: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(cu.with_suffix(".so")))
        for fn in ("mg_quant_i8_group", "mg_absmax_group"):
            getattr(lib, fn).argtypes = list(kernels._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, cfg)
    return libs


class _Use:
    """Launches of the group design through one build: its library, its
    table size and its plan's constants, restored on exit."""

    def __init__(self, lib, cfg):
        self.lib, self.cfg = lib, cfg

    def __enter__(self):
        self.saved = (kernels.library, quant._Table, quant.MAX_MEMBERS, quant.GROUP_BLOCKS_PER_SM,
                      quant.GROUP_MAX_ITEMS)

        class Table(ctypes.Structure):
            _fields_ = [("m", quant._Member * self.cfg["members"]), ("count", ctypes.c_int),
                        ("tiles", ctypes.c_int), ("per_thread", ctypes.c_int)]

        kernels.library = lambda: self.lib
        quant._Table, quant.MAX_MEMBERS = Table, self.cfg["members"]
        quant.GROUP_BLOCKS_PER_SM, quant.GROUP_MAX_ITEMS = self.cfg["blocks"], self.cfg["items"]
        quant._group_plan.cache_clear()

    def __exit__(self, *exc):
        (kernels.library, quant._Table, quant.MAX_MEMBERS, quant.GROUP_BLOCKS_PER_SM,
         quant.GROUP_MAX_ITEMS) = self.saved
        quant._group_plan.cache_clear()


def main() -> None:
    cs.check(torch.cuda.is_available(), "needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    kernels.library()
    groups = sorted(cs.record_kernel_shapes(False, cs.RMG34, int8=True)["quant_i8"].items())
    q_bytes = sum(n * cs.quant_bytes(keys, cs.TIME_BATCH) for keys, n in groups)
    bound = q_bytes / cs.PEAK_HBM_BYTES * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for mode in ("static", "dynamic"):
            total = dict.fromkeys([*libs, "per-part"], 0.0)
            for i, (keys, count) in enumerate(groups):
                members = cs.quant_members(keys, cs.TIME_BATCH, 900 + 20 * i, mode == "static")
                ref = quant.quant_i8_group_plain(members)
                fns = []
                for name, (lib, cfg) in libs.items():
                    with _Use(lib, cfg):
                        got = quant.quant_i8_group(members)
                    cs.check(all(torch.equal(a[0], b[0]) and torch.equal(
                        a[1].reshape(()), b[1].reshape(())) for a, b in zip(got, ref)),
                        f"{name} differs from the plain group at {keys}")

                    def fn(lib=lib, cfg=cfg):
                        with _Use(lib, cfg):
                            quant.quant_i8_group(members)
                    fns.append(fn)
                fns.append(lambda: [quant._part_forward(*m) for m in members])
                res = cs.device_ms(fns, windows=5)
                for name, (t, _) in zip(total, res):
                    total[name] += count * t
                print(f"{mode} group of {len(keys)} from {keys[0]} (x{count} a forward): " +
                      ", ".join(f"{name} {t * 1e3:.1f} us (spread {sp:.1%})"
                                for name, (t, sp) in zip(total, res)), flush=True)
            print(f"{mode} per batch-{cs.TIME_BATCH} R-MG-34 forward, bound {bound:.4f} ms: " +
                  ", ".join(f"{name} {t:.4f} ms ({bound / t:.1%})" for name, t in total.items()),
                  flush=True)


if __name__ == "__main__":
    main()
