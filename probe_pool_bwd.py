#!/usr/bin/env python3
"""The pool backward's group design under other launch plans, on one CUDA card.

    python3 probe_pool_bwd.py        # from the repository root; needs one card and nvcc

Times one training step's pool backward of R-MG-34 (batch 128),
cifar/prnmg (64 x 2) and PR-MG-30 (16 x 2), every group of pools on
HBM-cold inputs (chip_smoke.py's rotation), through the group design
(`mgtpu_torch/csrc/maxpool2.cu`, section "group") built twice: with the
shipped register budget (MIN_BLOCKS = 2 blocks an SM, 128 registers a
thread) and with 3 blocks an SM (85 registers); and for each build under
five plans: the shipped one (cuda_pool._group_plan: up to two items a
thread, one resident wave of blocks), the grid as large as the tiles,
one item a thread, two items a thread, and two resident waves. Each
group is checked equal to the plain version first. The simple design
(one launch a tensor) is timed beside them. The builds go to a
temporary directory; the repository's sources are not changed. Prints
the card's name and power limit, then one line a build and plan.
"""

from __future__ import annotations

import functools
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from mgtpu_torch import kernels
from mgtpu_torch.ops import cuda_pool

NETS = {"R-MG-34": (cs.RMG34, 128, 1),
        "cifar/prnmg": (cs.cifar_opts("cifar/prnmg"), 64, 2),
        "PR-MG-30": (cs.SEG_RECIPES["ilsvrc/prnmgseg"][0], 16, 2)}


def plan_with(per_thread, grid_of):
    """A _group_plan with ``per_thread`` items a thread (None: the
    shipped choice) and a grid of grid_of(tiles, resident blocks)."""
    shipped = cuda_pool._group_plan.__wrapped__

    @functools.cache
    def plan(members, sms):
        per, _, tiles, rows = shipped(members, sms)
        if per_thread is not None:
            size = per_thread * cuda_pool.GROUP_THREADS
            counts = [-(-items // size) for items, _ in rows]
            rows = tuple((items, sum(counts[:j])) for j, (items, _) in enumerate(rows))
            per, tiles = per_thread, sum(counts)
        return per, grid_of(tiles, cuda_pool.GROUP_BLOCKS_PER_SM * sms), tiles, rows
    return plan


PLANS = {"shipped": (None, lambda tiles, resident: min(tiles, resident)),
         "grid = tiles": (None, lambda tiles, resident: tiles),
         "1 item, grid = tiles": (1, lambda tiles, resident: tiles),
         "2 items, grid = tiles": (2, lambda tiles, resident: tiles),
         "2 items, 2 waves": (2, lambda tiles, resident: min(tiles, 2 * resident))}


def step_ms(cases, fn) -> dict:
    """{net: ms of fn summed over a step's groups}, fn(xs, ys, gs)"""
    out = dict.fromkeys(NETS, 0.0)
    for (net, _), (sets, launches) in cases.items():
        timed = cs.rotating(lambda *f: fn(*cs.members(f)[:3]), sets)
        out[net] += launches * cs.device_ms([timed], 3)[0][0]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_pool_bwd: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cases = {}
    for net, (opt, batch, iters) in NETS.items():
        groups = cs.record_kernel_shapes(True, opt)["maxpool2_bwd"]
        for k, (key, count) in enumerate(sorted(groups.items())):
            flat = [t for j, shape in enumerate(key)
                    for t in cs.pool_bwd_operands((batch, *shape), 7 * k + j)]
            cases[(net, key)] = (cs.cold_copies(flat), count * iters)
    shipped_plan, text = cuda_pool._group_plan, (kernels.CSRC / "maxpool2.cu").read_text()
    shipped_line = f"constexpr int MIN_BLOCKS = {cuda_pool.GROUP_BLOCKS_PER_SM};"
    assert shipped_line in text
    tmp = Path(tempfile.mkdtemp(prefix="probe_pool_bwd_"))
    try:
        for blocks in (cuda_pool.GROUP_BLOCKS_PER_SM, 3):
            src = tmp / f"csrc{blocks}"
            shutil.copytree(kernels.CSRC, src)
            (src / "maxpool2.cu").write_text(
                text.replace(shipped_line, f"constexpr int MIN_BLOCKS = {blocks};"))
            kernels.CSRC, kernels.BUILD_DIR = src, tmp / f"build{blocks}"
            kernels.build.cache_clear()
            kernels.library.cache_clear()
            log = kernels.build()[2]
            entry = ""
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    entry = line.split("'")[1] if "'" in line else line
                if "group" in entry and ("registers" in line or "spill" in line):
                    print(f"{blocks} blocks an SM: {entry[-40:]}: {line.strip()}", flush=True)
            for name, (per_thread, grid_of) in PLANS.items():
                cuda_pool._group_plan = plan_with(per_thread, grid_of)
                for (net, key), (sets, _) in cases.items():
                    xs, ys, gs, _ = cs.members(sets[0])
                    for dx, x, y, g in zip(cuda_pool.maxpool2_backward_group(xs, ys, gs, "first"),
                                           xs, ys, gs):
                        cs.check(torch.equal(dx, cuda_pool.maxpool2_bwd_plain(x, y, g, "first")),
                                 f"{net} {key} {name}: differs from the plain version")
                ms = step_ms(cases, lambda xs, ys, gs: cuda_pool.maxpool2_backward_group(
                    xs, ys, gs, "first"))
                print(f"group, {blocks} blocks an SM, plan {name}: " + ", ".join(
                    f"{net} {t:.4f} ms" for net, t in ms.items()), flush=True)
            cuda_pool._group_plan = shipped_plan
        ms = step_ms(cases, lambda xs, ys, gs: [cuda_pool._simple_backward(x, y, g, "first")
                                                for x, y, g in zip(xs, ys, gs)])
        print("simple: " + ", ".join(f"{net} {t:.4f} ms" for net, t in ms.items()), flush=True)
    finally:
        shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
