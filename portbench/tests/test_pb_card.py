"""The benchmark's command on the card: a short run of each cell prints the
contract's last line with ``correct`` true, and a checkout that holds only
`BENCHMARK.json` and `portbench/` prints no result. Run on the card with
``python -m pytest portbench/tests/test_pb_card.py``; skips without one."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import PB

REPO = PB.parent
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def command(workload, seed, seconds, trace):
    return [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(seed),
            "--seconds", str(seconds), "--trace", str(trace)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(command(cell, 2 ** 31 + 11, 2, 0), cwd=REPO, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert "setup_s" in line["metrics"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
def test_benchmark_files_alone_print_no_result(card, tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(command(CELLS[0], 2 ** 31 + 13, 1, 0), cwd=tmp_path,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
