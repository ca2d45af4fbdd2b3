"""Fixtures of the benchmark's CPU tests: a copy of `portbench/` in a
temporary directory with the small test cells of `tests/data/` added
(each with the limits of the cell it stands for, or with its own where no
such cell is in the benchmark yet), and few torch threads."""

import json
import shutil
from pathlib import Path

import pytest
import torch

PB = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"


def make_root(tmp: Path) -> Path:
    root = tmp / "pb"
    shutil.copytree(PB, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for kind in ("configs", "traffic", "cells"):
        for f in (DATA / kind).glob("*.json"):
            spec = json.loads(f.read_text())
            if kind == "cells" and "limits_of" in spec:
                real = json.loads((PB / "cells" / f"{spec.pop('limits_of')}.json").read_text())
                spec["limits"] = real["limits"]
            (root / kind / f.name).write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench"))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
