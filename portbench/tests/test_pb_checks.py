"""The comparison that decides ``correct``, shown to fail: the control (the
reference one precision below the configuration's, in the program's
place) and the faults a cell can have, each on the small test cells
with the limits of the cell they stand for (the training cells, which
the benchmark does not hold yet, with their own). The control's readings
at the cells' own sizes were taken on the card (`portbench/readings.py`)."""

import json

import pytest
import torch

from conftest import make_root
from portbench import run

SEED = 2 ** 31 + 977
CELLS = ["small-train", "small-serve-bf16", "small-serve-i8", "small-saliency"]


def failing(numbers: dict, limits: dict) -> list:
    return [n for n, v in numbers.items() if n in limits and not v <= limits[n]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_and_the_control_fails(root, cell):
    h, _ = run.execute(cell, SEED, 0.2, False, readings=True, device="cpu", root=root)
    assert h.correct(), h.checks
    assert failing(h.extra["control"], h.limits), (h.extra["control"], dict(h.limits))


def _unchanged(orig):
    def step(self, images, labels, lr, wd):
        return orig(self, images, labels, 0.0, 0.0)
    return step


def _half_batch(orig):
    def step(self, images, labels, lr, wd):
        n = images.shape[0] // 2
        return orig(self, images[:n], labels[:n], lr, wd)
    return step


def _rolled_rows(orig):
    def predict(self, images):
        return orig(self, images).roll(1, 0)
    return predict


def _rolled_maps(orig):
    def call(self, x):
        valid, points, sal, *rest = orig(self, x)
        return (valid, points, sal.roll(1, 0), *rest)
    return call


def _moved_probe(orig):
    from portbench.drivers.saliency import shift_probe

    def call(self, x):
        valid, points, sal, *rest = orig(self, x)
        return (valid, shift_probe(points), sal, *rest)
    return call


def _target(name):
    from mgtpu_torch.pipelines.saliency import GroupStep
    from mgtpu_torch.serve import Server
    from mgtpu_torch.trainer import Trainer

    return {"step": (Trainer, "step"), "predict": (Server, "predict"),
            "call": (GroupStep, "__call__")}[name]


@pytest.mark.parametrize("cell, where, fault", [
    ("small-train", "step", _unchanged),
    ("small-train", "step", _half_batch),
    ("small-serve-bf16", "predict", _rolled_rows),
    ("small-serve-i8", "predict", _rolled_rows),
    ("small-saliency", "call", _rolled_maps),
    ("small-saliency", "call", _moved_probe),
], ids=["train-state-unchanged", "train-half-batch", "serve-bf16-answer-altered",
        "serve-i8-answer-altered", "saliency-answer-altered", "saliency-probe-moved"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, where, fault):
    cls, attr = _target(where)
    monkeypatch.setattr(cls, attr, fault(getattr(cls, attr)))
    with torch.inference_mode(False):
        h, _ = run.execute(cell, SEED + 1, 0.2, False, device="cpu", root=root)
    assert not h.correct(), h.checks


@pytest.mark.parametrize("cell, kept", [("small-serve-bf16", {}),
                                        ("small-saliency", {"sal_err": 1.0})])
def test_a_number_without_a_limit_is_not_correct(tmp_path, cell, kept):
    """A cell whose limits leave out a number its driver compares (or
    misspell it) reads as not correct, whatever the number."""
    root = make_root(tmp_path)
    path = root / "cells" / f"{cell}.json"
    spec = json.loads(path.read_text())
    spec["limits"] = kept
    path.write_text(json.dumps(spec))
    h, _ = run.execute(cell, SEED + 2, 0.2, False, device="cpu", root=root)
    assert not h.correct()
    assert any(lim is None for _, _, lim in h.checks), h.checks
