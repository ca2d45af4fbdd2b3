"""PR-MG-30 (`configs/prmg30.json`, `reference/prmg30.py`) on the CPU: the
real configuration and cell, at 2 images a batch, served through the
program and held to its reference in f32 and bf16; a fault planted in
the reference that the comparison catches; the net's recorded sizes; and
the work of the exchange's up parts that `conv_up_roofline.serve`
divides by, with that reader's answers on synthetic slices."""

import json

import pytest

from conftest import PB, make_root
from portbench import run
from portbench.common import work, work_up
from portbench.reference import mgnet

CELL = "prmg30-serve-bf16-b1024"
SEED = 2 ** 32 + 41


@pytest.fixture
def registries(monkeypatch):
    """`mgnet`'s added nets and layer kinds, restored after the test."""
    monkeypatch.setattr(mgnet, "ADDED_NETS", dict(mgnet.ADDED_NETS))
    monkeypatch.setattr(mgnet, "KINDS", dict(mgnet.KINDS))


def small_root(tmp_path, dtype):
    """A copy of the benchmark whose `prmg30` cell runs batches of two
    images (2 resident, 2 in flight, 2 compared: a rolled answer moves
    rows) in ``dtype``."""
    root = make_root(tmp_path)
    cell = json.loads((root / "cells" / f"{CELL}.json").read_text())
    traffic = {"driver": "serve", "batch": 2, "resident": 2, "in_flight": 2, "int8": False,
               "calib_batches": 0, "calib_batch": 1, "compare_requests": 2}
    (root / "traffic" / "serve-bf16-b2s.json").write_text(json.dumps(traffic))
    (root / "cells" / f"{CELL}.json").write_text(json.dumps({**cell,
                                                             "traffic": "serve-bf16-b2s"}))
    config = json.loads((root / "configs" / "prmg30.json").read_text())
    (root / "configs" / "prmg30.json").write_text(json.dumps({**config, "dtype": dtype}))
    return root


def test_the_cell_runs_the_real_configuration():
    cell, config, traffic = run.cell_files(CELL)
    assert (cell["config"], cell["traffic"], config["net"]) == ("prmg30", "serve-bf16-b1024",
                                                                 "ilsvrc/prnmgseg")
    assert (traffic["batch"], traffic["int8"], config["dtype"]) == (1024, False, "bf16")
    assert (config["depth"], config["shortcutType"], config["reference"]) == (30, "A", "prmg30")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prmg30_serves_as_its_reference(tmp_path, registries, dtype):
    """The program's log-probs within the cell's limit; in bf16 the
    control (the reference's convs on fp8 operands) and the rolled
    answer over it, as on the card."""
    root = small_root(tmp_path, dtype)
    h, res = run.execute(CELL, SEED, 0.2, False, readings=dtype == "bf16", device="cpu",
                         root=root)
    assert h.correct(), h.checks
    err = dict((n, v) for n, v, _ in h.checks)["logit_err"]
    if dtype == "f32":
        assert err < 1e-4, err
    else:
        limit = h.limits["logit_err"]
        assert h.extra["control"]["logit_err"] > limit, h.extra
        assert h.extra["answer_altered"]["logit_err"] > limit, h.extra


def test_the_reference_without_its_up_parts_is_not_correct(tmp_path, registries, monkeypatch):
    """Every exchange's coarse-to-fine part zeroed in the reference alone:
    the comparison sees it."""
    root = small_root(tmp_path, "f32")
    monkeypatch.setattr(mgnet, "_up2", lambda x, oh, ow: x.new_zeros(
        (x.shape[0], x.shape[1], oh, ow)))
    h, _ = run.execute(CELL, SEED + 1, 0.2, False, device="cpu", root=root)
    assert not h.correct(), h.checks


def test_sizes_match_the_recorded_counts(registries):
    """PR-MG-30's parameters and multiply-adds an image, as the reference
    module counted them when it was first added as a test's new files."""
    cfg = run.load_config("prmg30")
    net = mgnet.build(cfg)
    assert mgnet.param_count(net) == 31_905_432
    assert mgnet.macs_per_image(net, (224, 224, 3)) == 9_521_356_256
    r = run.Reading(cfg, {"driver": "serve"}, {"rate": 1.0, "dispatch": [], "work": {}}, None)
    assert r.macs_per_image() == 9_521_356_256


def test_up_parts_and_their_bound(registries):
    """40 up parts in R-MG-34 and 60 in PR-MG-30. R-MG-34's bound at 1,024
    a batch in bf16 (2 bytes; 989 TFLOP/s, 3.35 TB/s), each part
    (oh, ow, ci, co) x its count: operations 2 B (2 oh - 2)(2 ow - 2) ci co,
    bytes 2 (B oh/2 ow/2 ci + 9 ci co + B oh ow co):

        (14, 14, 16, 64)   x 1:  1.418 GFLOP,  27.314 MB ->   8.153 us (bytes)
        (14, 14, 32, 64)   x 7:  2.835 GFLOP,  28.938 MB ->   8.638 us (bytes)
        (14, 14, 96, 256)  x 1: 34.024 GFLOP, 112.837 MB ->  34.403 us (operations)
        (14, 14, 128, 256) x 11: 45.366 GFLOP, 116.195 MB ->  45.870 us (operations)
        (28, 28, 16, 32)   x 6:  3.058 GFLOP,  57.812 MB ->  17.257 us (bytes)
        (28, 28, 32, 128)  x 1: 24.461 GFLOP, 218.440 MB ->  65.206 us (bytes)
        (28, 28, 64, 128)  x 7: 48.922 GFLOP, 231.358 MB ->  69.062 us (bytes)
        (56, 56, 32, 64)   x 6: 50.751 GFLOP, 462.459 MB -> 138.047 us (bytes)

    summed: 8.153 + 60.47 + 34.40 + 504.57 + 103.54 + 65.21 + 483.44 +
    828.28 = 2,088.1 us a batch."""
    rmg = mgnet.conv_shapes(mgnet.rnmg(34, 1000), (224, 224, 3))
    prmg = mgnet.conv_shapes(mgnet.build(run.load_config("prmg30")), (224, 224, 3))
    assert len(work_up.up_parts(rmg)) == 40
    assert len(work_up.up_parts(prmg)) == 60
    f, b = work_up.up_work((56, 56, 32, 64), 1024)
    assert (round(f / 1e9, 3), round(b / 1e6, 3)) == (50.751, 462.459)
    assert work.bound(*work_up.up_work((14, 14, 128, 256), 1024), work.PEAK["bf16"])[1] == (
        "operations")
    assert round(work_up.up_bound(rmg, 1024, "bf16")[2] * 1e6, 1) == 2088.1
    # the least work is under what `_conv_up3`'s 4 taps a pixel compute
    taps = sum(2 * 1024 * 4 * oh * ow * ci * co for oh, ow, ci, co in work_up.up_parts(prmg))
    assert work_up.up_bound(prmg, 1024, "bf16")[0] < taps


READER = run.load_module(PB / "metrics" / "conv_up_roofline.serve.py")


def synthetic(config, n_up, units=2, int8=False, traced=True, dgrad_s=0.01):
    """A reading of ``config``'s serving slice: ``units`` predicts, each
    with ``n_up`` `conv_up3` spans, and ``dgrad_s`` of dgrad kernels."""
    cfg = run.load_config(config)
    spans = []
    for k in range(units + 1):  # a warm-up request, then the slice's
        r = 1000 * (k + 1)
        spans += [{"name": "conv_up3", "id": r + j + 1, "parent": r, "root": r, "at": None,
                   "start_ns": 0, "end_ns": 1, "launches": 0} for j in range(n_up)]
        spans.append({"name": "predict", "id": r, "parent": None, "root": r, "at": None,
                      "start_ns": 0, "end_ns": 2, "launches": 0})
    profile = {"units": units, "by_name": {"sm80_xmma_dgrad_implicit_gemm_bf16": dgrad_s,
                                           "conv3x3_sm90_kernel": 1.0}}
    r = run.Reading(cfg, {"driver": "serve", "int8": int8},
                    {"rate": 1.0, "dispatch": [], "work": {"kind": "serve", "batch": 1024}},
                    profile if traced else None)
    r.program_spans = spans
    return r


def test_the_up_roofline_reads_the_bound_over_the_dgrad_time(registries):
    r = synthetic("rmg34", 40)
    bound = work_up.up_bound(r.convs(), 1024, "bf16")[2]
    assert READER.read(r) == pytest.approx(100 * bound * 2 / 0.01)
    assert READER.read(synthetic("prmg30", 60)) > 0


@pytest.mark.parametrize("case", ["int8", "untraced", "no-spans", "spans-short",
                                  "no-kernels"])
def test_the_up_roofline_gives_none_where_it_cannot_cover_what_ran(registries, case):
    r = {"int8": lambda: synthetic("rmg34", 40, int8=True),
         "untraced": lambda: synthetic("rmg34", 40, traced=False),
         "no-spans": lambda: synthetic("rmg34", 0),  # a program without the span
         "spans-short": lambda: synthetic("prmg30", 40),
         "no-kernels": lambda: synthetic("rmg34", 40, dgrad_s=0.0)}[case]()
    assert READER.read(r) is None
