"""The harness's own rules: what it imports, that it runs only on a card,
and that cells, configurations and metrics are found by name."""

import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import PB, make_root

REPO = PB.parent


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: `mgtpu_torch` is not `mgtpu`."""
    for path in PB.rglob("*.py"):
        assert not imported_tops(path) & {"jax", "jaxlib", "flax", "mgtpu"}, path
    for path in (PB / "reference").rglob("*.py"):
        assert "mgtpu_torch" not in imported_tops(path), path


def test_the_port_loads_no_jax():
    code = ("import portbench.run as r, mgtpu_torch.trainer, mgtpu_torch.serve, "
            "mgtpu_torch.pipelines.saliency, mgtpu_torch.models, mgtpu_torch.ops.quant; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_forbidden_check_compares_whole_names():
    from portbench import run

    sys.modules["mgtpu_torch_probe_module"] = sys
    try:
        assert "mgtpu" not in run.forbidden_modules()
    finally:
        del sys.modules["mgtpu_torch_probe_module"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "rmg34-serve-bf16-b1024", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_cells_match_the_benchmark():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = set()
    for w in bench["workloads"]:
        cell = json.loads((PB / "cells" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"],
                                                                   w["chips"])
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        names.add(w["name"])
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        if "reference" in cfg:
            assert (PB / "reference" / f"{cfg['reference']}.py").is_file(), cfg["reference"]
    for m in bench["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert set(m["workloads"]) <= names
    assert names == {p.stem for p in (PB / "cells").glob("*.json")}


def test_no_two_reference_modules_register_one_name():
    """Each net and layer kind is built into `mgnet` or registered by one
    reference module."""
    from portbench import run
    from portbench.reference import mgnet

    nets, kinds = list(mgnet.NETS), list(mgnet.BUILT_IN_KINDS)
    for path in sorted((PB / "reference").glob("*.py")):
        if path.stem not in ("__init__", "mgnet"):
            mod = run.load_module(path)
            nets += list(getattr(mod, "NETS", {}))
            kinds += list(getattr(mod, "KINDS", {}))
    assert len(nets) == len(set(nets)), nets
    assert len(kinds) == len(set(kinds)), kinds


def test_a_net_found_nowhere_names_its_configuration():
    from portbench.reference import mgnet

    with pytest.raises(ValueError, match="'cfg-x'.*'no/such-net'"):
        mgnet.build({"name": "cfg-x", "net": "no/such-net"})
    with pytest.raises(ValueError, match="unknown layer 'no-such-kind'"):
        mgnet.shape_tree([{"type": "no-such-kind"}])
    with pytest.raises(ValueError, match="built in"):
        mgnet.register({"ilsvrc/rnmg": None}, {})
    with pytest.raises(ValueError, match="built in"):
        mgnet.register({}, {"classifier": None})


@pytest.mark.parametrize("config, macs", [("rmg34", 5_760_277_760),
                                          ("pnmg-mnist", 1_585_304_064)])
def test_a_reading_counts_the_work_from_the_reference(config, macs):
    """mfu's multiply-adds come from the reference's layer list, not from a
    number in the configuration's file."""
    from portbench import run

    cfg = run.load_json("configs", config)
    assert "macs_per_image" not in cfg
    r = run.Reading(cfg, {"driver": "serve"}, {"rate": 1.0, "dispatch": [], "work": {}}, None)
    assert r.macs_per_image() == macs


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


# case -> (configuration, its reference module under `tests/data/reference`
# or None, the reference's multiply-adds an image): R-MG-18, a net that
# `mgnet.NETS` holds, and PR-MG-30, a net and two layer kinds it lacks
NEW_NETS = {
    "rmg18": ({"net": "ilsvrc/rnmg", "depth": 18, "classes": 1000, "image_shape": [224, 224, 3],
               "dtype": "tf32", "opts": {"netType": "ilsvrc/rnmg", "depth": 18}},
              None, 2_768_082_176),
    "prmg30": ({"net": "ilsvrc/prnmgseg", "reference": "prmg30_new", "depth": 30,
                "shortcutType": "A", "classes": 1000, "image_shape": [224, 224, 3],
                "dtype": "tf32",
                "opts": {"netType": "ilsvrc/prnmgseg", "depth": 30, "shortcutType": "A"}},
               "prmg30_new", 9_521_356_256),
}


@pytest.fixture
def registries(monkeypatch):
    """`mgnet`'s added nets and layer kinds, restored after the test."""
    from portbench.reference import mgnet

    monkeypatch.setattr(mgnet, "ADDED_NETS", dict(mgnet.ADDED_NETS))
    monkeypatch.setattr(mgnet, "KINDS", dict(mgnet.KINDS))


def add_new_cell(root: Path, case: str, source: str = None) -> str:
    """The files of a new cell of ``case`` in ``root``: its configuration,
    its reference module (``source``, by default the one in
    `tests/data/reference`) where it brings one, a traffic mix, the cell
    and a per-layer metric. Returns the cell's name."""
    config, module, _ = NEW_NETS[case]
    name = f"{case}-new"
    (root / "configs" / f"{name}.json").write_text(json.dumps(config))
    if module is not None:
        source = source or (PB / "tests" / "data" / "reference" / f"{module}.py").read_text()
        (root / "reference" / f"{module}.py").write_text(source)
    (root / "traffic" / "serve-f32-b1.json").write_text(json.dumps(
        {"driver": "serve", "batch": 1, "resident": 2, "in_flight": 2, "int8": False,
         "calib_batches": 0, "calib_batch": 1, "compare_requests": 1}))
    (root / "cells" / f"{name}-serve.json").write_text(json.dumps(
        {"config": name, "traffic": "serve-f32-b1", "chips": 1,
         "limits": {"logit_err": 1e-3}}))
    (root / "metrics" / "window_rate.serve.py").write_text(
        'UNIT = "img/s"\n\n\ndef read(r):\n    return r.rate if r.driver == "serve" else None\n')
    return f"{name}-serve"


@pytest.mark.parametrize("case", list(NEW_NETS))
def test_a_cell_config_and_metric_are_added_as_files_only(tmp_path, registries, case):
    """A new configuration, traffic mix, cell and per-layer metric, and for
    a net that `mgnet` lacks its reference module, added as new files to a
    copy: the run finds them by name, mfu reads the new net's work, and no
    file that was there changes."""
    from portbench import run
    from portbench.common.work import PEAK

    root = make_root(tmp_path)
    before = digest(root)
    cell = add_new_cell(root, case)
    h, res = run.execute(cell, 2 ** 32 + 3, 0.3, False, device="cpu", root=root)
    assert h.correct(), h.checks
    metrics = run.per_layer(run.Reading(h.config, h.traffic, res, None, root))
    assert metrics["window_rate.serve"]["value"] == res["rate"]
    assert "dispatch_ms.serve" in metrics and "dispatch_ms.train" not in metrics
    macs = NEW_NETS[case][2]
    assert metrics["mfu.serve"]["value"] == pytest.approx(100 * 2 * macs * res["rate"]
                                                          / PEAK["tf32"], rel=1e-12)
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) == len(before) + 4 + (NEW_NETS[case][1] is not None)


@pytest.mark.parametrize("by", ["out[at] = h + short", "out[at] = torch.relu(h)"],
                         ids=["relu-dropped", "shortcut-dropped"])
def test_a_new_kind_is_what_the_comparison_runs(tmp_path, registries, by):
    """The new module's `resblock` with its ReLU or its shortcut left out:
    the reference runs that forward, and the run is not correct."""
    from portbench import run

    source = (PB / "tests" / "data" / "reference" / "prmg30_new.py").read_text()
    good = "out[at] = torch.relu(h + short)"
    assert source.count(good) == 1
    root = make_root(tmp_path)
    cell = add_new_cell(root, "prmg30", source.replace(good, by))
    h, _ = run.execute(cell, 2 ** 32 + 5, 0.3, False, device="cpu", root=root)
    assert not h.correct(), h.checks


def test_the_trace_summary_reads_busy_time_and_labels_gaps():
    from portbench.common.trace import summarise

    base = 1_000_000_000
    events = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0.0, "dur": 100.0},
              {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50.0, "dur": 100.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400.0, "dur": 100.0},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.0,
               "dur": 900.0}]
    trace = {"baseTimeNanoseconds": base, "traceEvents": events}
    ns = lambda us: base + int(us * 1e3)  # noqa: E731
    s = summarise(trace, (ns(-100), ns(600)), [("dispatch", ns(140), ns(420)),
                                               ("readback", ns(-100), ns(600))])
    assert s["window_s"] == pytest.approx(700e-6)
    assert s["busy_s"] == pytest.approx(250e-6)  # k1 and k2 overlap; the copy
    assert s["by_name"]["k2"] == pytest.approx(100e-6)
    assert s["idle_gaps"][0] == ["dispatch", pytest.approx(250e-6)]
    assert [g[0] for g in s["idle_gaps"]] == ["dispatch", "readback", "readback"]
