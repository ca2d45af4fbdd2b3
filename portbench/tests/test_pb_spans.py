"""The readers of the program's spans (`common/spans.py`, the
``predict_ms``, ``group_ms``, ``launches`` and ``kernel_host_us``
metrics): None for an untraced run, for another driver and for a
program that recorded no spans; the right number from a synthetic
profile, over the slice's requests alone; and, in a traced CPU run of the
small serving and saliency cells, a number read from the program
itself."""

import types

import pytest
import torch

from conftest import PB

from portbench import run
from portbench.common import trace as pb_trace

READERS = {name: run.load_module(PB / "metrics" / f"{name}.py")
           for name in ("predict_ms.serve", "group_ms.saliency", "launches.serve",
                        "kernel_host_us.serve")}
DRIVER = {"predict_ms.serve": "serve", "group_ms.saliency": "saliency", "launches.serve": "serve",
          "kernel_host_us.serve": "serve"}


def span(id, name, start_us, end_us, parent=None, root=None, launches=0):
    return {"name": name, "id": id, "parent": parent, "root": id if root is None else root,
            "at": None, "start_ns": int(start_us * 1e3), "end_ns": int(end_us * 1e3),
            "launches": launches}


def requests(root):
    """A warm-up request, then the slice's two: each a root with an input
    phase, a forward, a layer and two hand-kernel entries inside."""
    out = []
    for k, t in enumerate((0, 1000, 3000)):
        r = 10 * (k + 1)
        out += [span(r + 1, "input", t, t + 10, r, r),
                span(r + 3, "conv3x3", t + 20, t + 30, r + 4, r, launches=1),
                span(r + 5, "quant_i8", t + 40, t + 60, r + 4, r, launches=2),
                span(r + 4, "MgConv", t + 15, t + 80, r + 2, r, launches=0),
                span(r + 2, "forward", t + 12, t + 90 * (k + 1), r, r),
                span(r, root, t, t + 100 * (k + 1))]
    return out


def reading(driver, spans, units=2, profile=True):
    return types.SimpleNamespace(driver=driver, program_spans=spans,
                                 profile={"units": units} if profile else None)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_none_where_there_is_nothing_to_read(name):
    mod, driver = READERS[name], DRIVER[name]
    root = "predict" if driver == "serve" else "group"
    other = "saliency" if driver == "serve" else "serve"
    assert mod.read(reading(driver, requests(root), profile=False)) is None  # untraced
    assert mod.read(reading(other, requests(root))) is None
    assert mod.read(reading(other, requests("predict" if root == "group" else "group"))) is None
    assert mod.read(reading(driver, [])) is None  # a program without the tracer
    assert mod.read(reading(driver, requests(root), units=4)) is None  # fewer than the slice's


def test_the_readers_take_the_slice_requests_alone():
    serve, sal = reading("serve", requests("predict")), reading("saliency", requests("group"))
    assert READERS["predict_ms.serve"].read(serve) == pytest.approx((0.2 + 0.3) / 2)
    assert READERS["group_ms.saliency"].read(sal) == pytest.approx(0.25)
    assert READERS["launches.serve"].read(serve) == 3.0
    assert READERS["kernel_host_us.serve"].read(serve) == pytest.approx(15.0)  # 4 calls, 60 us


def test_the_spans_are_drained_from_the_program_once():
    from mgtpu_torch import trace

    trace.drain()
    with trace.recording():
        for _ in range(3):
            with trace.span("predict"):
                with trace.span("conv3x3"):
                    pass
    r = types.SimpleNamespace(driver="serve", profile={"units": 2})
    assert READERS["launches.serve"].read(r) == 0.0
    assert READERS["kernel_host_us.serve"].read(r) > 0
    assert len(r.program_spans) == 6 and trace.drain() == []


class CpuTrace:
    """The profiled slice on the CPU: `torch.profiler` over the host's ops
    (the benchmark's records the card alone), no device events."""

    def __init__(self, tmpdir):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def summary(self, slice_ns, spans):
        return {"window_s": (slice_ns[1] - slice_ns[0]) / 1e9, "busy_s": 0.0, "by_name": {},
                "device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("cell, names", [
    ("small-serve-i8", ("predict_ms.serve", "launches.serve", "kernel_host_us.serve")),
    ("small-saliency", ("group_ms.saliency",))])
def test_a_traced_cpu_run_reads_the_program(root, monkeypatch, cell, names):
    from mgtpu_torch import trace

    trace.drain()
    monkeypatch.setattr(pb_trace, "Trace", CpuTrace)
    h, res = run.execute(cell, 2 ** 33 + 5, 0.2, True, device="cpu", root=root)
    metrics = run.per_layer(run.Reading(h.config, h.traffic, res, h.profile, root))
    assert {n for n in READERS if n in metrics} == set(names)
    if cell == "small-serve-i8":
        assert metrics["launches.serve"]["value"] == 0.0  # the CPU takes the plain paths
        assert metrics["kernel_host_us.serve"]["value"] > 0
        # each predict span inside the harness's dispatch span around it
        slice_dispatch = h.spans["dispatch"][-h.profile["units"]:]
        assert metrics["predict_ms.serve"]["value"] <= sum(slice_dispatch) / len(
            slice_dispatch) * 1e3
