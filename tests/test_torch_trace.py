"""The port's spans and launch counts (`mgtpu_torch.trace`): nothing is
kept while nothing records; spans nest with parent, root and times in
order, close on an exception and leave with `drain`; a CPU
`Server.predict` and a `GroupStep` call each make one root with their
phases and the multigrid layers' spans inside; each exchange up part
and single-grid ResBlock is a span of its own; a running profiler turns
recording on; and each hand-kernel launch counts into the innermost open
span as into `kernels.LAUNCHES`."""

import contextlib
import json
import types
from collections import Counter

import numpy as np
import pytest
import torch

from mgtpu_torch import kernels, trace
from mgtpu_torch.models import create_model
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.pipelines.saliency import GroupStep
from mgtpu_torch.serve import Server

MG_LAYERS = {"MgConvInput", "MgStem7x7", "MgConv", "MgResidual", "MgPool", "MgUpConv"}


@pytest.fixture(autouse=True)
def fresh():
    """No span of another test, two torch threads."""
    trace.drain()
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
    trace.drain()


def by_id(spans):
    return {s["id"]: s for s in spans}


def test_recording_off_records_nothing():
    with trace.span("predict"):
        with trace.span("forward", at=3):
            pass
    assert trace.span("predict") is trace.span("conv3x3")  # the shared no-op context
    assert trace.drain() == []


def test_nested_spans_carry_parent_root_and_order():
    with trace.recording():
        with trace.span("predict"):
            with trace.span("forward"):
                with trace.span("MgConv", at=2):
                    pass
                with trace.span("MgPool", at=3):
                    pass
        with trace.span("group"):
            pass
    spans = trace.drain()
    assert [s["name"] for s in spans] == ["MgConv", "MgPool", "forward", "predict", "group"]
    ids = {s["name"]: s for s in spans}
    predict, forward = ids["predict"], ids["forward"]
    assert predict["parent"] is None and predict["root"] == predict["id"]
    assert forward["parent"] == predict["id"] and forward["root"] == predict["id"]
    for name in ("MgConv", "MgPool"):
        assert ids[name]["parent"] == forward["id"] and ids[name]["root"] == predict["id"]
    assert (ids["MgConv"]["at"], ids["MgPool"]["at"], predict["at"]) == (2, 3, None)
    assert ids["group"]["root"] == ids["group"]["id"] != predict["id"]
    assert (predict["start_ns"] <= forward["start_ns"] <= ids["MgConv"]["start_ns"]
            <= ids["MgConv"]["end_ns"] <= ids["MgPool"]["start_ns"] <= ids["MgPool"]["end_ns"]
            <= forward["end_ns"] <= predict["end_ns"] <= ids["group"]["start_ns"])
    assert len({s["id"] for s in spans}) == len(spans)


def test_a_span_closes_on_exception():
    with trace.recording():
        with pytest.raises(ValueError):
            with trace.span("predict"):
                with trace.span("input"):
                    raise ValueError("bad images")
        with trace.span("group"):
            pass
    spans = trace.drain()
    assert [s["name"] for s in spans] == ["input", "predict", "group"]
    assert spans[2]["parent"] is None  # nothing was left open


def test_drain_empties_the_buffer():
    with trace.recording():
        for _ in range(3):
            with trace.span("conv3x3"):
                pass
    assert len(trace.drain()) == 3
    assert trace.drain() == []


def test_a_running_profiler_switches_recording_on():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("predict"):
            pass
    with trace.span("predict"):
        pass
    assert [s["name"] for s in trace.drain()] == ["predict"]


def test_chrome_events_take_the_trace_base(tmp_path):
    with trace.recording():
        with trace.span("MgConv", at=4):
            pass
    spans = trace.drain()
    base = spans[0]["start_ns"] - 5000
    trace.write_chrome(tmp_path / "spans.json", spans, base)
    doc = json.loads((tmp_path / "spans.json").read_text())
    assert doc["baseTimeNanoseconds"] == base
    (ev,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert ev["name"] == "MgConv.4" and ev["ts"] == 5.0
    assert ev["dur"] == (spans[0]["end_ns"] - spans[0]["start_ns"]) / 1e3


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_predict_is_one_root_with_its_phases_and_layers(int8):
    server = Server(NetOpts(netType="cifar/rnmg"), device="cpu", compute_dtype=torch.float32,
                    int8=int8)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3), dtype=np.float32)
    with trace.recording():
        server.predict(x)
    spans = trace.drain()
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["predict"]
    assert {s["root"] for s in spans} == {roots[0]["id"]}
    ids = by_id(spans)
    phases = [s["name"] for s in spans if s["parent"] == roots[0]["id"]]
    assert phases == ["input", "forward"]
    forward = next(s for s in spans if s["name"] == "forward")
    layers = [s for s in spans if s["name"] in MG_LAYERS]
    assert {s["name"] for s in layers} == {"MgConvInput", "MgResidual", "MgPool"}
    assert all(s["parent"] == forward["id"] for s in layers)
    in_order = sorted(layers, key=lambda s: s["start_ns"])
    assert [s["at"] for s in in_order] == list(range(len(layers)))
    names = Counter(s["name"] for s in spans)
    if int8:  # one quantize a layer's convs, under the layer, with one quant_i8 each
        quants = [s for s in spans if s["name"] == "quantize_layer"]
        assert quants and all(ids[s["parent"]]["name"] in MG_LAYERS for s in quants)
        assert names["quant_i8"] >= len(quants) and names["conv_i8"] > 0
        assert names["conv3x3"] == 0
    else:
        assert names["conv3x3"] > 0 and names["conv_i8"] == names["quantize_layer"] == 0
    assert names["maxpool2"] > 0


def test_group_step_is_one_root_with_stack_forward_and_probe():
    model = create_model(NetOpts(netType="mnist-cluttered/pnmg.mnist"),
                         generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    mask = np.zeros((2, 64, 64, 1), np.float32)
    mask[0, :8, :8] = mask[1, 8:16, 8:16] = 1.0
    loader = types.SimpleNamespace(mask=mask, expand="device", noise=mask * 0.5,
                                   meanstd=((0.1,), (0.3,)))
    step = GroupStep(model, loader, 2, dump_stack=False, device="cpu")
    with trace.recording():
        out = step(rng.random((2, 64, 64, 1), dtype=np.float32))
    assert out[2].shape == (2, 7, 64, 64, 1)
    spans = trace.drain()
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "group" and {s["root"] for s in spans} == {root["id"]}
    assert [s["name"] for s in spans if s["parent"] == root["id"]] == [
        "input", "stack", "forward", "probe"]
    forward = next(s for s in spans if s["name"] == "forward")
    inside = {s["name"] for s in spans if s["parent"] == forward["id"]}
    assert "MgConv" in inside and inside <= MG_LAYERS | set(kernels.LAUNCHES)  # and the head


def recorded_forward(opts, size=224):
    """The spans of one recorded CPU `Server.predict` of one image."""
    server = Server(opts, device="cpu", compute_dtype=torch.float32)
    x = np.random.default_rng(0).standard_normal((1, size, size, 3), dtype=np.float32)
    with trace.recording():
        server.predict(x)
    return trace.drain()


@pytest.mark.parametrize("opts, ups, blocks, wrappers", [
    (NetOpts(netType="ilsvrc/prnmgseg", depth=30, shortcutType="A"), 60, [1, 2],
     {"conv3x3": 148, "maxpool2": 24}),
    (NetOpts(), 40, [], {"conv3x3": 112, "maxpool2": 29}),
], ids=["prmg30", "rmg34"])
def test_up_parts_and_resblocks_are_spans(opts, ups, blocks, wrappers):
    """One ``conv_up3`` span an exact-2x up part (60 in PR-MG-30, 40 in
    R-MG-34), under its layer, with no hand-kernel launch; PR-MG-30's
    two prefix ResBlocks (the coarsest grid's stage) numbered with the
    multigrid layers. Neither name is a kernel's, so the wrapper spans
    that `kernel_host_us.serve` reads stay as they were (one a 3x3 conv
    part, one a pool or a layer's group of pools), and `launches.serve`'s
    counts with them."""
    spans = recorded_forward(opts)
    ids = by_id(spans)
    names = Counter(s["name"] for s in spans)
    assert names["conv_up3"] == ups
    up = [s for s in spans if s["name"] == "conv_up3"]
    assert all(ids[s["parent"]]["name"] == "MgResidual" and s["launches"] == 0 for s in up)
    res = sorted((s for s in spans if s["name"] == "ResBlock"), key=lambda s: s["start_ns"])
    assert [s["at"] for s in res] == blocks
    assert all(ids[s["parent"]]["name"] == "forward" for s in res)  # PerScale only routes
    layers = sorted((s for s in spans if s["name"] in MG_LAYERS | {"ResBlock"}),
                    key=lambda s: s["start_ns"])
    assert [s["at"] for s in layers] == list(range(len(layers)))
    assert not {"conv_up3", "ResBlock"} & set(kernels.LAUNCHES)
    assert {n: names[n] for n in kernels.LAUNCHES if names[n]} == wrappers


@pytest.mark.parametrize("opts, n", [(NetOpts(), 20),
                                     (NetOpts(netType="mnist-cluttered/pnmg.mnist"), 10),
                                     (NetOpts(netType="ilsvrc/prnmgseg", depth=30,
                                              shortcutType="A"), 15)],
                         ids=["rmg34", "pnmg.mnist", "prmg30"])
def test_layers_are_numbered_in_module_order(opts, n):
    """`number_layers` numbers the ResBlocks with the multigrid layers:
    R-MG-34 and pnmg.mnist have none, so their layers keep the numbers
    they had (0 .. n - 1 over the multigrid layers alone)."""
    from mgtpu_torch.models.common import ResBlock
    from mgtpu_torch.ops.mg import Layer

    model = create_model(opts, generator=torch.Generator().manual_seed(0))
    layers = [m for m in model.modules() if isinstance(m, Layer)]
    assert [m.at for m in layers] == list(range(n))
    blocks = [m.at for m in layers if isinstance(m, ResBlock)]
    assert blocks == ([1, 2] if opts.netType == "ilsvrc/prnmgseg" else [])


@pytest.fixture
def stub_launch(monkeypatch):
    """`kernels.launch` on the CPU: a library whose every entry returns
    success, no CUDA device or stream; the counters restored after."""
    monkeypatch.setattr(kernels, "library",
                        lambda: types.SimpleNamespace(**{e: (lambda *a: 0)
                                                         for e in kernels._SIGNATURES}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    saved = dict(kernels.LAUNCHES), dict(kernels.ROUTES), dict(kernels.PADDED)
    kernels.reset_launches()
    yield
    for counter, old in zip((kernels.LAUNCHES, kernels.ROUTES, kernels.PADDED), saved):
        counter.update(old)


def test_each_launch_counts_into_the_innermost_span_and_launches(stub_launch):
    cpu = torch.device("cpu")
    kernels.launch("conv3x3", "mg_conv3x3", cpu, route="sm90")  # nothing records
    with trace.recording():
        with trace.span("MgPool", at=1):
            kernels.launch("maxpool2", "mg_maxpool2", cpu, route="simple")
            with trace.span("maxpool2"):
                kernels.launch("maxpool2", "mg_maxpool2_sm90", cpu, route="sm90")
                kernels.launch("maxpool2", "mg_maxpool2_sm90", cpu, route="sm90")
        with trace.span("quant_i8"):
            kernels.launch("quant_i8", "mg_absmax_group", cpu, route="group")
            kernels.launch("quant_i8", "mg_quant_i8_group", cpu, route="group")
    spans = {s["name"]: s for s in trace.drain()}
    assert {n: s["launches"] for n, s in spans.items()} == {"maxpool2": 2, "MgPool": 1,
                                                           "quant_i8": 2}
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), "conv3x3": 1,
                                "maxpool2": 3, "quant_i8": 2}
    assert sum(s["launches"] for s in spans.values()) == sum(kernels.LAUNCHES.values()) - 1
    assert kernels.ROUTES[("maxpool2", "sm90")] == 2 and kernels.ROUTES[("quant_i8", "group")] == 2
