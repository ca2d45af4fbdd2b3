"""The program's spans (`mgtpu_torch.trace`) and the profiler's device
trace share one clock: in a traced serving slice, each hand kernel's
launch on the host (its runtime event, linked to the kernel by the
trace's correlation id) falls inside the entry span of the kernel's
wrapper; and ``launches.serve`` is the slice's `kernels.LAUNCHES` delta
over its batches. Run on the card with ``python -m pytest
portbench/tests/test_pb_clock.py -s`` (it prints the worst offset);
skips without one."""

import pytest

from portbench import run
from portbench.common import trace as pb_trace
from portbench.common.harness import Harness

# a hand kernel's name (csrc/*.cu) -> its wrapper's span names; the first match
WRAPPERS = (("maxpool2_bwd", ("maxpool2_bwd",)), ("maxpool2_", ("maxpool2",)),
            ("conv_i8_", ("conv_i8",)), ("conv3x3_", ("conv3x3", "conv3x3_bn_relu_in")),
            ("quant_kernel", ("quant_i8",)), ("absmax_kernel", ("quant_i8",)))


def wrapper_of(kernel: str):
    return next((names for part, names in WRAPPERS if part in kernel), None)


def launch_offsets(trace: dict, spans: list) -> list:
    """[(kernel, ns outside its wrapper's nearest span, 0 inside)] for each
    hand kernel launched in ``trace``."""
    base = float(trace.get("baseTimeNanoseconds", 0))
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("cat") != "cuda_runtime":
            continue
        names = wrapper_of(kernels.get(e.get("args", {}).get("correlation"), ""))
        if names is None:
            continue
        a = base + float(e["ts"]) * 1e3
        b = a + float(e.get("dur", 0)) * 1e3
        mine = [s for s in spans if s["name"] in names]
        off = min((max(s["start_ns"] - a, b - s["end_ns"], 0.0) for s in mine),
                  default=float("inf"))
        out.append((kernels[e["args"]["correlation"]], off))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rmg34-serve-i8-b1024", "rmg34-serve-bf16-b1024"])
def test_hand_kernel_launches_fall_inside_their_wrapper_spans(card, monkeypatch, cell):
    from mgtpu_torch import kernels, trace

    seen = {}
    summarise, profiled = pb_trace.summarise, Harness.profiled

    def keep(tr, slice_ns, spans, **kw):
        seen["trace"] = tr
        return summarise(tr, slice_ns, spans, **kw)

    def counted(self, body):
        def slice_body(warm):
            before = sum(kernels.LAUNCHES.values())
            units = body(warm=warm)
            if not warm:
                seen["launches"] = sum(kernels.LAUNCHES.values()) - before
            return units
        return profiled(self, slice_body)

    monkeypatch.setattr(pb_trace, "summarise", keep)
    monkeypatch.setattr(Harness, "profiled", counted)
    trace.drain()
    h, res = run.execute(cell, 2 ** 31 + 29, 2, True)
    r = run.Reading(h.config, h.traffic, res, h.profile)
    metrics = run.per_layer(r)
    assert metrics["launches.serve"]["value"] == seen["launches"] / h.profile["units"]
    offsets = launch_offsets(seen["trace"], r.program_spans)  # the warm body's and the slice's
    inside = sum(off == 0 for _, off in offsets)
    worst = max(offsets, key=lambda k: k[1])
    print(f"{cell}: {inside} of {len(offsets)} hand-kernel launches inside their wrapper "
          f"spans; worst offset {worst[1] / 1e3:.3f} us ({worst[0][:80]})")
    assert len(offsets) >= seen["launches"] > 0
    assert inside >= 0.99 * len(offsets)
