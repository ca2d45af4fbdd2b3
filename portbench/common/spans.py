"""The program's own spans (`mgtpu_torch.trace`) in a traced run's
profiled slice.

The program records its spans while a ``torch.profiler`` profile runs:
through `Harness.profiled`'s untimed body and its slice. A root span is
one request (``predict`` a batch, ``group`` a saliency group), each span
counts the hand-kernel launches made while it was the innermost, and
the slice's requests are the last ``units`` roots. The spans are
drained from the program once a reading and kept on it
(``r.program_spans``). A program without the tracer records none, and
every reader of them then gives None."""

from __future__ import annotations


def program_spans(r) -> list:
    """The spans the program recorded in this process (drained once, kept
    on ``r``); none from a program without the tracer."""
    if not hasattr(r, "program_spans"):
        try:
            from mgtpu_torch import trace
        except ImportError:
            r.program_spans = []
        else:
            r.program_spans = trace.drain()
    return r.program_spans


def slice_requests(r, root: str):
    """[(root span, [its spans, itself included])] of the slice's requests:
    the last ``units`` roots named ``root``; None for an untraced run or
    where the program recorded fewer."""
    if r.profile is None:
        return None
    spans = program_spans(r)
    units = r.profile["units"]
    roots = [s for s in spans if s["parent"] is None and s["name"] == root][-units:]
    if len(roots) < units or not units:
        return None
    inside = {s["id"]: [] for s in roots}
    for s in spans:
        if s["root"] in inside:
            inside[s["root"]].append(s)
    return [(s, inside[s["id"]]) for s in roots]


def mean_ms(requests) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s, _ in requests) / len(requests) / 1e6
