"""Spans and launch counts inside the port, on the host's wall clock.

A span is a named interval of the host's time inside the program:

- a request's entry: ``predict`` (`serve.Server.predict`) and ``group``
  (`pipelines.saliency.GroupStep`); its phases ``input``, ``stack``,
  ``forward`` and ``probe``;
- a multigrid layer's forward (`ops/mg.py`: ``MgConvInput``,
  ``MgStem7x7``, ``MgConv``, ``MgResidual``, ``MgPool``, ``MgUpConv``)
  and a single-grid residual block's (``ResBlock``,
  `models.common.ResBlock`), with its position in the net (``at``,
  `ops.mg.number_layers`), and a layer's int8 quantize
  (``quantize_layer``, `nn.quantize_layer`);
- an exchange conv's "up" part at exactly twice its grid
  (``conv_up3``, `nn._conv_up3`): the 4x4 kernel's build and the
  stock transposed conv, with no hand kernel and so outside
  `kernels.LAUNCHES`;
- the public entry of each hand kernel, under the kernel's name in
  `kernels.LAUNCHES`: its checks, route, plan or table, output and
  launch.

Each closed span keeps its name, ``id``, ``parent`` (the enclosing
span's id), ``root`` (the outermost open span's id: one a request), its
start and end in ``time.time_ns()`` and its own ``launches``: the hand
kernel launches (`kernels.launch`) made while it was the innermost open
span.

Recording is off by default, and ``span`` then costs one check and
returns a shared no-op context. It is on inside `recording` and while a
``torch.profiler`` profile runs (the benchmark's traced slice, the run
loop's ``-profile``): the profiler's trace places the device's events on
the same clock (its ``baseTimeNanoseconds`` plus an event's ``ts``), so
each idle gap on the card can be put down to the span the host was in.
`drain` returns the closed spans and forgets them; nothing is written
on the way. One thread records at a time: the program's dispatch runs
on one, and a backward's spans (autograd's thread) while it waits.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time

import torch.autograd.profiler as _profiler

_recording = 0  # open recording() blocks
_open: list = []  # the open spans, the innermost last
_closed: list = []  # closed spans, in the order they closed
_ids = itertools.count(1)


class _Off:
    """The span of a site while nothing records."""

    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, kind, value, tb):
        pass


_OFF = _Off()


class Span:
    """One open or closed span; its id is given when it is drained."""

    __slots__ = ("name", "at", "id", "parent", "start", "end", "launches")

    def __init__(self, name: str, at):
        self.name, self.at, self.id, self.launches = name, at, None, 0

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self)
        self.start = time.time_ns()

    def __exit__(self, kind, value, tb):
        self.end = time.time_ns()
        _closed.append(_open.pop())


def span(name: str, at: int | None = None):
    """A context for the block named ``name`` (``at``: a layer's position
    in the net); the shared no-op one while nothing records."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, at)


@contextlib.contextmanager
def recording():
    """Record spans inside the block (with no profiler running too)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def count_launch() -> None:
    """One hand-kernel launch, into the innermost open span's count."""
    if _open:
        _open[-1].launches += 1


def drain() -> list[dict]:
    """The spans closed since the last drain, in the order they closed,
    as dicts (name, id, parent, root, at, start_ns, end_ns, launches);
    forgets them."""
    def ident(s):
        if s.id is None:
            s.id = next(_ids)
        return s.id

    out = []
    for s in _closed:
        root = s
        while root.parent is not None:
            root = root.parent
        out.append({"name": s.name, "id": ident(s),
                    "parent": None if s.parent is None else ident(s.parent), "root": ident(root),
                    "at": s.at, "start_ns": s.start, "end_ns": s.end, "launches": s.launches})
    _closed.clear()
    return out


def write_chrome(path: str, spans: list[dict], base_ns: int) -> None:
    """``spans`` (`drain`'s) as Chrome-trace complete events at ``path``,
    ``ts`` in us from ``base_ns`` (a ``torch.profiler`` trace's
    ``baseTimeNanoseconds``): its events and these share one clock, and
    their ``traceEvents`` lists put together open as one timeline."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "mgtpu_torch spans"}}]
    for s in spans:
        label = s["name"] if s["at"] is None else f"{s['name']}.{s['at']}"
        events.append({"ph": "X", "cat": "mgtpu_torch", "name": label, "pid": pid, "tid": 0,
                       "ts": (s["start_ns"] - base_ns) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": {k: s[k] for k in ("id", "parent", "root", "launches")}})
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns, "traceEvents": events}, f)
