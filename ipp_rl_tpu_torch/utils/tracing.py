"""The port's spans and counters: one tracer, in memory.

``span(name)`` marks a stretch of the host's work as one layer's: a
planner's run, a sweep, a commit, a search's descent.  The tracer is off
by default.  Off, ``span`` reads one module flag and returns one shared
no-op context: no allocation, no CUDA event, no device call.  After
``enable()`` each span appends a record (:class:`Span`) to a list in
memory: its name, its own id, the id of the span open around it (its
parent), the id of its request (every span of one outermost ``plan.run``
shares one; spans outside a run have none), and the host's start and end
on ``time.time_ns()``.  That is CLOCK_REALTIME, the clock
``torch.profiler`` stamps its host and device events with, so a profile
of the same stretch can be read against the spans.  Where CUDA is
available a record also holds two CUDA events recorded on the current
stream at enter and exit; nothing waits for them until ``snapshot()``,
which synchronises once and gives each span the stream's wall time
between them (``device_ms``: the device's work and the host's gaps in
between).  A span records no self time: a reader takes it as the span's
duration less what its child spans cover.

``count(name, n)`` adds ``n`` to a host-side integer counter.  Counters
count whether the tracer is on or not, and take only integers the host
already holds: counting never reads the device.  The kernel wrappers count
their launches as ``kernel.<name>`` (``ops/kernels.launch_counts``).

The spans are neither ``torch.profiler.record_function`` ranges nor NVTX
ranges.  The profiler draws a ``record_function`` range on the device's
timeline as well as the host's, so a coarse range, such as a whole planner
run, would read as device work from its first kernel to its last in any
busy time taken as the union of the profile's device intervals.

The tracer is one per process and not thread-safe: spans nest on one
host thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional

import torch

#: the span that opens a request
REQUEST = "plan.run"


@dataclasses.dataclass(slots=True)
class Span:
    """One span: ids, and the host's interval in ns on ``time.time_ns()``."""

    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None  # None while open
    device_ms: Optional[float] = None  # between its CUDA events, after a snapshot
    events: Optional[list] = None  # [start, end] CUDA events until a snapshot reads them


class Snapshot(NamedTuple):
    spans: List[Span]  # the closed spans, in the order they opened
    counters: Dict[str, int]


_on = False
_cuda = False
_OFF = contextlib.nullcontext()
_spans: List[Span] = []
_open: List[Span] = []
_counters: Dict[str, int] = {}
_ids = {"span": 0, "request": 0}


class _Recorded:
    """The context of one span while the tracer is on."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        outer = _open[-1] if _open else None
        _ids["span"] += 1
        request = outer.request if outer is not None else None
        if request is None and self.name == REQUEST:
            _ids["request"] += 1
            request = _ids["request"]
        rec = Span(self.name, _ids["span"], None if outer is None else outer.id, request,
                   time.time_ns())
        if _cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = [start, None]
        _spans.append(rec)
        _open.append(rec)
        return rec

    def __exit__(self, *exc) -> bool:
        rec = _open.pop()
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.events[1] = end
        rec.end_ns = time.time_ns()
        return False


def span(name: str):
    """A context that records one span while the tracer is on."""
    if not _on:
        return _OFF
    return _Recorded(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counts(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with ``prefix``."""
    return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def enable() -> None:
    """Record spans from now on (with CUDA events where CUDA is available)."""
    global _on, _cuda
    _cuda = torch.cuda.is_available()
    _on = True


def disable() -> None:
    """Record no more spans; those recorded stay until ``reset``."""
    global _on
    _on = False


@contextlib.contextmanager
def suspended():
    """Within the block no span is recorded and the counters stay as they
    were: a CUDA graph's capture, whose Python runs once for every replay
    to come.  Yields a dict that, at exit, holds what was counted inside."""
    global _on
    on, before = _on, dict(_counters)
    inside: Dict[str, int] = {}
    _on = False
    try:
        yield inside
    finally:
        _on = on
        inside.update({k: v - before.get(k, 0) for k, v in _counters.items()
                       if v != before.get(k, 0)})
        _counters.clear()
        _counters.update(before)


def reset(counters: Optional[str] = None) -> None:
    """Forget the recorded spans and every counter; with ``counters`` a
    prefix, forget only the counters whose names start with it."""
    if counters is None:
        _spans.clear()
        _counters.clear()
        return
    for k in list(_counters):
        if k.startswith(counters):
            del _counters[k]


def snapshot() -> Snapshot:
    """The closed spans, each with its ``device_ms`` where it recorded CUDA
    events (one synchronise reads them all), and the counters."""
    closed = [s for s in _spans if s.end_ns is not None]
    pending = [s for s in closed if s.events is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return Snapshot(closed, dict(_counters))
