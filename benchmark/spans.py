"""The program's own spans and counters in a traced run
(``ipp_rl_tpu_torch/utils/tracing.py``), read against the profiler's
device intervals.

``attach(run)``, which each reader's ``prepare`` calls (a second call does
nothing), turns the program's tracer on for the traced window only.  It
wraps ``benchmark.tracing.start`` and ``stop`` for this run: when the
profiler starts it enables the tracer; when the profiler stops it disables
it, lets ``stop`` compute what it computes, reads the profiler's device
intervals again (``tracing._events``, ``busy_union``), takes the tracer's
snapshot and the calls and batch replans made meanwhile.  It then puts
each idle interval of the window, its head and tail included, down to the
innermost program span open on the host at that instant, split at the
spans' edges; idle time while no ``plan.run`` span is open goes to
``outside``.  The spans and the profiler share the host's
CLOCK_REALTIME (``time.time_ns()``).

The result (``run.values[KEY]``, and ``bench_out/<cell>-<seed>-spans.json``)
holds per span name its count, host ms, device ms (between its CUDA
events; none without a card), idle ms (while a span of that name is open,
its children's time included) and self idle ms (while it is the innermost
span); the idle ms outside; the window's idle ms, the trace summary's
(window − busy) beside it; the program's counters over the window; the
calls and batch replans.  A program without its own tracer leaves the
result None, and every reader of it reads nothing.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import harness, tracing
from benchmark.yardsticks import busy_union

KEY = "program_spans"


def attach(run) -> None:
    if KEY in run.values:
        return
    run.values[KEY] = None
    try:
        from ipp_rl_tpu_torch.utils import tracing as program
    except ImportError:  # the program has no tracer of its own
        return
    start, stop = tracing.start, tracing.stop
    at = {}

    def started(on_card):
        prof = start(on_card)
        at.update(ns=time.time_ns(), calls=run.calls, batch_replans=run.batch_replans,
                  counters=program.counts())
        program.enable()
        return prof

    def stopped(prof, window_s, on_card):
        end_ns = time.time_ns()
        program.disable()
        tracing.start, tracing.stop = start, stop
        summary = stop(prof, window_s, on_card)
        dev, _, _ = tracing._events(prof)
        snap = program.snapshot()
        w0 = end_ns - int(window_s * 1e9)
        out = summarize([s for s in snap.spans if s.start_ns >= at["ns"]],
                        idle_intervals([(s, t) for s, t, _, _ in dev], w0, end_ns), w0, end_ns)
        out.update(
            trace_idle_ms=(summary["window_s"] - summary["busy_s"]) * 1e3,
            counters={k: v - at["counters"].get(k, 0) for k, v in snap.counters.items()
                      if v != at["counters"].get(k, 0)},
            calls=run.calls - at["calls"], batch_replans=run.batch_replans - at["batch_replans"])
        run.values[KEY] = out
        harness.OUT_DIR.mkdir(parents=True, exist_ok=True)
        with open(harness.OUT_DIR / f"{run.name}-{run.seed}-spans.json", "w") as f:
            json.dump(out, f, indent=1)
        return summary

    tracing.start, tracing.stop = started, stopped


def ratio(run, of: Callable[[Dict], Optional[float]], over: str) -> Optional[float]:
    """``of(result)`` per call or per batch replan (``over``) the tracer saw;
    None where there is no result, no call, or ``of`` finds no such span."""
    r = run.values.get(KEY)
    if not r or not r[over]:
        return None
    try:
        value = of(r)
    except KeyError:
        return None
    return None if value is None else value / r[over]


# ------------------------------------------------------------ the attribution

def idle_intervals(device: List[Tuple[int, int]], w0: int, w1: int) -> List[Tuple[int, int]]:
    """The window [w0, w1] less the union of the device intervals, in order."""
    inside = [(max(s, w0), min(t, w1)) for s, t in device if t > w0 and s < w1]
    if not inside:
        return [(w0, w1)]
    _, gaps = busy_union(inside)
    first, last = min(s for s, _ in inside), max(t for _, t in inside)
    return [(a, b) for a, b in [(w0, first)] + gaps + [(last, w1)] if b > a]


def innermost(spans, w0: int, w1: int) -> List[Tuple[int, int, object]]:
    """The window cut at the spans' edges into pieces (start, end, the
    innermost span open on the host then, or None); spans nest."""
    pieces, open_, t = [], [], w0

    def upto(end, owner):
        nonlocal t
        end = min(max(end, w0), w1)
        if end > t:
            pieces.append((t, end, owner))
            t = end

    for s in sorted(spans, key=lambda s: (s.start_ns, s.id)):
        while open_ and open_[-1].end_ns <= s.start_ns:
            upto(open_[-1].end_ns, open_.pop())
        upto(s.start_ns, open_[-1] if open_ else None)
        open_.append(s)
    while open_:
        upto(open_[-1].end_ns, open_.pop())
    upto(w1, None)
    return pieces


def summarize(spans, idle: List[Tuple[int, int]], w0: int, w1: int) -> Dict:
    """Each idle interval's time put down to the innermost span open then
    (outside where that span, or no span, is in no request), and each span
    name's count, host ms, device ms, idle ms and self idle ms."""
    pieces = innermost(spans, w0, w1)
    self_ns: Dict[Optional[int], int] = defaultdict(int)
    i = 0
    for a, b in idle:
        while pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi, owner = max(a, pieces[j][0]), min(b, pieces[j][1]), pieces[j][2]
            in_request = owner is not None and owner.request is not None
            self_ns[owner.id if in_request else None] += hi - lo
            j += 1
    by_id = {s.id: s for s in spans}
    names: Dict[str, Dict] = {}
    for s in spans:
        e = names.setdefault(s.name, {"count": 0, "host_ms": 0.0, "device_ms": None,
                                      "idle_ms": 0.0, "self_idle_ms": 0.0})
        e["count"] += 1
        e["host_ms"] += (s.end_ns - s.start_ns) / 1e6
        if s.device_ms is not None:
            e["device_ms"] = (e["device_ms"] or 0.0) + s.device_ms
    for sid, ns in self_ns.items():
        if sid is None:
            continue
        s = by_id[sid]
        names[s.name]["self_idle_ms"] += ns / 1e6
        seen = set()  # a name nested in itself counts once
        while s is not None:
            if s.name not in seen:
                names[s.name]["idle_ms"] += ns / 1e6
                seen.add(s.name)
            s = by_id.get(s.parent)
    return {"window_s": (w1 - w0) / 1e9, "idle_ms": sum(b - a for a, b in idle) / 1e6,
            "spans": names, "outside": {"idle_ms": self_ns.get(None, 0) / 1e6}}
