"""Readings of kernels that a cell's program runs inside a CUDA graph.

A graph's replay makes no launch call of its own for each kernel, so the
profiler ranges of ``benchmark.rooflines`` see none of them.  The
profiler still draws every kernel of a replay on the device's timeline,
under its own name.  A runner that captures a graph keeps, by wrapper
name, the arguments of each launch its capture made (``runner.captured``);
the share of a kernel's roofline is then the launches of that kernel in
the traced window, times the mean least time of one captured launch
(the base reader's bound model), over their device time.
"""

from __future__ import annotations

from typing import Callable, Optional


def kernel_time(run, symbol: str):
    """(launches, device s) of the kernels whose name holds ``symbol`` in
    the traced window, or None without a trace or such a kernel."""
    t = run.trace_summary
    if t is None:
        return None
    hits = [v for k, v in t["kernels"].items() if symbol in k]
    n, s = sum(v["count"] for v in hits), sum(v["s"] for v in hits)
    return (n, s) if n and s > 0 else None


def kernel_share(run, runner, name: str, symbol: str, bound_ms: Callable) -> Optional[float]:
    """The share (%) of its roofline that the wrapper ``name``'s kernel
    (named ``symbol`` on the device) reaches in the traced window."""
    launches = getattr(runner, "captured", {}).get(name)
    ran = kernel_time(run, symbol)
    if not launches or ran is None:
        return None
    per_launch_ms = sum(bound_ms(a) for a in launches) / len(launches)
    return 100.0 * (ran[0] * per_launch_ms / 1e3) / ran[1]


def batch_replans(run) -> Optional[int]:
    """The batch replans of the traced window (benchmark/spans.py)."""
    from benchmark import spans

    r = run.values.get(spans.KEY)
    return r["batch_replans"] if r else None
