"""The traced window: torch.profiler over the whole window, reduced to
the device's busy time (a union of its activity intervals), the device
time of each kernel and of the kernels launched inside each ``bench:``
range, the host's launch and copy calls, and the longest idle gaps by
what the host was doing.  A window with no device events is an error,
never a share of 0.

Only a short summary is written (``bench_out/``, inside the checkout).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict

from benchmark.yardsticks import busy_union

#: host calls that launch device work or copy: the launches per replan
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
                "cudaMemsetAsync", "cudaMemcpy", "cudaMemset", "cudaGraphLaunch",
                "cudaLaunchCooperativeKernel", "cuLaunchKernelEx")


class NoDeviceEvents(RuntimeError):
    pass


def start(on_card: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    prof = profile(activities=acts, record_shapes=False, with_stack=False)
    prof.__enter__()
    return prof


def _events(prof):
    """(device, runtime, host) lists of (start_ns, end_ns, name, correlation)."""
    from torch.autograd import DeviceType

    dev, rt, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        t = s + e.duration_ns()
        name = e.name()
        corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
        if e.device_type() == DeviceType.CUDA:
            # a bench: range is also drawn on the device's timeline: not work
            if not name.startswith("bench:"):
                dev.append((s, t, name, corr))
        elif name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
            rt.append((s, t, name, corr))
        else:
            host.append((s, t, name, corr))
    return dev, rt, host


def stop(prof, window_s: float, on_card: bool) -> Dict:
    prof.__exit__(None, None, None)
    dev, rt, host = _events(prof)
    if not dev:
        raise NoDeviceEvents("the profiler recorded no device events in the traced window")
    busy_ns, gaps = busy_union((s, t) for s, t, _, _ in dev)
    by_kernel = defaultdict(lambda: [0, 0])
    for s, t, name, _ in dev:
        by_kernel[name][0] += 1
        by_kernel[name][1] += t - s
    launches = sum(1 for _, _, name, _ in rt if name in LAUNCH_CALLS)
    # device time of the kernels launched inside each bench: range
    ranges = sorted((s, t, name) for s, t, name, _ in host if name.startswith("bench:"))
    starts = [r[0] for r in ranges]
    corr_range = {}
    for s, _, name, corr in rt:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and ranges[i][0] <= s <= ranges[i][1]:
            corr_range[corr] = ranges[i][2]
    in_range = defaultdict(lambda: [0, 0])
    for s, t, name, corr in dev:
        rname = corr_range.get(corr) if corr else None
        if rname is not None:
            in_range[rname][0] += 1
            in_range[rname][1] += t - s
    # the longest idle gaps, named by the innermost host event across each
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host_sorted = sorted((s, t, name) for s, t, name, _ in host if not name.startswith("bench:"))
    hstarts = [h[0] for h in host_sorted]
    idle = []
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        i = bisect.bisect_right(hstarts, mid)
        label, width = "host: no event", None
        for j in range(i - 1, max(i - 2000, -1), -1):
            hs, he, hname = host_sorted[j]
            if he >= mid and (width is None or he - hs < width):
                label, width = hname, he - hs
        idle.append([label[:120], (ge - gs) / 1e9])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    first = min(s for s, _, _, _ in dev)
    last = max(t for _, t, _, _ in dev)
    summary = {
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "device_span_s": (last - first) / 1e9,
        "device_events": len(dev),
        "launch_calls": launches,
        "kernels": {k: {"count": v[0], "s": v[1] / 1e9} for k, v in by_kernel.items()},
        "ranges": {k: {"kernels": v[0], "s": v[1] / 1e9} for k, v in in_range.items()},
        "breakdown": {"device_ops": [[k[:120], v[1] / 1e9] for k, v in top],
                      "idle_gaps": idle},
    }
    return summary


def write_summary(name: str, seed: int, summary: Dict, out_dir) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    small = {k: v for k, v in summary.items() if k != "kernels"}
    small["kernels"] = dict(sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["s"])[:40])
    with open(out_dir / f"{name}-{seed}-trace.json", "w") as f:
        json.dump(small, f, indent=1)
