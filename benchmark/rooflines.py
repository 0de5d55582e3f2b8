"""Roofline shares of the port's kernels in a traced window.

``wrap_kernel`` replaces a wrapper of ``ipp_rl_tpu_torch.ops.kernels``
for the traced run: each call runs inside a ``bench:<name>`` profiler
range and adds the least time its work could take on the card (from the
call's shapes, by the frozen bound model).  ``kernel_share`` divides the
sum of those bounds by the profiler's device time of the kernels that
the calls launched, as a percentage.
"""

from __future__ import annotations

from typing import Callable, Optional


def wrap_kernel(run, name: str, bound_ms: Callable) -> None:
    import torch
    from torch.profiler import record_function

    import ipp_rl_tpu_torch.ops.kernels as kernels

    fn = getattr(kernels, name)
    bounds = run.launches.setdefault(name, [])

    def measured(*args, **kw):
        with record_function(f"bench:{name}"):
            out = fn(*args, **kw)
        if run.tracing and all(not isinstance(a, torch.Tensor) or a.is_cuda for a in args):
            bounds.append(bound_ms(args))
        return out

    # the wrappers count their launches on the function object itself
    measured.launches = getattr(fn, "launches", 0)
    setattr(kernels, name, measured)


def kernel_share(run, name: str) -> Optional[float]:
    t = run.trace_summary
    bounds = run.launches.get(name, [])
    rng = (t or {}).get("ranges", {}).get(f"bench:{name}")
    if not bounds or rng is None or rng["s"] <= 0:
        return None
    return 100.0 * (sum(bounds) / 1e3) / rng["s"]
