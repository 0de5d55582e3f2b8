"""Frozen copies of the measuring arithmetic, so that a change to the
program cannot move the yardstick.

Each piece names its origin in the repository as it stood when the
benchmark was written:

* the published H100 peaks, ``_cholesky_ops`` … ``trace_ops``,
  ``edge_bytes`` and ``bound``: ``chip_smoke.py`` (its bound model);
* ``network_flops``, ``count_calls`` and ``PhaseTimer``: ``chip_smoke.py``;
* ``busy_union``: the busy share of ``scripts/profile_torch_greedy.py``,
  made a union of intervals (the script summed self device times, which
  counts overlapping kernels twice).

A roofline share counts the work the inputs need (each input read once,
each output written once, the operations of the plain algorithm),
whatever kernel does the work.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Tuple

import torch

# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


# ------------------------------------------------------------ bound model

def _cholesky_ops(m: int) -> int:
    """Operations of the unrolled Cholesky, counted one per add, multiply,
    divide, square root and compare."""
    return sum(2 * j + 3 + (m - j - 1) * (2 * j + 1)  # pivot (j mul, j sub, clamp,
               for j in range(m))  # sqrt, reciprocal), then the column below it


def _inverse_factor_ops(m: int) -> int:
    """The Cholesky + forward substitution shared by the kernels (one more
    per negation)."""
    ops = _cholesky_ops(m)
    for j in range(m):
        ops += 1  # Li diagonal reciprocal
        ops += sum(2 * (i - j) + 1 for i in range(j + 1, m))  # Li entries
    return ops


def inverse_ops(m: int) -> int:
    entries = sum(2 * (m - i) - 1 for i in range(m) for _ in range(i + 1))
    return _inverse_factor_ops(m) + entries


def inverse_factor_ops(m: int) -> int:
    return inverse_ops(m) + _cholesky_ops(m)


def edge_ops(m: int, n: int, masked: bool, round_bf16: bool) -> int:
    """Operations of edge_factor_gain for one mission: the symmetrised
    lower triangle (add, halve, add R or 0), the inverse and its factor,
    Uᵀ·A (m products and m − 1 sums per entry), the optional round trip,
    the squares and their sums over m, the mask, and the gain's n − 1 sums."""
    sym = 3 * m * (m + 1) // 2
    wct = m * n * (2 * m - 1) + (2 * m * n if round_bf16 else 0)
    sq = m * n + (m - 1) * n + (n if masked else 0)
    return sym + inverse_factor_ops(m) + wct + sq + n - 1


def trace_ops(m: int) -> int:
    """Operations of one tr(S⁻¹G) of packed M × M blocks."""
    pairs = [(i, j) for i in range(m) for j in range(i + 1)]
    entries = sum(2 * (m - i) - 1 + 1 + (i != j) for i, j in pairs) + len(pairs) - 1
    return _inverse_factor_ops(m) + entries


def edge_bytes(b: int, m: int, n: int, mask_numel: int, itemsize: int) -> int:
    """Bytes edge_factor_gain must move: S_raw and A read, Wcᵀ and the gain
    written, the mask, one R row and one int64 action per mission."""
    return (b * m * m + 2 * b * m * n + b + b * m + mask_numel) * itemsize + 8 * b


def trace_bytes(outer: int, t: int, inner: int, itemsize: int) -> int:
    """Bytes spd_trace_product must move: packed S and G read, the
    (outer, inner) traces written."""
    return (2 * outer * t * inner + outer * inner) * itemsize


def bound(bytes_moved: float, ops: float) -> Tuple[float, str]:
    """The least milliseconds the card could take, and what bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ FLOP counting

def network_flops(net, planes: torch.Tensor, mask: torch.Tensor) -> int:
    """Multiply-adds × 2 of the convolutions and dense layers of one
    forward over ``planes``, counted from their output shapes by hooks."""
    total = 0

    def count(module, inputs, out):
        nonlocal total
        w = module.weight
        per_output = w[0].numel() if isinstance(module, torch.nn.Conv2d) else w.shape[1]
        total += 2 * out.numel() * per_output

    layers = [m for m in net.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    hooks = [m.register_forward_hook(count) for m in layers]
    try:
        with torch.no_grad():
            net(planes, mask)
    finally:
        for h in hooks:
            h.remove()
    return total


# ------------------------------------------------------------ spans from outside

@contextlib.contextmanager
def count_calls(owner, attr: str):
    """Counts the calls of ``owner.attr`` in a one-element list while the
    block runs: an instance's method, or a class's (then every instance's,
    those made inside the block too)."""
    own = vars(owner).get(attr)
    fn, calls = getattr(owner, attr), [0]

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    setattr(owner, attr, counted)
    try:
        yield calls
    finally:
        if own is None:
            delattr(owner, attr)
        else:
            setattr(owner, attr, own)


class PhaseTimer:
    """Device time of named phases: CUDA events recorded around each call
    of the wrapped callables, summed after a synchronise.  The events time
    wall intervals on the device's stream, so gaps in which the host paces
    the device count inside a phase."""

    def __init__(self):
        self.events = {}

    def wrap(self, obj, attr: str, phase: str) -> None:
        fn = getattr(obj, attr)

        def timed(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.setdefault(phase, []).append((start, end))
            return out

        # attributes the program reads off the callable (a predict's
        # infer_dtype) stay visible through the wrapper
        timed.__dict__.update(getattr(fn, "__dict__", {}))
        setattr(obj, attr, timed)

    def calls(self, phase: str) -> int:
        return len(self.events.get(phase, ()))

    def ms(self, phase: str) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events.get(phase, ()))


# ------------------------------------------------------------ busy union

def busy_union(intervals: Iterable[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of [start, end) intervals, and the gaps
    between the merged intervals, in the intervals' unit."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return busy, gaps
