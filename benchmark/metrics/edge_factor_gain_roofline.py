"""edge_factor_gain_roofline: the share of its roofline that the edge
update reaches: the least time the card could take for the work of every
``kernels.edge_factor_gain`` call in the traced window (S_raw and A read
once, Wcᵀ and the gain written once, the mask, one R row and one action
per mission; the plain algorithm's operations; yardsticks.edge_bytes,
edge_ops, bound), over the profiler's device time of the kernels those
calls launched."""

from benchmark.rooflines import kernel_share, wrap_kernel
from benchmark.yardsticks import bound, edge_bytes, edge_ops

NAME = "edge_factor_gain"


def _bound_ms(args):
    S_raw, A = args[0], args[1]
    mask = args[4] if len(args) > 4 else None
    round_bf16 = bool(args[5]) if len(args) > 5 else False
    b, m, n = A.shape
    moved = edge_bytes(b, m, n, 0 if mask is None else mask.numel(), A.element_size())
    return bound(moved, edge_ops(m, n, mask is not None, round_bf16) * b)[0]


def prepare(run, runner):
    wrap_kernel(run, NAME, _bound_ms)


def read(run, runner):
    return kernel_share(run, NAME)
