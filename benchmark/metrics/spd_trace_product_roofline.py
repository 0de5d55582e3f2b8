"""spd_trace_product_roofline: the share of its roofline that the sweep's
trace products reach: the least time the card could take for the work
of every ``kernels.spd_trace_product_packed`` call in the traced window
(each packed S and G read once, each trace written once, the plain
algorithm's operations; yardsticks.trace_bytes, trace_ops, bound), over
the profiler's device time of the kernels those calls launched."""

from benchmark.rooflines import kernel_share, wrap_kernel
from benchmark.yardsticks import bound, trace_bytes, trace_ops

NAME = "spd_trace_product_packed"


def _bound_ms(args):
    S = args[0]
    outer, t, inner = S.shape
    m = int(round(((8 * t + 1) ** 0.5 - 1) / 2))
    return bound(trace_bytes(outer, t, inner, S.element_size()), trace_ops(m) * outer * inner)[0]


def prepare(run, runner):
    wrap_kernel(run, NAME, _bound_ms)


def read(run, runner):
    return kernel_share(run, NAME)
