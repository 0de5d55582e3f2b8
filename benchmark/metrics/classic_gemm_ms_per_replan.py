"""classic_gemm_ms_per_replan: the profiler's device time of the GEMM
kernels (a ``gemm`` in the kernel's name: cuBLAS's and CUTLASS's) per
batch replan of the traced window, in the classic MCTS cells.  There they
are the float32 sweep's Q = P·diag(m)·P and its two-stage contraction, the
edge's H·P and A·Hᵀ, and the downdate Wc·Wcᵀ: most of the search's device
time.  Nothing without a card."""

from benchmark import graphed, spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    ran, replans = graphed.kernel_time(run, "gemm"), graphed.batch_replans(run)
    return None if ran is None or not replans else 1e3 * ran[1] / replans
