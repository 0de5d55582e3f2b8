"""idle_share: the share of the traced window in which no device
activity ran (100 × (1 − the union of the profiler's device intervals /
the window)), in the batch cells."""


def read(run, runner):
    t = run.trace_summary
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
