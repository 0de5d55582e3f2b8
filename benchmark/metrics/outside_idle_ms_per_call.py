"""outside_idle_ms_per_call: the device's idle time while no ``plan.run``
span of the program is open (the caller's time between calls, the window's
head and tail), per call of the traced window (benchmark/spans.py)."""

from benchmark import spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    return spans.ratio(run, lambda r: r["outside"]["idle_ms"], "calls")
