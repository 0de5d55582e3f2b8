"""classic_idle_ms_per_replan: the device's idle time while the host is
inside the classic search (the program's ``classic.search`` span: on a
card the host's copies of each simulation's draws and the graph's
replays, which the device runs behind it), per batch replan of the
traced window (benchmark/spans.py)."""

from benchmark import spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    return spans.ratio(run, lambda r: r["spans"]["classic.search"]["idle_ms"], "batch_replans")
