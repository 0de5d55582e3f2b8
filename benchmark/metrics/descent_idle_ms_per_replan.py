"""descent_idle_ms_per_replan: the device's idle time while the host is in
the zero search's descent (the program's ``zero.descent`` spans: each
simulation's loop of ``_descend_step`` with its flag reads from the
device), per batch replan of the traced window (benchmark/spans.py)."""

from benchmark import spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    return spans.ratio(run, lambda r: r["spans"]["zero.descent"]["idle_ms"], "batch_replans")
