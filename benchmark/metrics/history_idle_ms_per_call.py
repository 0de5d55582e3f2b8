"""history_idle_ms_per_call: the device's idle time while the host is in
``MissionHistory.result`` (the program's ``plan.history`` spans: the
histories' copies to the host), per call of the traced window
(benchmark/spans.py)."""

from benchmark import spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    return spans.ratio(run, lambda r: r["spans"]["plan.history"]["idle_ms"], "calls")
