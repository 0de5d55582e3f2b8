"""evaluate_ms_per_step: device wall time (the CUDA events of the program's
``plan.evaluate`` spans: ``world.evaluate``'s metrics of the batch after
each step, and of the prior) per batch replan step of the traced window
(benchmark/spans.py); nothing without a card."""

from benchmark import spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    return spans.ratio(run, lambda r: r["spans"]["plan.evaluate"]["device_ms"], "batch_replans")
