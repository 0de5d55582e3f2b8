"""steps_per_call: the mission loop's steps a call (the program's
``plan.steps`` counter: the steps ``Planner.run`` ran before no mission
could move, its two-step flag lag included), per call of the traced
window (benchmark/spans.py); nothing where the program has no such
counter."""

from benchmark import spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    return spans.ratio(run, lambda r: r["counters"]["plan.steps"], "calls")
