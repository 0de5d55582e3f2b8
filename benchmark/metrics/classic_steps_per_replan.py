"""classic_steps_per_replan: the classic search's lockstep steps, descent
and rollout, a batch replan (the program's ``classic.lockstep_steps``
counter: S·(Hc + H) a search), per batch replan of the traced window
(benchmark/spans.py); nothing where the program has no such counter."""

from benchmark import spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    return spans.ratio(run, lambda r: r["counters"]["classic.lockstep_steps"], "batch_replans")
