"""descent_ms_per_replan: device wall time (CUDA events around each of the
zero search's ``ZeroMCTS._descend_step``: PUCT, the edge update through
``edge_factor_gain``, the tree's writes) per batch replan.  The descent
is host-paced, so the events' intervals hold the host's gaps too."""

PHASE = "descent"


def prepare(run, runner):
    run.timer.wrap(runner.planner.mcts, "_descend_step", PHASE)


def read(run, runner):
    if not run.batch_replans or not run.timer.calls(PHASE):
        return None
    return run.timer.ms(PHASE) / run.batch_replans
