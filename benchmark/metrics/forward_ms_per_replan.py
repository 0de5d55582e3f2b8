"""forward_ms_per_replan: device wall time (CUDA events around each call
of the search's ``predict``: the policy-value network's forward over the
leaves' planes) per batch replan."""

PHASE = "forward"


def prepare(run, runner):
    run.timer.wrap(runner.planner.mcts, "predict", PHASE)


def read(run, runner):
    if not run.batch_replans or not run.timer.calls(PHASE):
        return None
    return run.timer.ms(PHASE) / run.batch_replans
