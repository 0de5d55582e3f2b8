"""commit_ms_per_step: device wall time (CUDA events around each call of
the world's ``step_index``: the reading, ``kf_update`` and K1) per batch
replan step."""

PHASE = "commit"


def prepare(run, runner):
    run.timer.wrap(runner.world, "step_index", PHASE)


def read(run, runner):
    n = run.timer.calls(PHASE)
    return run.timer.ms(PHASE) / n if n else None
