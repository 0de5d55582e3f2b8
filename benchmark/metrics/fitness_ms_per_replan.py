"""fitness_ms_per_replan: device wall time (CUDA events around each call
of ``CMAESPlanner.trajectory_loss``, CMA-ES's fitness: per waypoint the
camera model, A = H·P, ``edge_factor_gain`` and the rank-M update) per
batch replan."""

PHASE = "fitness"


def prepare(run, runner):
    run.timer.wrap(runner.planner, "trajectory_loss", PHASE)


def read(run, runner):
    if not run.batch_replans or not run.timer.calls(PHASE):
        return None
    return run.timer.ms(PHASE) / run.batch_replans
