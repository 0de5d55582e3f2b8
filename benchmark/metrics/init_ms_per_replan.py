"""init_ms_per_replan: device wall time (CUDA events around each call of
``greedy_search_horizon``, CMA-ES's greedy initial plan: a sweep and a
covariance-only commit per waypoint of the horizon) per batch replan."""

PHASE = "init"


def prepare(run, runner):
    import ipp_rl_tpu_torch.planners.cmaes as cmaes

    run.timer.wrap(cmaes, "greedy_search_horizon", PHASE)


def read(run, runner):
    if not run.batch_replans or not run.timer.calls(PHASE):
        return None
    return run.timer.ms(PHASE) / run.batch_replans
