"""sweep_ms_per_step: device wall time (CUDA events around each call of
``planners/greedy.sweep_rewards``, the all-action sweep) per batch
replan step.  The events time the stream's wall interval, so host-paced
gaps inside the call count."""

PHASE = "sweep"


def prepare(run, runner):
    import ipp_rl_tpu_torch.planners.greedy as greedy

    run.timer.wrap(greedy, "sweep_rewards", PHASE)


def read(run, runner):
    n = run.timer.calls(PHASE)
    return run.timer.ms(PHASE) / n if n else None
