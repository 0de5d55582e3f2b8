"""replans_per_s: replans of missions that were still active (the
program's ``MissionResult.num_steps``, summed over the calls) over the
wall time of the whole calls in the window, host clock, synchronised.
Padded steps of finished missions count for nothing."""


def read(run, runner):
    if not run.replans or run.window_s <= 0:
        return None
    return run.replans / run.window_s
