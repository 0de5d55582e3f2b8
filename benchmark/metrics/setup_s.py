"""setup_s: seconds from the process's start to the first timed step
(imports, the card, the world's host tables, inputs, weights, the
kernels' build in a fresh checkout, warm-up), host clock."""


def read(run, runner):
    return run.setup_s
