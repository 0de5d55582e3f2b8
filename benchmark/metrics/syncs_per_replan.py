"""syncs_per_replan: the program's reads from the device that the host
waits for (its ``host_syncs`` counter: the descent's ``done.all()`` flags,
the Dirichlet draw's ``todo.any()``, the history's copies to the host), per
batch replan of the traced window (benchmark/spans.py)."""

from benchmark import spans


def prepare(run, runner):
    spans.attach(run)


def read(run, runner):
    return spans.ratio(run, lambda r: r["counters"].get("host_syncs", 0), "batch_replans")
