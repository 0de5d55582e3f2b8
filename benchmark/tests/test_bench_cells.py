"""Each cell end to end at a CPU size (the port's plain path), its
comparison with the reference; the lower-precision control and the
faults planted under the timed path must come out not correct."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.tests.helpers import CELLS, TINY, run_cell


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    rc, res, err = run_cell(cell)
    assert rc == 0, err[-2000:]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]
    lines = err.strip().splitlines()
    assert all(line.startswith("check ") for line in lines[-len(res["checks"]):])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    limits = harness.data_file("workloads", cell)["limits"]
    prog, low = control.readings(cell, 98765432109, 1.0, device="cpu", overrides=TINY[cell])
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(low[k] > v for k, v in limits.items()), low


# ------------------------------------------------------------ planted faults

def _unchanged(monkeypatch):
    from ipp_rl_tpu_torch.env.world import IPPWorld

    monkeypatch.setattr(IPPWorld, "step_index", lambda self, state, *a, **k: state)
    monkeypatch.setattr(IPPWorld, "step_position", lambda self, state, *a, **k: state)


def _halved_run(run):
    """``run`` over the first half of the batch, its results copied onto
    the half left out."""
    from ipp_rl_tpu_torch.planners.base import MissionResult

    def halved(self, batch_size, max_steps=None, init_state=None, think_time_per_step=0.0,
               generator=None, noise=None, draws=None):
        h = batch_size // 2
        sub = dataclasses.replace(init_state, **{
            f.name: getattr(init_state, f.name)[:h] for f in dataclasses.fields(init_state)})
        res = run(self, h, max_steps, sub, think_time_per_step, generator,
                  None if noise is None else noise[:, :h],
                  None if draws is None else [d[:h] for d in draws])

        def two(x):
            return np.concatenate([x, x])[:batch_size]

        fin = res.final_state
        fin = dataclasses.replace(fin, **{
            f.name: torch.cat([getattr(fin, f.name)] * 2)[:batch_size]
            for f in dataclasses.fields(fin)})
        return MissionResult(waypoints=two(res.waypoints),
                             metrics={k: two(v) for k, v in res.metrics.items()},
                             budgets=two(res.budgets), num_steps=two(res.num_steps),
                             flight_times=two(res.flight_times), final_state=fin)

    return halved


def _half(monkeypatch):
    from ipp_rl_tpu_torch.planners.base import Planner
    from ipp_rl_tpu_torch.planners.cmaes import CMAESPlanner
    from ipp_rl_tpu_torch.planners.zero import ZeroPlanner

    for cls in (Planner, CMAESPlanner, ZeroPlanner):
        monkeypatch.setattr(cls, "run", _halved_run(cls.run))


def _altered(monkeypatch):
    from ipp_rl_tpu_torch.planners.cmaes import CMAESPlanner
    from ipp_rl_tpu_torch.planners.greedy import GreedyPlanner
    from ipp_rl_tpu_torch.planners.zero import ZeroPlanner

    plan, replan, batch = GreedyPlanner.plan, ZeroPlanner._replan, CMAESPlanner.replan_batch

    def plan_next(self, *a, **k):
        return (plan(self, *a, **k) + 1) % self.world.num_actions

    def replan_next(self, *a, **k):
        return (replan(self, *a, **k) + 1) % self.world.num_actions

    def batch_moved(self, *a, **k):
        wps, valid = batch(self, *a, **k)
        return wps + torch.tensor([2.0, 0.0, 0.0], dtype=wps.dtype, device=wps.device), valid

    monkeypatch.setattr(GreedyPlanner, "plan", plan_next)
    monkeypatch.setattr(ZeroPlanner, "_replan", replan_next)
    monkeypatch.setattr(CMAESPlanner, "replan_batch", batch_moved)


def _mutated(monkeypatch, owner, name, old, new):
    """``owner.name`` (a module's function or a class's method) rebuilt
    from its source with ``old`` replaced by ``new``."""
    import inspect
    import textwrap

    src = textwrap.dedent(inspect.getsource(getattr(owner, name)))
    assert old in src
    scope = dict(vars(inspect.getmodule(owner)))
    exec(compile(src.replace(old, new), inspect.getsourcefile(owner), "exec"), scope)
    monkeypatch.setattr(owner, name, scope[name])


def _fewer_generations(monkeypatch):
    from ipp_rl_tpu_torch.planners.cmaes import CMAESPlanner

    init = CMAESPlanner.__init__

    def quarter(self, *a, **k):
        init(self, *a, **k)
        self.maxiter = max(1, self.maxiter // 4)

    monkeypatch.setattr(CMAESPlanner, "__init__", quarter)


def _mean_frozen(monkeypatch):
    from ipp_rl_tpu_torch.planners import cmaes

    _mutated(monkeypatch, cmaes, "cma_es_minimize", "mean_new = st.mean + torch.sum(",
             "mean_new = st.mean + 0.0 * torch.sum(")


def _backup_skipped(monkeypatch):
    from ipp_rl_tpu_torch.planners.zero.mcts import ZeroMCTS

    monkeypatch.setattr(ZeroMCTS, "_backup", lambda self, *a, **k: None)


def _selection_by_prior(monkeypatch):
    from ipp_rl_tpu_torch.planners.zero import mcts

    _mutated(monkeypatch, mcts.ZeroMCTS, "puct", "uct = q + c * prior *", "uct = 0.0 * q + prior *")


#: each fault and the cells that can have it
FAULTS = {"state_unchanged": (_unchanged, CELLS), "half_batch": (_half, CELLS),
          "answer_altered": (_altered, CELLS),
          "fewer_generations": (_fewer_generations, ["temperature_cmaes.cmaes-b8192"]),
          "mean_frozen": (_mean_frozen, ["temperature_cmaes.cmaes-b8192"]),
          "backup_skipped": (_backup_skipped, ["example.zero-b1024"]),
          "selection_by_prior": (_selection_by_prior, ["example.zero-b1024"])}

CASES = [(c, f) for f, (_, cells) in sorted(FAULTS.items()) for c in cells]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault][0](monkeypatch)
    rc, res, err = run_cell(cell)
    assert rc == 0, err[-2000:]
    assert not res["correct"], res["checks"]
