"""``Planner.run``'s early exit: once no mission can move, the loop leaves
(its flag read two steps behind) and pads the history on the host to its
(B, T+1) shapes.  Each case holds ``Planner.run`` against the whole loop of
T steps written here with the same public pieces (``plan``,
``IPPWorld.step_index``, ``MissionHistory``): where the skipped steps would
draw nothing the result is bitwise the same, ``final_state`` included;
where they would draw, the loop runs to T and leaves the generator where
the whole loop leaves it.  No JAX: the card tests import ``full_loop``."""

import dataclasses

import numpy as np
import pytest
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, MissionConfig, load_config
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.planners import GreedyPlanner, RandomDiscretePlanner
from ipp_rl_tpu_torch.planners.base import FLAG_LAG, MissionHistory
from ipp_rl_tpu_torch.planners.mcts_classic import gumbel
from ipp_rl_tpu_torch.utils import tracing


def full_loop(planner, state, T, noise=None, generator=None, draws=None):
    """Every one of the T steps, as the loop ran before it could leave."""
    world, uav = planner.world, planner.cfg.uav
    history = MissionHistory(world, state)
    for t in range(T):
        action = planner.plan(state, generator, t, None if draws is None else draws[t])
        cost = travel_costs(world.actions_xyz[action], state.pos, uav.max_v, uav.max_a)
        can_move = state.active & (cost <= state.budget) & (cost > 0)
        state = state.replace(active=can_move)
        state = world.step_index(state, action, None if noise is None else noise[t], generator)
        history.add(state, world.actions_xyz[action], can_move, cost)
    return history.result(state)


def assert_same_result(got, want):
    """Every field bitwise, NaN where NaN, the final state's too."""
    for name in ("waypoints", "budgets", "num_steps", "flight_times"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert set(got.metrics) == set(want.metrics)
    for k, v in want.metrics.items():
        assert got.metrics[k].dtype == v.dtype
        np.testing.assert_array_equal(got.metrics[k], v, err_msg=k)
    for f in dataclasses.fields(want.final_state):
        a, b = getattr(got.final_state, f.name), getattr(want.final_state, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def last_move(result) -> int:
    """The last step in which some mission moved."""
    moved = ~np.isnan(result.waypoints[..., 0])
    return int(np.nonzero(moved.any(axis=0))[0].max())


def run_counted(planner, *args, **kwargs):
    """``planner.run`` and the change of its step counters."""
    before = tracing.counts("plan.steps")
    res = planner.run(*args, **kwargs)
    after = tracing.counts("plan.steps")
    return res, {k: after.get(k, 0) - before.get(k, 0) for k in ("plan.steps",
                                                                  "plan.steps_skipped")}


@pytest.fixture(scope="module")
def example_cfg():
    return load_config(str(CONFIG_DIR / "example.yaml"))


def _world(cfg, dtype):
    return IPPWorld(cfg, dtype=dtype, device="cpu")


def _inputs(world, B, T, seed):
    gen = torch.Generator().manual_seed(seed)
    state = world.init_state(B, gen)
    noise = torch.randn((T, B, world.H.shape[1]), generator=gen, dtype=world.dtype)
    return state, noise


@pytest.mark.parametrize("dtype,B,seed", [(torch.float32, 16, 3), (torch.float32, 32, 11),
                                          (torch.float64, 8, 5)],
                         ids=["f32-b16", "f32-b32", "f64-b8"])
def test_greedy_leaves_early_bitwise(example_cfg, dtype, B, seed):
    world = _world(example_cfg, dtype)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    T = planner.max_steps()
    state, noise = _inputs(world, B, T, seed)
    got, steps = run_counted(planner, B, init_state=state, noise=noise)
    want = full_loop(planner, state, T, noise=noise)
    assert_same_result(got, want)
    assert got.waypoints.shape == (B, T, 3) and got.budgets.shape == (B, T + 1)
    # the missions end well inside the bound, and the loop two steps after
    assert steps["plan.steps"] == last_move(want) + 1 + FLAG_LAG < T
    assert steps["plan.steps"] + steps["plan.steps_skipped"] == T


@pytest.mark.parametrize("T", [3, 12])
def test_greedy_bound_below_the_missions_needs_runs_to_it(example_cfg, T):
    world = _world(example_cfg, torch.float32)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    B = 8
    state, noise = _inputs(world, B, T, 7)
    got, steps = run_counted(planner, B, max_steps=T, init_state=state, noise=noise)
    want = full_loop(planner, state, T, noise=noise)
    assert_same_result(got, want)
    assert want.final_state.active.any()  # still moving at the bound
    assert steps == {"plan.steps": T, "plan.steps_skipped": 0}


@pytest.mark.parametrize("given", ["none", "noise"])
def test_random_discrete_that_draws_runs_to_the_bound(example_cfg, given):
    """The planner draws from the generator: with or without the noise
    given, the loop runs all T steps and the generator ends where the whole
    loop's ends."""
    world = _world(example_cfg, torch.float32)
    planner = RandomDiscretePlanner(world, MissionConfig(type="random_discrete"))
    B, T = 8, planner.max_steps()
    state, noise = _inputs(world, B, T, 13)
    noise = noise if given == "noise" else None
    gen = torch.Generator().manual_seed(21)
    got, steps = run_counted(planner, B, init_state=state, noise=noise, generator=gen)
    gen_want = torch.Generator().manual_seed(21)
    want = full_loop(planner, state, T, noise=noise, generator=gen_want)
    assert_same_result(got, want)
    assert torch.equal(gen.get_state(), gen_want.get_state())
    assert last_move(want) < T - 1 - FLAG_LAG  # an exit would have fired
    assert steps == {"plan.steps": T, "plan.steps_skipped": 0}


def test_random_discrete_with_its_draws_given_leaves_early(example_cfg):
    """Noise and the planner's Gumbel draws given: no step draws from the
    generator, so the loop may leave, bitwise."""
    world = _world(example_cfg, torch.float32)
    planner = RandomDiscretePlanner(world, MissionConfig(type="random_discrete"))
    B, T = 8, planner.max_steps()
    state, noise = _inputs(world, B, T, 17)
    draws = gumbel((T, B, world.num_actions), torch.Generator().manual_seed(2), world.dtype,
                   world.device)
    gen = torch.Generator().manual_seed(4)
    got, steps = run_counted(planner, B, init_state=state, noise=noise, draws=draws,
                             generator=gen)
    want = full_loop(planner, state, T, noise=noise, draws=draws)
    assert_same_result(got, want)
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(4).get_state())
    assert steps["plan.steps"] == last_move(want) + 1 + FLAG_LAG < T


def test_history_pads_as_no_op_steps_fill_it(example_cfg):
    """``MissionHistory.result`` with a bound past the steps recorded."""
    world = _world(example_cfg, torch.float32)
    state, _ = _inputs(world, 3, 1, 1)
    history = MissionHistory(world, state)
    cost = torch.tensor([1.0, 2.0, 3.0])
    history.add(state.replace(budget=state.budget - cost), world.actions_xyz[:3],
                torch.tensor([True, False, True]), cost)
    res = history.result(state, steps=4)
    assert res.waypoints.shape == (3, 4, 3) and np.isnan(res.waypoints[:, 1:]).all()
    assert np.isnan(res.waypoints[1, 0]).all() and not np.isnan(res.waypoints[[0, 2], 0]).any()
    np.testing.assert_array_equal(res.flight_times, [[1, 0, 0, 0], [0, 0, 0, 0], [3, 0, 0, 0]])
    np.testing.assert_array_equal(res.budgets[:, 2:], np.repeat(res.budgets[:, 1:2], 3, axis=1))
    for v in res.metrics.values():
        assert v.shape == (3, 5)
        np.testing.assert_array_equal(v[:, 2:], np.repeat(v[:, 1:2], 3, axis=1))
    np.testing.assert_array_equal(res.num_steps, [1, 0, 1])
    # without a bound, or at the steps recorded, nothing is padded
    for steps in (None, 1):
        assert history.result(state, steps=steps).waypoints.shape == (3, 1, 3)


@pytest.mark.parametrize("counters,want", [({"plan.steps": 90, "host_syncs": 3}, 45.0),
                                            ({"host_syncs": 3}, None)],
                         ids=["counted", "parent"])
def test_steps_per_call_reads_the_counter(counters, want):
    """The benchmark's ``steps_per_call``: the counter a call, and nothing
    (not 0) where the program has no such counter."""
    from benchmark import spans
    from benchmark.harness import load_module

    reader = load_module("metrics", "steps_per_call")
    run = type("Run", (), {})()
    run.values = {spans.KEY: {"counters": counters, "calls": 2}}
    assert reader.read(run, None) == want
