"""CMA-ES's replan and mission loop: the port's ``replan_batch`` and
``run`` against the JAX package's (ipp_rl_tpu/planners/cmaes.py:211-350)
in float64, with the JAX key chain's normals and noise injected and JAX's
own eigendecompositions, recorded while JAX's CMA-ES runs, replayed to the
port (tests/test_torch_cmaes.py says why).

Tolerances (float64): the refined plans, the mission's waypoints, budgets,
final covariances and metrics rtol 1e-9 (the same algebra, with GEMM and
reduction orders left to each library); validity flags, NaN patterns and
step counts exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.planners import cmaes as jcmaes
from ipp_rl_tpu_torch.config import MissionConfig
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, draws_from_arrays
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners import cmaes

from test_torch_cmaes import F64, MC, cma_normals, recorded_eigh, replay, setup  # noqa: F401
from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def jax_replan(setup):
    """JAX's replan_batch, compiled once, returning its plans and the
    eigendecompositions its CMA-ES computed."""
    jplanner = setup[2]
    with recorded_eigh() as calls:
        replan = jax.jit(jplanner.replan_batch)

        def run(jstate, key):
            start = len(calls)
            wps, valid = replan(jstate, key)
            jax.effects_barrier()
            return wps, valid, calls[start:]

        yield run


def replan_normals(jworld, key, B):
    """(B, maxiter, λ, D): the normals replan_batch's missions draw."""
    D = 3 * MC["episode_horizon"]
    return np.stack([cma_normals(k, MC["cma_maxiter"], MC["cma_popsize"], D)
                     for k in jax.random.split(key, B)])


def test_replan_batch_matches_jax(setup, jax_replan):
    jworld, world, jplanner, planner, jstate, state = setup
    key = jax.random.key(4)
    want_wps, want_valid, eighs = jax_replan(jstate, key)
    assert len(eighs) == 2 * MC["cma_maxiter"]
    normals = draws_from_arrays(replan_normals(jworld, key, 2), (2, MC["cma_maxiter"],
                                MC["cma_popsize"], 3 * MC["episode_horizon"]), "cpu", F64)
    planner.eigh = replay(eighs, 2)
    wps, valid = planner.replan_batch(state, normals)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(wps.numpy(), np.asarray(want_wps), rtol=1e-9, atol=1e-12)


def test_run_matches_jax_step_by_step(setup, jax_replan):
    """``run`` at horizon 2, λ 4, 2 generations, B 2, max_steps 5, against
    JAX's ``replan_batch`` and ``step_position`` driven step by step with
    the run's key chain (ipp_rl_tpu/planners/cmaes.py:265-304: a mission
    key, then per step a plan and a measurement key): the JAX package's own
    ``run`` compiles CMA-ES into a scan too slowly for these tests."""
    jworld, world, jplanner, planner, _, _ = setup
    B, T = 2, 5
    key = jax.random.key(5)
    k_init, k_run = jax.random.split(key)
    jstate = jworld.init_state(k_init, B)
    state0 = belief_state_from_arrays(jstate, device="cpu", dtype=F64)
    chunk = min(jplanner.scan_chunk, T)
    keys = jax.random.split(k_run, -(-T // chunk) * chunk)[:T]
    step = jax.jit(jworld.step_position)
    normals, noise, want_wps, budgets, eighs = [], [], [], [], []
    for t in range(T):
        k_plan, k_meas = jax.random.split(keys[t])
        wps, any_valid, calls = jax_replan(jstate, k_plan)
        eighs += calls
        wp = wps[:, 0, :]
        uav = jplanner.cfg.uav
        cost = jcmaes.travel_costs(wp, jstate.pos, uav.max_v, uav.max_a)
        can_move = jstate.active & any_valid & (cost <= jstate.budget) & (cost > 0)
        jstate = step(jstate.replace(active=can_move), wp, k_meas)
        want_wps.append(np.where(np.asarray(can_move)[:, None], np.asarray(wp), np.nan))
        budgets.append(np.asarray(jstate.budget))
        normals.append(replan_normals(jworld, k_plan, B))
        noise.append(np.stack([np.asarray(jax.random.normal(k, (jworld.m_max_cont,),
                                                            jnp.float64))
                               for k in jax.random.split(k_meas, B)]))
    planner.eigh = replay(eighs, B)
    got = planner.run(B, max_steps=T, init_state=state0,
                      noise=draws_from_arrays(np.stack(noise), (T, B, world.m_max_cont),
                                              "cpu", F64),
                      draws=draws_from_arrays(np.stack(normals), (T, B, MC["cma_maxiter"],
                                              MC["cma_popsize"], 3 * MC["episode_horizon"]),
                                              "cpu", F64))
    want_wps = np.stack(want_wps, axis=1)
    assert got.waypoints.shape == (B, T, 3) and got.budgets.shape == (B, T + 1)
    np.testing.assert_array_equal(np.isnan(got.waypoints), np.isnan(want_wps))
    np.testing.assert_allclose(got.waypoints, want_wps, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.budgets[:, 1:], np.stack(budgets, axis=1), rtol=1e-9)
    np.testing.assert_array_equal(got.num_steps, np.asarray(jstate.step))
    np.testing.assert_allclose(got.final_state.cov.numpy(), np.asarray(jstate.cov), rtol=1e-9,
                               atol=1e-12)
    jm = jworld.evaluate(jstate)
    for k in jm:
        np.testing.assert_allclose(got.metrics[k][:, -1], np.asarray(jm[k]), rtol=1e-9)
    # no step past max_steps: the final state is the last step's
    np.testing.assert_array_equal(got.final_state.budget.numpy(), got.budgets[:, -1])
    unc = got.metrics["uncertainty"]
    assert np.all(unc[:, -1] < unc[:, 0])


def test_run_draws_its_own(small_cfg):
    """Without injected draws: repeatable from a seed, waypoints in the box."""
    world = IPPWorld(port_cfg(small_cfg), dtype=F64, device="cpu")
    planner = cmaes.CMAESPlanner(world, MissionConfig(**MC))
    a = planner.run(2, max_steps=3, generator=torch.Generator().manual_seed(0))
    b = planner.run(2, max_steps=3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(a.waypoints, b.waypoints)
    ok = ~np.isnan(a.waypoints[..., 0])
    con, env = world.cfg.constraints, world.cfg.environment
    assert ok.any()
    assert np.all(a.waypoints[..., 2][ok] >= con.min_altitude)
    assert np.all(a.waypoints[..., 2][ok] <= con.max_altitude)
    assert np.all((a.waypoints[..., 0][ok] >= 0) & (a.waypoints[..., 0][ok] <= env.extent_x))
