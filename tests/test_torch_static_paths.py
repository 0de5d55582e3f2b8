"""The static and random baselines end to end: the port's lawnmower,
spiral, random continuous and random discrete planners against the JAX
package's on small_cfg in float64, from the same initial state, with the
draws the JAX run's key chain makes injected (the waypoint uniforms, the
categorical's Gumbel draws and the measurement noise; the key splits of
ipp_rl_tpu/planners/static_paths.py:90,101 and planners/base.py:173,183,
env/world.py:332).

Waypoints (NaN after a mission ends) and step counts are held exactly,
budgets and flight times to rtol 1e-12 (flight times take a square root),
metric curves to rtol 1e-10."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import EvaluationConfig
from ipp_rl_tpu.config.schema import MissionConfig as JaxMissionConfig
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.planners import static_paths as jsp
from ipp_rl_tpu_torch.config import MissionConfig
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, draws_from_arrays
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners import static_paths as sp

from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

B = 3
F64 = torch.float64
PLANNERS = {  # name: (mission config fields, max_steps)
    "lawnmower": ({"step_size": 5.0}, None),
    "spiral": ({"num_waypoints": 100}, None),
    "random_continuous": ({}, None),
    "random_discrete": ({}, 10),
}
CLASSES = {"lawnmower": "LawnmowerPlanner", "spiral": "SpiralPlanner",
           "random_continuous": "RandomContinuousPlanner",
           "random_discrete": "RandomDiscretePlanner"}


def step_noise(jworld, keys, M):
    """(T, B, M): per step key, the normals of its B-way split."""
    def one(k):
        return jax.vmap(lambda kb: jax.random.normal(kb, (M,), jworld.dtype))(
            jax.random.split(k, B))

    return np.asarray(jax.jit(jax.vmap(one))(keys))


def jax_draws(name, jplanner, jworld, key, T):
    """(initial state, the planner's draws, (T, B, M) noise) of
    ``run(key, B, T)`` in the JAX package."""
    if name == "random_discrete":
        k_init, k_run = jax.random.split(key)
        k_plan, k_meas = jax.vmap(jax.random.split, out_axes=1)(jax.random.split(k_run, T))
        gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (B, jworld.num_actions), jworld.dtype))
        return (jworld.init_state(k_init, B), np.asarray(gumbel(k_plan)),
                step_noise(jworld, k_meas, jworld.H.shape[1]))
    k_init, k_wp, k_run = jax.random.split(key, 3)
    wps = jplanner.waypoint_list(k_wp, B)
    T = wps.shape[1] if T is None else min(T, wps.shape[1])
    draws = None
    if name == "random_continuous":
        draws = np.asarray(jax.random.uniform(k_wp, wps.shape, jworld.dtype))
    noise = step_noise(jworld, jax.random.split(k_run, T), jworld.m_max_cont)
    return jworld.init_state(k_init, B), draws, noise


_RUNS = {}


def run_both(name, jcfg, think=0.0, seed=0):
    """(JAX result, port result), each pair computed once per module."""
    key = (name, think, seed, jcfg.evaluation.use_effective_mission_time)
    if key not in _RUNS:
        _RUNS[key] = _run_both(name, jcfg, think, seed)
    return _RUNS[key]


def _run_both(name, jcfg, think, seed):
    fields, T = PLANNERS[name]
    jworld = JaxWorld(jcfg, dtype=jnp.float64)
    jplanner = getattr(jsp, CLASSES[name])(jworld, JaxMissionConfig(type=name, **fields))
    key = jax.random.key(seed)
    want = jplanner.run(key, B, max_steps=T, think_time_per_step=think)
    state0, draws, noise = jax_draws(name, jplanner, jworld, key, T)

    world = IPPWorld(port_cfg(jcfg), dtype=F64, device="cpu")
    planner = getattr(sp, CLASSES[name])(world, MissionConfig(type=name, **fields))
    if name == "random_discrete":  # lattice steps: the action table's M
        shape, M = (T, B, world.num_actions), world.H.shape[1]
    else:
        shape, M = (B, None, 3), world.m_max_cont
    got = planner.run(
        B, max_steps=T, think_time_per_step=think,
        init_state=belief_state_from_arrays(state0, device="cpu", dtype=F64),
        noise=draws_from_arrays(noise, (T, B, M), "cpu", F64),
        draws=None if draws is None else draws_from_arrays(draws, shape, "cpu", F64),
    )
    return want, got


def assert_same_run(got, want):
    assert got.waypoints.shape == want.waypoints.shape
    np.testing.assert_array_equal(got.waypoints, np.asarray(want.waypoints))
    np.testing.assert_array_equal(got.num_steps, np.asarray(want.num_steps))
    np.testing.assert_allclose(got.budgets, want.budgets, rtol=1e-12)
    np.testing.assert_allclose(got.flight_times, want.flight_times, rtol=1e-12)
    assert set(got.metrics) == set(want.metrics)
    for k in want.metrics:
        np.testing.assert_allclose(got.metrics[k], want.metrics[k], rtol=1e-10, atol=1e-12)
    for f in ("cov", "mean", "pos", "budget", "step", "active"):
        np.testing.assert_allclose(getattr(got.final_state, f).numpy(),
                                   np.asarray(getattr(want.final_state, f)), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("step_size", [5.0, 2.5])
def test_lawnmower_waypoints_equal(step_size, small_cfg, canonical_cfg):
    for jcfg in (small_cfg, canonical_cfg):
        np.testing.assert_array_equal(sp.lawnmower_waypoints(port_cfg(jcfg), step_size),
                                      jsp.lawnmower_waypoints(jcfg, step_size))


@pytest.mark.parametrize("num", [20, 100])
def test_spiral_waypoints_equal(num, small_cfg, canonical_cfg):
    for jcfg in (small_cfg, canonical_cfg):
        np.testing.assert_array_equal(sp.spiral_waypoints(port_cfg(jcfg), num),
                                      jsp.spiral_waypoints(jcfg, num))


@pytest.mark.parametrize("name", list(PLANNERS))
def test_baseline_run_matches_jax(name, small_cfg):
    want, got = run_both(name, small_cfg)
    assert_same_run(got, want)
    # budget truncation ended some mission inside the run, and the
    # measurements lowered the uncertainty
    assert np.isnan(want.waypoints).any() or name == "random_discrete"
    unc = got.metrics["uncertainty"]
    assert np.all(unc[:, -1] < unc[:, 0])
    if name == "random_discrete":  # hops respect the 11.5 m cap
        wps = np.concatenate([np.tile([[[2.0, 2.0, 14.0]]], (B, 1, 1)), got.waypoints], axis=1)
        for b in range(B):
            path = wps[b][~np.isnan(wps[b, :, 0])]
            assert np.all(np.linalg.norm(np.diff(path, axis=0), axis=1) < 11.5)


@pytest.mark.parametrize("name", ["lawnmower", "random_discrete"])
def test_think_time_matches_jax(name, small_cfg):
    """Effective mission time (tests/test_planners.py's oracle): the think
    time is charged per step, so the missions take fewer steps, in both
    packages alike."""
    cfg_eff = dataclasses.replace(small_cfg,
                                  evaluation=EvaluationConfig(use_effective_mission_time=True))
    want, got = run_both(name, cfg_eff, think=3.0)
    assert_same_run(got, want)
    _, plain = run_both(name, small_cfg)
    assert np.all(got.num_steps < plain.num_steps)


def test_random_discrete_draws_its_own(small_cfg):
    """Without injected draws the planner draws from its generator:
    repeatable from a seed, feasible hops, different missions."""
    world = IPPWorld(port_cfg(small_cfg), dtype=F64, device="cpu")
    planner = sp.RandomDiscretePlanner(world, MissionConfig(type="random_discrete"))
    a = planner.run(4, max_steps=6, generator=torch.Generator().manual_seed(3))
    b = planner.run(4, max_steps=6, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.waypoints, b.waypoints)
    assert not np.array_equal(a.waypoints[0], a.waypoints[1])
    rc = sp.RandomContinuousPlanner(world, MissionConfig(type="random_continuous"))
    res = rc.run(2, generator=torch.Generator().manual_seed(4))
    con, env = world.cfg.constraints, world.cfg.environment
    ok = ~np.isnan(res.waypoints[..., 0])
    assert res.waypoints.shape[1] == rc.num_waypoints() and ok.any()
    assert np.all(res.waypoints[..., 2][ok] >= con.min_altitude)
    assert np.all(res.waypoints[..., 0][ok] <= env.extent_x - con.dist_to_boundaries)


def test_draws_from_arrays_checks_the_shape():
    """Injected draws are held to the shape the caller names, None
    leaving an axis free; a wrong rank or length raises."""
    x = np.zeros((2, 3, 4))
    assert draws_from_arrays(x, (2, None, 4), "cpu", F64).shape == (2, 3, 4)
    for bad in ((2, 3), (2, 3, 5), (None, None, None, None)):
        with pytest.raises(ValueError, match="draws must have shape"):
            draws_from_arrays(x, bad, "cpu", F64)
