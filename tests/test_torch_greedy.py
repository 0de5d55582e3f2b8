"""The greedy slice end to end: the port's ``GreedyPlanner.run`` against
the JAX package's on small_cfg in float64, from the same initial state
and with the measurement noise the JAX run's keys draw (the key splits of
ipp_rl_tpu/planners/base.py:173,183,204 and env/world.py:305, reproduced
here).  The action sequences must be identical; the metric curves agree
to rtol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MissionConfig as JaxMissionConfig
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.planners.greedy import GreedyPlanner as JaxGreedy
from ipp_rl_tpu.planners.greedy import greedy_search_horizon as jax_horizon
from ipp_rl_tpu_torch.config import MissionConfig
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, noise_from_arrays
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners import GreedyPlanner, greedy_search_horizon

from test_torch_world import port_cfg


def jax_run_draws(world, key, batch_size, steps):
    """The initial state and the (T, B, M) measurement noise of
    ``GreedyPlanner.run(key, batch_size, steps)`` in the JAX package."""
    k_init, k_run = jax.random.split(key)
    state0 = world.init_state(k_init, batch_size)
    M = world.H.shape[1]
    noise = []
    for k in jax.random.split(k_run, steps):
        _, k_meas = jax.random.split(k)
        keys = jax.random.split(k_meas, batch_size)
        noise.append(jax.vmap(lambda kb: jax.random.normal(kb, (M,), world.dtype))(keys))
    return state0, np.asarray(jnp.stack(noise))


@pytest.fixture(scope="module")
def runs(small_cfg):
    B = 4
    jworld = JaxWorld(small_cfg, dtype=jnp.float64)
    jplanner = JaxGreedy(jworld, JaxMissionConfig(type="greedy"))
    T = jplanner.max_steps()
    key = jax.random.key(42)
    want = jplanner.run(key, B, max_steps=T)
    state0, noise = jax_run_draws(jworld, key, B, T)

    world = IPPWorld(port_cfg(small_cfg), dtype=torch.float64, device="cpu")
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    assert planner.max_steps() == T
    got = planner.run(
        B,
        max_steps=T,
        init_state=belief_state_from_arrays(state0, device="cpu", dtype=torch.float64),
        noise=noise_from_arrays(noise, device="cpu", dtype=torch.float64),
    )
    return want, got


def test_greedy_actions_identical(runs):
    want, got = runs
    assert got.waypoints.shape == want.waypoints.shape
    # the missions end within the step bound: mask-and-continue is exercised
    assert np.isnan(want.waypoints).any() and not np.isnan(want.waypoints).all()
    np.testing.assert_array_equal(got.waypoints, np.asarray(want.waypoints))
    np.testing.assert_array_equal(got.num_steps, np.asarray(want.num_steps))


def test_greedy_metric_curves_match(runs):
    want, got = runs
    assert set(got.metrics) == set(want.metrics)
    for name in want.metrics:
        np.testing.assert_allclose(got.metrics[name], want.metrics[name], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.budgets, want.budgets, rtol=1e-12)
    np.testing.assert_allclose(got.flight_times, want.flight_times, rtol=1e-12)
    # the greedy mission reduces the map uncertainty
    unc = got.metrics["uncertainty"]
    assert np.all(unc[:, -1] < 0.5 * unc[:, 0])


def test_greedy_generator_runs_are_reproducible(small_cfg):
    world = IPPWorld(port_cfg(small_cfg), dtype=torch.float32, fast_sweeps=True, device="cpu")
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    a = planner.run(3, max_steps=3, generator=torch.Generator().manual_seed(7))
    b = planner.run(3, max_steps=3, generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a.waypoints, b.waypoints)
    np.testing.assert_array_equal(a.metrics["rmse"], b.metrics["rmse"])
    assert a.final_state.cov.dtype == torch.float32


def test_greedy_search_horizon_matches_jax(small_cfg):
    """The multi-step hypothetical rollout (used by the CMA-ES planner)
    picks the JAX package's actions, including budget exhaustion."""
    B, horizon = 3, 8
    jworld = JaxWorld(small_cfg, dtype=jnp.float64)
    jstate = jworld.init_state(jax.random.key(3), B)
    jstate = jstate.replace(budget=jnp.asarray([60.0, 12.0, 4.0]))
    want_a, want_ok = jax_horizon(jworld, jstate, horizon)
    world = IPPWorld(port_cfg(small_cfg), dtype=torch.float64, device="cpu")
    state = belief_state_from_arrays(jstate, device="cpu", dtype=torch.float64)
    got_a, got_ok = greedy_search_horizon(world, state, horizon)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not got_ok.numpy().all()
    np.testing.assert_array_equal(got_a.numpy()[got_ok.numpy()], np.asarray(want_a)[np.asarray(want_ok)])


@pytest.fixture(scope="module")
def canonical_runs(canonical_cfg):
    """The canonical config (the port's own copy of example.yaml against the
    JAX package's) in float64: B = 4 missions for 10 steps, JAX's noise."""
    from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config

    B, T = 4, 10
    jworld = JaxWorld(canonical_cfg, dtype=jnp.float64)
    key = jax.random.key(5)
    want = JaxGreedy(jworld, JaxMissionConfig(type="greedy")).run(key, B, max_steps=T)
    state0, noise = jax_run_draws(jworld, key, B, T)
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), dtype=torch.float64,
                     device="cpu")
    got = GreedyPlanner(world, MissionConfig(type="greedy")).run(
        B, max_steps=T,
        init_state=belief_state_from_arrays(state0, device="cpu", dtype=torch.float64),
        noise=noise_from_arrays(noise, device="cpu", dtype=torch.float64),
    )
    return want, got


def test_greedy_canonical_actions_identical(canonical_runs):
    want, got = canonical_runs
    assert got.waypoints.shape == (4, 10, 3)
    np.testing.assert_array_equal(got.waypoints, np.asarray(want.waypoints))
    np.testing.assert_array_equal(got.num_steps, np.asarray(want.num_steps))


def test_greedy_canonical_metric_curves_match(canonical_runs):
    """rtol 1e-10: the same float64 products, summed in other orders."""
    want, got = canonical_runs
    assert set(got.metrics) == set(want.metrics)
    for name in want.metrics:
        np.testing.assert_allclose(got.metrics[name], want.metrics[name], rtol=1e-10)
    np.testing.assert_allclose(got.budgets, want.budgets, rtol=1e-10)
    unc = got.metrics["uncertainty"]
    assert np.all(np.diff(unc, axis=1) < 0)
