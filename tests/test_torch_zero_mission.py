"""The port's deploy planner (ipp_rl_tpu_torch/planners/zero/mission.py)
against the JAX package's ``ZeroPlanner.run``, in float64 on small_cfg
with the narrow 10-block network of tests/test_torch_zero_search.py: the
search path ("reference" deploy mode: Dirichlet root noise and forced
playouts on), the raw-policy bypass (no simulations) and root-parallel
workers, each fed the JAX run's own draws (its initial state, measurement
noise and search draws, following its key chain).

Tolerances: actions and step counts identical; metric curves rtol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.config.schema import MissionConfig as JaxMissionConfig
from ipp_rl_tpu.planners.zero.mission import ZeroPlanner as JaxPlanner
from ipp_rl_tpu_torch.config import MCTSZeroHyperParams, MissionConfig
from ipp_rl_tpu_torch.convert import belief_state_from_arrays
from ipp_rl_tpu_torch.planners.zero.mission import ReplanDraws, ZeroPlanner

from test_torch_zero_search import (  # noqa: F401 (fixtures)
    B, F64, HORIZON, HP, NARROW, env, gumbel, jax_search_draws, one_thread,
)


def jax_run_draws(world, key, steps, sims, W=1):
    """The initial state, measurement noise and per-step search draws of
    ``ZeroPlanner.run(key, B, steps)`` in the JAX package."""
    k_init, k_run = jax.random.split(key)
    state0 = world.init_state(k_init, B)
    A, M = world.num_actions, world.H.shape[1]
    noise, draws = [], []
    for k in jax.random.split(k_run, steps):
        k_plan, k_meas = jax.random.split(k)
        noise.append(np.asarray(jax.vmap(lambda kb: jax.random.normal(kb, (M,), jnp.float64))(
            jax.random.split(k_meas, B))))
        k_search, k_tie = jax.random.split(k_plan)
        keys = [k_search] if W == 1 else list(jax.random.split(k_search, W))
        draws.append(ReplanDraws(
            search=[jax_search_draws(kw, sims, A) for kw in keys] if sims > 0 else [],
            tie=torch.from_numpy(gumbel(jax.random.split(k_tie, B), A)),
        ))
    return state0, torch.from_numpy(np.stack(noise)), draws


def planner_pair(env, mode, use_net=True, sims=None, W=1):
    jworld, world, _, nets = env
    base = dict(NARROW if use_net else HP)
    if sims is not None:
        base["num_mcts_simulations"] = sims
    jmc = JaxMissionConfig(type="mcts_zero", episode_horizon=HORIZON, hyper_params=JaxHP(**base))
    mc = MissionConfig(type="mcts_zero", episode_horizon=HORIZON,
                       hyper_params=MCTSZeroHyperParams(**base))
    (jpred, jvars), (pred, pvars) = nets
    jplanner = JaxPlanner(jworld, jmc, jpred, jvars, num_root_parallel=W, deploy_mode=mode)
    planner = ZeroPlanner(world, mc, pred, pvars, num_root_parallel=W, deploy_mode=mode)
    return jplanner, planner


def compare_runs(env, jplanner, planner, steps, sims, W=1, key=23):
    jworld = env[0]
    jkey = jax.random.key(key)
    want = jplanner.run(jkey, B, max_steps=steps)
    state0, noise, draws = jax_run_draws(jworld, jkey, steps, sims, W)
    got = planner.run(B, max_steps=steps,
                      init_state=belief_state_from_arrays(state0, device="cpu", dtype=F64),
                      noise=noise, draws=draws)
    np.testing.assert_array_equal(got.waypoints, np.asarray(want.waypoints))
    np.testing.assert_array_equal(got.num_steps, np.asarray(want.num_steps))
    for name in want.metrics:
        np.testing.assert_allclose(got.metrics[name], want.metrics[name], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.budgets, want.budgets, rtol=1e-12)
    return got


def test_zero_planner_run_matches_jax(env):
    jplanner, planner = planner_pair(env, "reference")
    got = compare_runs(env, jplanner, planner, steps=3, sims=NARROW["num_mcts_simulations"])
    unc = got.metrics["uncertainty"]
    assert np.all(unc[:, -1] < unc[:, 0])


def test_raw_policy_bypass_matches_jax(env):
    jplanner, planner = planner_pair(env, "clean", sims=0)
    compare_runs(env, jplanner, planner, steps=3, sims=0, key=29)


def test_root_parallel_sums_worker_visits(env):
    jplanner, planner = planner_pair(env, "clean", use_net=False, W=2)
    trees = []
    search = planner.mcts.search

    def spy(*args, **kw):
        out = search(*args, **kw)
        trees.append(out[0])
        return out

    planner.mcts.search = spy
    compare_runs(env, jplanner, planner, steps=2, sims=HP["num_mcts_simulations"], W=2, key=31)
    for tree in trees:
        visits = tree.Nsa[:, 0].reshape(2, B, -1).sum(dim=0)
        active = tree.Ns[:, 0].reshape(2, B) > 0
        assert active.all()
        assert visits.sum(dim=-1).tolist() == [2.0 * (HP["num_mcts_simulations"] - 1)] * B


def test_generator_runs_are_reproducible(env):
    _, planner = planner_pair(env, "reference", use_net=False)
    a = planner.run(B, max_steps=2, generator=torch.Generator().manual_seed(2))
    b = planner.run(B, max_steps=2, generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(a.waypoints, b.waypoints)
    np.testing.assert_array_equal(a.metrics["uncertainty"], b.metrics["uncertainty"])
