"""example.yaml's field on grids whose M needs the kernels' CTA route.

- 12 × 12 cells of 1.5 m (an 18 m field): lattice M = 49, continuous 49;
- 16 × 16 cells of 1 m (a 16 m field): lattice M = 81, continuous 121.

Their H, R, Z tables, sweep plans and ``m_max_cont`` equal the JAX
package's bit for bit (both build them in numpy).  One greedy step of the
1.5 m world at B = 2 in float64, the port's plain path against the JAX
package's, from JAX's initial state and noise: actions identical, the
step's sweep rewards and the beliefs after it to rtol 1e-10.  The JAX
side runs eagerly (``jax.disable_jit()``: its unrolled programs take
minutes to compile at M = 49) one piece at a time: its ``sweep_rewards``
on the batch, the greedy choice (the first feasible maximum, as
``GreedyPlanner.plan``) and ``kf_update`` for mission 0 (mission 1's
commit is held against the numpy Joseph form).  Its whole
``GreedyPlanner.run`` is not run: eagerly, the vmapped commit of
``step_index`` alone took 220 s on a CPU at this M, one mission's
``kf_update`` 23 s.  One greedy step of the 1 m world in float64 against a numpy oracle: the sweep's gains tr(S⁻¹·H·P·D·P·Hᵀ) and
the Joseph-form commit, rtol 1e-9.  The 1 m world's continuous M = 121
is held in the kernel tests (test_torch_huge_m.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ipp_rl_tpu.config.schema import config_from_dict as jax_config_from_dict
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.env.world import _continuous_mmax as jax_continuous_mmax
from ipp_rl_tpu.ops.kalman import kf_update as jax_kf_update
from ipp_rl_tpu.ops.sensor_model import (
    build_action_table as jax_table,
    build_sweep_plan as jax_plan,
)
from ipp_rl_tpu.planners.base import sweep_rewards as jax_sweep_rewards
from ipp_rl_tpu_torch.config import CONFIG_DIR, MissionConfig, config_from_dict
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, noise_from_arrays
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops.kalman import kf_sweep_gains_batched
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask
from ipp_rl_tpu_torch.ops.sensor_model import build_action_table, build_sweep_plan
from ipp_rl_tpu_torch.planners import GreedyPlanner
from ipp_rl_tpu_torch.planners.base import sweep_rewards

from test_torch_greedy import jax_run_draws
from test_torch_zero_search import one_thread  # noqa: F401,E402 (an autouse fixture)

#: name: (environment, lattice M, continuous M, A, N)
GRIDS = {
    "18m_at_1.5m": ({"x_dim": 12, "y_dim": 12, "resolution": 1.5}, 49, 49, 288, 144),
    "16m_at_1m": ({"x_dim": 16, "y_dim": 16, "resolution": 1}, 81, 121, 512, 256),
}


def grid_raw(name):
    with open(CONFIG_DIR / "example.yaml") as f:
        raw = yaml.safe_load(f)
    raw["environment"] = dict(GRIDS[name][0])
    return raw


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_tables_sweep_plan_and_m_equal_jax(name):
    raw = grid_raw(name)
    jcfg, cfg = jax_config_from_dict(raw), config_from_dict(raw)
    _, m_lattice, m_cont, A, N = GRIDS[name]
    jt, tt = jax_table(jcfg), build_action_table(cfg)
    assert (tt.num_actions, cfg.environment.num_cells) == (A, N)
    assert tt.H.shape == (A, m_lattice, N)
    for f in dataclasses.fields(jt):
        if f.name == "lattice":
            for g in dataclasses.fields(jt.lattice):
                np.testing.assert_array_equal(getattr(tt.lattice, g.name),
                                              getattr(jt.lattice, g.name))
        else:
            np.testing.assert_array_equal(getattr(tt, f.name), getattr(jt, f.name))
    env = jcfg.environment
    jp = jax_plan(jt, x_dim=env.x_dim, y_dim=env.y_dim)
    tp = build_sweep_plan(tt, x_dim=env.x_dim, y_dim=env.y_dim)
    np.testing.assert_array_equal(tp.perm, jp.perm)
    assert (tp.needs_q, tp.x_dim, tp.y_dim) == (jp.needs_q, jp.x_dim, jp.y_dim)
    assert len(tp.groups) == len(jp.groups)
    for tg, jg in zip(tp.groups, jp.groups):
        for f in dataclasses.fields(jg):
            a, b = getattr(tg, f.name), getattr(jg, f.name)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    world = IPPWorld(cfg, device="cpu")
    assert world.m_max_cont == jax_continuous_mmax(jcfg) == m_cont


def joseph_commit(P, mean, H, R, z):
    """(mean', P') of the Kalman commit in the Joseph form, P' symmetrised."""
    S = H @ P @ H.T + np.diag(R)
    K = P @ H.T @ np.linalg.inv(S)
    I_KH = np.eye(P.shape[-1]) - K @ H
    P_next = I_KH @ P @ I_KH.T + K @ np.diag(R) @ K.T
    return mean + K @ (z - H @ mean), 0.5 * (P_next + P_next.T)


def test_greedy_step_at_m49_matches_jax():
    raw = grid_raw("18m_at_1.5m")
    B, key = 2, jax.random.key(21)
    jworld = JaxWorld(jax_config_from_dict(raw), dtype=jnp.float64)
    state0, noise = jax_run_draws(jworld, key, B, 1)
    with jax.disable_jit():
        want_rewards, costs = (np.asarray(x) for x in jax_sweep_rewards(jworld, state0))
    ok = (costs > 0) & (costs <= np.asarray(state0.budget)[:, None])
    want_actions = np.argmax(np.where(ok, want_rewards, -np.inf), axis=-1)

    world = IPPWorld(config_from_dict(raw), dtype=torch.float64, device="cpu")
    init = belief_state_from_arrays(state0, device="cpu", dtype=torch.float64)
    got_rewards, _ = sweep_rewards(world, init)
    np.testing.assert_allclose(got_rewards.numpy(), want_rewards, rtol=1e-10)
    got = GreedyPlanner(world, MissionConfig(type="greedy")).run(
        B, max_steps=1, init_state=init,
        noise=noise_from_arrays(noise, device="cpu", dtype=torch.float64))
    np.testing.assert_array_equal(got.waypoints[:, 0], world.actions_xyz[want_actions].numpy())

    H, R, Z = (np.asarray(x) for x in (jworld.H, jworld.R_diag, jworld.Z))
    std = np.asarray(jworld.noise_std)
    gt, mean, cov = (np.asarray(x) for x in (state0.ground_truth, state0.mean, state0.cov))
    for b, a in enumerate(want_actions):
        z = np.clip(Z[a] @ gt[b] + std[a] * noise[0, b], 0.0, 1.0)
        if b == 0:
            with jax.disable_jit():
                want_mean, want_cov = jax_kf_update(jnp.asarray(cov[b]), jnp.asarray(mean[b]),
                                                    jnp.asarray(H[a]), jnp.asarray(R[a]),
                                                    jnp.asarray(z))
        else:
            want_mean, want_cov = joseph_commit(cov[b], mean[b], H[a], R[a], z)
        np.testing.assert_allclose(got.final_state.cov[b].numpy(), np.asarray(want_cov),
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(got.final_state.mean[b].numpy(), np.asarray(want_mean),
                                   rtol=1e-10, atol=1e-13)


def test_greedy_step_at_m81_matches_a_numpy_oracle():
    cfg = config_from_dict(grid_raw("16m_at_1m"))
    world = IPPWorld(cfg, dtype=torch.float64, device="cpu")
    assert world.H.shape[1] == 81
    B = 2
    state = world.init_state(B, torch.Generator().manual_seed(3))
    scen = cfg.scenario
    mask = adaptive_mask(state.mean, torch.diagonal(state.cov, dim1=-2, dim2=-1),
                         scen.value_threshold, scen.interval_factor)
    gains = kf_sweep_gains_batched(state.cov, world.sweep_batched, mask).numpy()

    P, m = state.cov.numpy(), mask.numpy()
    H, R = world.H.numpy(), world.R_diag.numpy()
    for b in range(B):
        Q = P[b] @ (m[b][:, None] * P[b])
        S = H @ P[b] @ H.swapaxes(-1, -2) + np.stack([np.diag(r) for r in R])
        G = H @ Q @ H.swapaxes(-1, -2)
        want = np.trace(np.linalg.solve(S, G), axis1=-2, axis2=-1)
        np.testing.assert_allclose(gains[b], want, rtol=1e-9, atol=1e-12 * want.max())

    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    action = planner.plan(state, None, 0)
    noise = torch.from_numpy(np.random.default_rng(4).normal(size=(B, 81)))
    after = world.step_index(state, action, noise=noise)
    for b in range(B):
        a = int(action[b])
        z = np.clip(world.Z[a].numpy() @ state.ground_truth[b].numpy()
                    + world.noise_std[a].item() * noise[b].numpy(), 0.0, 1.0)
        want_mean, want_cov = joseph_commit(P[b], state.mean[b].numpy(), H[a], R[a], z)
        np.testing.assert_allclose(after.cov[b].numpy(), want_cov, rtol=1e-9,
                                   atol=1e-12 * np.abs(want_cov).max())
        np.testing.assert_allclose(after.mean[b].numpy(), want_mean, rtol=1e-9,
                                   atol=1e-12 * np.abs(want_mean).max())
