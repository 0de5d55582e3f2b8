"""The port's continuous-waypoint world against the JAX package's:
``m_max_cont``, ``measurement_model_at`` and ``step_position``
(ipp_rl_tpu/env/world.py:58-76, :183-250, :323-360).

Tolerances: the measurement model's H, Z and valid rows are held exactly
(cell indices, block weights 1, 1/2, 1/4, 1/k and the padded rows are
exact in both dtypes); its R to 4 ulps of the dtype (rtol 1e-15 in
float64, 5e-7 in float32), because torch's and XLA's ``exp`` may round
the altitude-dependent variance one ulp apart.  ``step_position`` in
float64 with the noise the JAX keys draw: covariances and means atol
1e-10, positions and steps exact, budgets rtol 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import load_config as jax_load_config
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, noise_from_arrays
from ipp_rl_tpu_torch.env.world import IPPWorld

from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

R_RTOL = {torch.float64: 1e-15, torch.float32: 5e-7}
JAX_DT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def worlds(name, small_cfg, dtype):
    if name == "small":
        jcfg, cfg = small_cfg, port_cfg(small_cfg)
    else:
        jcfg, cfg = jax_load_config(str(CONFIG_DIR / name)), load_config(str(CONFIG_DIR / name))
    return JaxWorld(jcfg, dtype=JAX_DT[dtype]), IPPWorld(cfg, dtype=dtype, device="cpu")


def probe_positions(cfg, n=200, seed=0):
    """Seeded positions over and past the box (clipped FoVs at the edges),
    with altitudes across the band, exactly 10 m and just above it (the rf
    jump), and on cell boundaries (where a floor decides the FoV)."""
    rng = np.random.default_rng(seed)
    env, con = cfg.environment, cfg.constraints
    pos = np.stack([rng.uniform(-3.0, env.extent_x + 3.0, n),
                    rng.uniform(-3.0, env.extent_y + 3.0, n),
                    rng.uniform(con.min_altitude - 1.0, con.max_altitude + 1.0, n)], axis=1)
    pos[:30, 2] = 10.0
    pos[30:60, 2] = np.nextafter(10.0, 11.0)
    pos[60:80, :2] = rng.integers(0, env.x_dim + 1, (20, 2)) * env.resolution
    pos[80:90, :2] = 0.0
    pos[90:100, 0] = env.extent_x
    return pos


@pytest.mark.parametrize("name", ["small", "example.yaml", "temperature_cmaes.yaml"])
def test_m_max_cont_matches_jax(name, small_cfg):
    jworld, world = worlds(name, small_cfg, torch.float64)
    assert world.m_max_cont == jworld.m_max_cont
    if name != "small":
        assert world.m_max_cont == 9  # inside the kernels' M = 1..12


CASES = [(n, d) for n in ("small", "example.yaml") for d in (torch.float64, torch.float32)]


@pytest.mark.parametrize("name,dtype", CASES, ids=[f"{n}-{str(d)[6:]}" for n, d in CASES])
def test_measurement_model_at_matches_jax(name, dtype, small_cfg):
    jworld, world = worlds(name, small_cfg, dtype)
    pos = probe_positions(world.cfg)
    want = jax.jit(jax.vmap(jworld.measurement_model_at))(jnp.asarray(pos, JAX_DT[dtype]))
    jH, jR, jZ, jvalid = map(np.asarray, want)
    H, R, Z, valid = world.measurement_model_at(torch.as_tensor(pos).to(dtype))
    M, n = world.m_max_cont, world.cfg.environment.num_cells
    assert H.shape == Z.shape == (len(pos), M, n) and R.shape == valid.shape == (len(pos), M)
    assert H.dtype == R.dtype == Z.dtype == dtype and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(H.numpy(), jH)
    np.testing.assert_array_equal(Z.numpy(), jZ)
    np.testing.assert_allclose(R.numpy(), jR, rtol=R_RTOL[dtype], atol=0)
    # both sides of the rf jump and the padded rows are exercised
    assert valid.sum(-1).min() < valid.sum(-1).max() == M
    assert torch.all(R[~valid] == 1.0) and torch.all(H[~valid] == 0.0)


def test_measurement_model_at_matches_the_table_on_lattice(small_cfg):
    """tests/test_world.py's oracle: at the lattice points the continuous
    model reproduces the ActionTable, two implementations of one rule."""
    world = IPPWorld(port_cfg(small_cfg), dtype=torch.float64, device="cpu")
    t = world.table
    H, R, Z, valid = world.measurement_model_at(torch.from_numpy(t.lattice.xyz))
    for a in range(t.num_actions):
        m = int(t.num_meas[a])
        np.testing.assert_allclose(H[a, :m].numpy(), t.H[a, :m], atol=1e-12)
        np.testing.assert_allclose(Z[a, :m].numpy(), t.Z[a, :m], atol=1e-12)
        np.testing.assert_allclose(R[a, :m].numpy(), t.R_diag[a, :m], atol=1e-12)
        assert bool(valid[a, :m].all()) and not bool(valid[a, m:].any())
        assert torch.all(H[a, m:] == 0.0) and torch.all(R[a, m:] == 1.0)


def jax_step_noise(jworld, key, B):
    M = jworld.m_max_cont
    return np.stack([np.asarray(jax.random.normal(k, (M,), jworld.dtype))
                     for k in jax.random.split(key, B)])


def test_step_position_matches_jax(small_cfg):
    """Three commits at seeded waypoints with one mission inactive in the
    second: the JAX package commits it and keeps its old belief, so must
    the port."""
    B = 4
    jworld, world = worlds("small", small_cfg, torch.float64)
    jstate = jworld.init_state(jax.random.key(0), B)
    state = belief_state_from_arrays(jstate, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(3)
    env, con = world.cfg.environment, world.cfg.constraints
    for t in range(3):
        wp = np.stack([rng.uniform(0, env.extent_x, B), rng.uniform(0, env.extent_y, B),
                       rng.uniform(con.min_altitude, con.max_altitude, B)], axis=1)
        if t == 1:
            jstate = jstate.replace(active=jnp.asarray([True, False, True, True]))
            state = state.replace(active=torch.tensor([True, False, True, True]))
        key = jax.random.key(50 + t)
        noise = jax_step_noise(jworld, key, B)
        before = state
        jstate = jworld.step_position(jstate, jnp.asarray(wp), key)
        state = world.step_position(state, torch.from_numpy(wp),
                                    noise_from_arrays(noise[None], "cpu", torch.float64)[0])
        if t == 1:
            for f in ("cov", "mean", "pos", "budget", "step"):
                assert torch.equal(getattr(state, f)[1], getattr(before, f)[1])
    np.testing.assert_allclose(state.cov.numpy(), np.asarray(jstate.cov), atol=1e-10)
    np.testing.assert_allclose(state.mean.numpy(), np.asarray(jstate.mean), atol=1e-10)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_allclose(state.budget.numpy(), np.asarray(jstate.budget), rtol=1e-12)
    np.testing.assert_array_equal(state.step.numpy(), np.asarray(jstate.step))


def test_step_index_vs_step_position(small_cfg):
    """tests/test_world.py's oracle in the port: committing at a lattice
    action and at its position with the same noise gives the same belief."""
    world = IPPWorld(port_cfg(small_cfg), dtype=torch.float64, device="cpu")
    s = world.init_state(2, torch.Generator().manual_seed(1))
    a = torch.tensor([5, 20])
    assert world.H.shape[1] == world.m_max_cont
    noise = torch.randn((2, world.m_max_cont), generator=torch.Generator().manual_seed(7),
                        dtype=torch.float64)
    s_idx = world.step_index(s, a, noise)
    s_pos = world.step_position(s, world.actions_xyz[a], noise)
    np.testing.assert_allclose(s_idx.mean.numpy(), s_pos.mean.numpy(), atol=1e-9)
    np.testing.assert_allclose(s_idx.cov.numpy(), s_pos.cov.numpy(), atol=1e-9)
    np.testing.assert_allclose(s_idx.budget.numpy(), s_pos.budget.numpy())
