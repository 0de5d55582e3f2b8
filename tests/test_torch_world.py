"""The port's host precompute, priors, fields and world transitions
against the JAX package on the same inputs: configs, ActionTable and
SweepPlan arrays (exactly equal), GP priors and the GRF (float64 rtol
1e-12; the GRF float32 atol 1e-5, as both FFTs run in complex64), and
``step_index`` after k steps with the same ground truth and the noise the
JAX keys draw (float64 atol 1e-10)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import load_config as jax_load_config
from ipp_rl_tpu.env import fields as jfields
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.ops import priors as jpriors
from ipp_rl_tpu.ops.sensor_model import (
    build_action_table as jax_table,
    build_sweep_plan as jax_plan,
)
from ipp_rl_tpu_torch.config import CONFIG_DIR, config_from_dict, load_config
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, noise_from_arrays
from ipp_rl_tpu_torch.env import fields
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import priors
from ipp_rl_tpu_torch.ops.sensor_model import build_action_table, build_sweep_plan


def port_cfg(jax_cfg):
    """The port's Config holding the same values as a JAX-package Config."""
    return config_from_dict(_as_raw(jax_cfg))


def _as_raw(cfg):
    d = dataclasses.asdict(cfg)
    sensor = d["sensor"]
    return {
        "environment": d["environment"],
        "sensor": {
            "type": sensor["type"], "encoding": sensor["encoding"],
            "field_of_view": {"angle_x": sensor["angle_x"], "angle_y": sensor["angle_y"]},
            "model": {"type": sensor["model_type"], "coeff_a": sensor["coeff_a"],
                      "coeff_b": sensor["coeff_b"]},
            "simulation": {"type": sensor["simulation_type"],
                           "cluster_radius": sensor["cluster_radius"],
                           "dataset_filename": sensor["dataset_filename"]},
        },
        "mapping": d["mapping"],
        "experiment": {
            "title": d["title"], "constraints": d["constraints"], "scenario": d["scenario"],
            "uav": d["uav"], "missions": d["missions"], "evaluation": d["evaluation"],
        },
    }


@pytest.mark.parametrize("name", ["example.yaml", "temperature_cmaes.yaml"])
def test_configs_load_equal(name):
    path = str(CONFIG_DIR / name)
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(jax_load_config(path))


@pytest.mark.parametrize("name", ["example.yaml", "temperature_cmaes.yaml"])
def test_port_configs_are_copies_of_the_jax_ones(name):
    """The port reads its own YAMLs, byte-for-byte copies of the JAX
    package's, which load to equal dataclasses in both packages."""
    jax_dir = pathlib.Path(__file__).resolve().parents[1] / "ipp_rl_tpu" / "config"
    assert CONFIG_DIR.resolve() != jax_dir
    assert (CONFIG_DIR / name).read_bytes() == (jax_dir / name).read_bytes()
    assert dataclasses.asdict(load_config(str(CONFIG_DIR / name))) == dataclasses.asdict(
        jax_load_config(str(jax_dir / name))
    )


def test_small_cfg_round_trips(small_cfg):
    assert dataclasses.asdict(port_cfg(small_cfg)) == dataclasses.asdict(small_cfg)


@pytest.mark.parametrize("which", ["small", "canonical"])
def test_action_table_and_sweep_plan_equal(which, small_cfg, canonical_cfg):
    jcfg = small_cfg if which == "small" else canonical_cfg
    cfg = port_cfg(jcfg)
    jt, tt = jax_table(jcfg), build_action_table(cfg)
    for f in dataclasses.fields(jt):
        if f.name == "lattice":
            for g in dataclasses.fields(jt.lattice):
                np.testing.assert_array_equal(
                    getattr(tt.lattice, g.name), getattr(jt.lattice, g.name)
                )
        else:
            np.testing.assert_array_equal(getattr(tt, f.name), getattr(jt, f.name))
    env = jcfg.environment
    jp = jax_plan(jt, x_dim=env.x_dim, y_dim=env.y_dim)
    tp = build_sweep_plan(tt, x_dim=env.x_dim, y_dim=env.y_dim)
    np.testing.assert_array_equal(tp.perm, jp.perm)
    assert (tp.needs_q, tp.x_dim, tp.y_dim) == (jp.needs_q, jp.x_dim, jp.y_dim)
    assert len(tp.groups) == len(jp.groups) == 2
    for tg, jg in zip(tp.groups, jp.groups):
        for f in dataclasses.fields(jg):
            a, b = getattr(tg, f.name), getattr(jg, f.name)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def test_gp_priors_match(canonical_cfg):
    cfg = port_cfg(canonical_cfg)
    want = np.asarray(jpriors.gp_prior_cov(canonical_cfg))
    got = priors.gp_prior_cov(cfg, device="cpu", dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    d = torch.from_numpy(priors.cell_center_distances(cfg))
    for nu in (0.5, 2.5):
        np.testing.assert_allclose(
            priors.matern_kernel(d, 1.3, 2.1, nu).numpy(),
            np.asarray(jpriors.matern_kernel(jnp.asarray(d.numpy()), 1.3, 2.1, nu)),
            rtol=1e-12,
        )
    # the shuffled prior, given the unit draws the JAX key makes
    key = jax.random.key(4)
    k1, k2 = jax.random.split(key)
    u = torch.tensor([float(jax.random.uniform(k1, ())), float(jax.random.uniform(k2, ()))],
                     dtype=torch.float64)
    np.testing.assert_allclose(
        priors.shuffled_gp_prior_cov(cfg, u).numpy(),
        np.asarray(jpriors.shuffled_gp_prior_cov(canonical_cfg, key)),
        rtol=1e-12,
    )


def test_random_spd_prior_matches(small_cfg):
    cfg = port_cfg(small_cfg)
    key = jax.random.key(9)
    n = small_cfg.environment.num_cells
    normal = np.array(jax.random.normal(key, (n, n)))
    want = np.asarray(jpriors.random_spd_prior_cov(small_cfg, key))
    got = priors.random_spd_prior_cov(cfg, torch.from_numpy(normal)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_grf_matches_given_the_same_white_noise(canonical_cfg):
    cfg = port_cfg(canonical_cfg)
    keys = jax.random.split(jax.random.key(1), 3)
    ny, nx = cfg.environment.y_dim, cfg.environment.x_dim
    white = np.stack([np.asarray(jax.random.normal(k, (ny, nx), jnp.float32)) for k in keys])
    want = np.stack([np.asarray(jfields.gaussian_random_field(canonical_cfg, k)) for k in keys])
    got = fields.gaussian_random_field_from_noise(cfg, torch.from_numpy(white)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, ny, nx)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _with_sensor(cfg, **changes):
    return dataclasses.replace(cfg, sensor=dataclasses.replace(cfg.sensor, **changes))


def test_hotspot_and_split_fields_match_given_the_same_draws(canonical_cfg):
    jcfg = _with_sensor(canonical_cfg, simulation_type="hotspot_random_field", cluster_radius=2)
    cfg = port_cfg(jcfg)
    ny, nx, r = 10, 10, 2
    keys = jax.random.split(jax.random.key(2), 4)
    draws, want = [], []
    for key in keys:
        k_hi, k_lo, k_y1, k_x1, k_y2, k_x2 = jax.random.split(key, 6)
        y1 = jax.random.randint(k_y1, (), r, ny)
        x1 = jax.random.randint(k_x1, (), r, nx)
        ys, xs = jnp.arange(ny), jnp.arange(nx)
        draws.append([
            jax.random.uniform(k_hi, (), minval=0.7, maxval=1.0),
            jax.random.uniform(k_lo, (), minval=0.0, maxval=0.3),
            y1, x1,
            jfields._masked_randint(k_y2, (ys >= r) & (jnp.abs(ys - y1) > r)),
            jfields._masked_randint(k_x2, (xs >= r) & (jnp.abs(xs - x1) > r)),
        ])
        want.append(np.asarray(jfields.hotspot_random_field(jcfg, key)))
    cols = [torch.tensor(np.array([float(d[i]) for d in draws])) for i in range(6)]
    got = fields.hotspot_field_from_draws(cfg, cols[0], cols[1], *[c.long() for c in cols[2:]])
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-12)

    jcfg = _with_sensor(canonical_cfg, simulation_type="split_random_field")
    cfg = port_cfg(jcfg)
    draws, want = [], []
    for key in keys:
        k_hi, k_lo, k_swap, k_axis, k_split = jax.random.split(key, 5)
        draws.append([
            jax.random.uniform(k_hi, (), minval=0.65, maxval=1.0),
            jax.random.uniform(k_lo, (), minval=0.0, maxval=0.35),
            jax.random.uniform(k_swap) > 0.5,
            jax.random.uniform(k_axis) > 0.5,
            jax.random.randint(k_split, (), 4, 8),  # ceil(3.3), ceil(6.6) + 1
            jax.random.randint(k_split, (), 3, 8),  # floor(3.3), ceil(6.6) + 1
        ])
        want.append(np.asarray(jfields.split_random_field(jcfg, key)))
    cols = [np.array([float(d[i]) for d in draws]) for i in range(6)]
    got = fields.split_field_from_draws(
        cfg, torch.tensor(cols[0]), torch.tensor(cols[1]), torch.tensor(cols[2] > 0),
        torch.tensor(cols[3] > 0), torch.tensor(cols[4]).long(), torch.tensor(cols[5]).long(),
    )
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-12)


@pytest.mark.parametrize(
    "sim", ["gaussian_random_field", "hotspot_random_field", "split_random_field"]
)
def test_generated_worlds(sim, canonical_cfg):
    cfg = port_cfg(_with_sensor(canonical_cfg, simulation_type=sim, cluster_radius=2))
    gt = fields.generate_ground_truth(cfg, 16, torch.Generator().manual_seed(0), device="cpu")
    assert gt.shape == (16, 10, 10) and gt.dtype == torch.float32
    assert float(gt.min()) >= 0.0 and float(gt.max()) <= 1.0
    assert not torch.equal(gt[0], gt[1])
    if sim != "gaussian_random_field":  # two levels per world
        assert all(len(torch.unique(g)) == 2 for g in gt)


def test_temperature_field_matches(monkeypatch):
    path = str(CONFIG_DIR / "temperature_cmaes.yaml")
    jcfg, cfg = jax_load_config(path), load_config(path)
    datasets = str(pathlib.Path(__file__).resolve().parents[1] / "datasets")
    want = jfields.temperature_data_field(jcfg, datasets_dir=datasets)
    np.testing.assert_allclose(fields.temperature_data_field(cfg, datasets), want, rtol=1e-12)
    monkeypatch.setenv("DATASETS_DIR", datasets)
    gt = fields.generate_ground_truth(cfg, 3, device="cpu")
    np.testing.assert_allclose(gt[2].numpy(), want, rtol=1e-6)


def test_init_state_defaults(small_cfg):
    cfg = port_cfg(small_cfg)
    world = IPPWorld(cfg, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    s = world.init_state(4, gen)
    n = cfg.environment.num_cells
    assert s.mean.shape == (4, n) and s.cov.shape == (4, n, n)
    assert torch.all(s.mean == 0.5) and torch.all(s.budget == cfg.constraints.budget)
    np.testing.assert_array_equal(s.pos[0].numpy(), [2.0, 2.0, 14.0])
    assert not torch.allclose(s.ground_truth[0], s.ground_truth[1])
    shuffled = world.init_state(3, gen, shuffle_prior=True)
    assert not torch.allclose(shuffled.cov[0], shuffled.cov[1])


def test_step_index_matches_jax(small_cfg):
    """k committed measurements with the same worlds, actions and noise
    give the same belief, position, budget and metrics."""
    B, k_steps = 3, 4
    jworld = JaxWorld(small_cfg, dtype=jnp.float64)
    world = IPPWorld(port_cfg(small_cfg), dtype=torch.float64, device="cpu")
    jstate = jworld.init_state(jax.random.key(0), B)
    state = belief_state_from_arrays(jstate, device="cpu", dtype=torch.float64)
    M = world.H.shape[1]
    rng = np.random.default_rng(0)
    for t in range(k_steps):
        action = rng.integers(0, world.num_actions, size=B)
        if t == 2:  # one mission inactive: its commit must be an exact no-op
            jstate = jstate.replace(active=jnp.asarray([True, False, True]))
            state = state.replace(active=torch.tensor([True, False, True]))
        key = jax.random.key(100 + t)
        noise = np.stack([np.asarray(jax.random.normal(k, (M,), jnp.float64))
                          for k in jax.random.split(key, B)])
        before_cov = state.cov.clone()
        jstate = jworld.step_index(jstate, jnp.asarray(action, jnp.int32), key)
        state = world.step_index(state, torch.from_numpy(action),
                                 noise_from_arrays(noise[None], "cpu", torch.float64)[0])
        if t == 2:
            assert torch.equal(state.cov[1], before_cov[1])
    np.testing.assert_allclose(state.cov.numpy(), np.asarray(jstate.cov), atol=1e-10)
    np.testing.assert_allclose(state.mean.numpy(), np.asarray(jstate.mean), atol=1e-10)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_allclose(state.budget.numpy(), np.asarray(jstate.budget), rtol=1e-12)
    np.testing.assert_array_equal(state.step.numpy(), np.asarray(jstate.step))
    jm, tm = jworld.evaluate(jstate), world.evaluate(state)
    assert set(jm) == set(tm)
    for name in jm:
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]), rtol=1e-9)
