"""The 2 m grid's CMA-ES and MCTS-zero paths (chip_smoke.py phase 17)
against the JAX package, in float64 on the CPU, on numpy-seeded inputs.

example.yaml and temperature_cmaes.yaml on 20 × 20 cells of 2 m (the same
40 m field) have M = 25 rows per measurement in the continuous world, as
on the lattice, so CMA-ES's fitness and the zero search's descent launch
``edge_factor_gain`` at M = 25 there: the kernels' warp route.

- The port's ``CMAESPlanner.trajectory_loss`` (temperature_cmaes.yaml at
  2 m, B = 1, λ = 4, horizon 2) against the JAX package's
  ``_trajectory_loss`` (ipp_rl_tpu/planners/cmaes.py:155) for the last
  member (its long last leg), rtol 1e-10 as in tests/test_torch_cmaes.py:
  the same algebra, GEMM and reduction orders left to each library.
- One ``ZeroMCTS.edge_update`` (example.yaml at 2 m, two missions, a
  per-mission mask) against the JAX package's
  (ipp_rl_tpu/planners/zero/mcts.py:187) on the second mission: Wcᵀ and the gain at
  rtol 1e-12 (the same unrolled algebra; only the two GEMMs and the gain's
  summation order differ).

The JAX functions run eagerly, operation by operation, one member or
mission at a time (~10 s for the first member, ~2.5 s for each more;
vmapped or under ``jax.disable_jit()`` each operation costs 3-4 times
more): compiling
their unrolled M = 25 programs takes minutes.  So the fitness's
``lax.scan`` over the horizon runs as the Python loop that defines it
(``python_scan``), not as one compiled body."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.config.schema import MissionConfig as JaxMissionConfig
from ipp_rl_tpu.config.schema import config_from_dict as jax_config_from_dict
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.env.world import _continuous_mmax as jax_continuous_mmax
from ipp_rl_tpu.planners import cmaes as jcmaes
from ipp_rl_tpu.planners.zero.mcts import ZeroMCTS as JaxMCTS
from ipp_rl_tpu_torch.config import (
    CONFIG_DIR,
    MCTSZeroHyperParams,
    MissionConfig,
    config_from_dict,
)
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners import cmaes
from ipp_rl_tpu_torch.planners.zero.mcts import ZeroMCTS

from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

F64 = torch.float64
#: chip_smoke.py's FINE_GRID: 20 x 20 cells of 2 m
FINE_GRID = {"x_dim": 20, "y_dim": 20, "resolution": 2}
MC = dict(type="cmaes", episode_horizon=2, cma_popsize=4, cma_maxiter=2, cma_sigma=2.0)
DATASETS = str(pathlib.Path(__file__).resolve().parents[1] / "datasets")


def fine_raw(name):
    with open(CONFIG_DIR / name) as f:
        raw = yaml.safe_load(f)
    raw["environment"] = dict(FINE_GRID)
    return raw


@pytest.fixture
def datasets(monkeypatch):
    """temperature_cmaes.yaml's ground truth: the repository's dataset."""
    monkeypatch.setenv("DATASETS_DIR", DATASETS)


@pytest.mark.parametrize("name", ["example.yaml", "temperature_cmaes.yaml"])
def test_both_configs_have_m25_at_2m(name):
    raw = fine_raw(name)
    cfg, jcfg = config_from_dict(raw), jax_config_from_dict(raw)
    assert cfg.environment.num_cells == 400
    world = IPPWorld(cfg, device="cpu")
    assert world.m_max_cont == jax_continuous_mmax(jcfg) == 25
    assert world.H.shape[1] == 25


def belief(world, B, seed):
    """A GP-prior covariance per mission scaled and perturbed by a random
    SPD term (no longer the prior), a mean around 0.5, positions in the
    box and the full budget, as numpy arrays."""
    rng = np.random.default_rng(seed)
    cfg = world.cfg
    n = cfg.environment.num_cells
    prior = world.init_state(1, torch.Generator().manual_seed(seed)).cov[0].numpy()
    Q = rng.normal(size=(B, n, n))
    P = prior * rng.uniform(0.3, 1.0, size=(B, 1, 1)) + 0.1 * Q @ np.swapaxes(Q, -1, -2) / n
    mean = 0.5 + 0.2 * rng.normal(size=(B, n))
    env, con = cfg.environment, cfg.constraints
    lo = np.array([0.0, 0.0, con.min_altitude])
    hi = np.array([env.extent_x, env.extent_y, con.max_altitude])
    pos = lo + rng.random((B, 3)) * (hi - lo)
    budget = np.full((B,), float(con.budget))
    return P, mean, pos, budget, lo, hi


def python_scan(f, init, xs):
    """``jax.lax.scan`` as the Python loop its documentation defines it by,
    for a body that returns no per-step outputs."""
    carry = init
    for i in range(len(jax.tree_util.tree_leaves(xs)[0])):
        carry, y = f(carry, jax.tree_util.tree_map(lambda x: x[i], xs))
        assert y is None
    return carry, None


def test_trajectory_loss_on_the_2m_grid_matches_jax(datasets, monkeypatch):
    raw = fine_raw("temperature_cmaes.yaml")
    jcfg = jax_config_from_dict(raw)
    world = IPPWorld(config_from_dict(raw), dtype=F64, device="cpu")
    planner = cmaes.CMAESPlanner(world, MissionConfig(**MC))
    jplanner = jcmaes.CMAESPlanner(JaxWorld(jcfg, dtype=jnp.float64), JaxMissionConfig(**MC))
    assert world.m_max_cont == 25 and world.cfg.scenario.adaptive
    P, mean, pos, budget, lo, hi = belief(world, 1, seed=5)
    rng = np.random.default_rng(6)
    x = lo + rng.random((1, 4, 2, 3)) * (hi - lo)  # λ = 4 members, horizon 2
    x[0, 3, 1] = [hi[0], hi[1], lo[2]]  # a long last leg
    x = x.reshape(1, 4, 6)
    t = torch.from_numpy
    got = planner.trajectory_loss(t(x), t(P), t(mean), t(pos), t(budget))
    monkeypatch.setattr(jax.lax, "scan", python_scan)
    j = [jnp.asarray(v[0]) for v in (P, mean, pos, budget)]
    want = float(jplanner._trajectory_loss(jnp.asarray(x[0, 3]), *j))
    np.testing.assert_allclose(got[0, 3].item(), want, rtol=1e-10)
    assert bool((got < 0).all())  # every member in the box gains something


def test_zero_edge_update_on_the_2m_grid_matches_jax():
    raw = fine_raw("example.yaml")
    jcfg = jax_config_from_dict(raw)
    world = IPPWorld(config_from_dict(raw), dtype=F64, device="cpu")
    jworld = JaxWorld(jcfg, dtype=jnp.float64)
    assert world.H.shape[1] == 25 and world.num_actions == 800
    B = 2
    P, _, _, _, _, _ = belief(world, B, seed=7)
    rng = np.random.default_rng(8)
    a = rng.integers(0, world.num_actions, size=B)
    mask = (rng.random((B, 400)) > 0.4).astype(np.float64)
    mcts = ZeroMCTS(world, MCTSZeroHyperParams(), 3, None)
    t = torch.from_numpy
    WcT, gain = mcts.edge_update(t(P), t(a), t(mask))
    jmcts = JaxMCTS(jworld, JaxHP(), 3, None)
    b = 1
    want_wct, want_gain = jmcts.edge_update(jnp.asarray(P[b]), jnp.asarray(a[b]),
                                            jnp.asarray(mask[b]))
    want_wct = np.asarray(want_wct)
    np.testing.assert_allclose(WcT[b].numpy(), want_wct, rtol=1e-12,
                               atol=1e-12 * np.abs(want_wct).max())
    np.testing.assert_allclose(gain[b].item(), float(want_gain), rtol=1e-12)
