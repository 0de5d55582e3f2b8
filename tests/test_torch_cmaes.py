"""CMA-ES: the port's ``cma_es_minimize`` and the planner's fitness
against the JAX package's (ipp_rl_tpu/planners/cmaes.py), in float64 with
the JAX key chain's normals and JAX's own eigendecompositions injected;
``replan_batch`` and ``run`` are in tests/test_torch_cmaes_run.py, on the
helpers here.

Why the eigendecompositions are JAX's own outputs, recorded while JAX's
CMA-ES runs and replayed to the port: torch's ``eigh`` agrees with JAX's
only up to the signs of the eigenvector columns, and the samples follow
the signs.  Nor is JAX's ``eigh`` of the port's covariance enough: the
initial covariance diag(σ²) repeats its scales, so after one update it
keeps an eigenvalue of multiplicity up to D − μ − 1 (4 of 6 at horizon 2,
λ 4), whose eigenvectors any last-bit difference turns freely; and XLA
contracts the covariance update into fused multiply-adds where torch
rounds each product, so the two covariances differ in the last bit.
Both choices of basis draw from the same N(0, C); replaying JAX's makes
the port's samples JAX's.  The first generation's covariance is exactly
diagonal in both, so the quadratic's test can also pass JAX's ``eigh``
of the port's covariance, as a function.

Also the edge update's algebra the fitness runs on: ``kf_gain_factor_t``
in the JAX package's ``_small_mm`` order and the per-sample edge update.

Tolerances (float64): the fitness per member rtol 1e-10; CMA-ES's best
point and loss rtol 1e-9 (the same algebra, with GEMM and reduction
orders left to each library, through 60 generations); Wcᵀ against
JAX rtol 1e-12, and bitwise between the port's two routes to it.  The
port's own draws: JAX's test's bounds (loss < 1e-2, point within 0.2)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MissionConfig as JaxMissionConfig
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.ops.kalman import kf_gain_factor_t as jax_kf_gain_factor_t
from ipp_rl_tpu.planners import cmaes as jcmaes
from ipp_rl_tpu_torch.config import MissionConfig
from ipp_rl_tpu_torch.convert import belief_state_from_arrays
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kalman
from ipp_rl_tpu_torch.planners import cmaes

from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

F64 = torch.float64
MC = dict(type="cmaes", episode_horizon=2, cma_popsize=4, cma_maxiter=2, cma_sigma=2.0)


@contextlib.contextmanager
def recorded_eigh():
    """``jnp.linalg.eigh`` recording its outputs, in the order JAX computes
    them, while a function traced inside the block runs (then and later):
    per CMA-ES generation one call per mission."""
    calls, eigh = [], jnp.linalg.eigh

    def recording(C):
        w, v = eigh(C)
        jax.debug.callback(lambda w, v: calls.append((np.array(w), np.array(v))), w, v)
        return w, v

    jnp.linalg.eigh = recording
    try:
        yield calls
    finally:
        jnp.linalg.eigh = eigh


def replay(calls, B):
    """An ``eigh`` for the port that returns JAX's recorded outputs: per
    call the next B of them (one generation of B missions), each given to
    the mission whose covariance has its eigenvalues (JAX runs a batch's
    callbacks in no fixed order)."""
    it = iter(calls)

    def eigh(C):
        gen = [next(it) for _ in range(B)]
        own = torch.linalg.eigvalsh(C).numpy()
        pick = [min(range(B), key=lambda j: np.abs(gen[j][0] - own[b]).max()) for b in range(B)]
        for b, j in enumerate(pick):
            assert np.allclose(gen[j][0], own[b], rtol=1e-12, atol=0)
        return (torch.from_numpy(np.stack([gen[j][0] for j in pick])),
                torch.from_numpy(np.stack([gen[j][1] for j in pick])))

    return eigh


def jax_eigh(C: torch.Tensor):
    """JAX's eigendecomposition of the port's (B, D, D) covariances."""
    w, v = jnp.linalg.eigh(jnp.asarray(C.numpy()))
    return torch.from_numpy(np.array(w)), torch.from_numpy(np.array(v))


def cma_normals(key, maxiter, lam, D):
    """(maxiter, λ, D): the normals cma_es_minimize draws from ``key``."""
    return np.stack([np.asarray(jax.random.normal(k, (lam, D), jnp.float64))
                     for k in jax.random.split(key, maxiter)])


# ------------------------------------------------------------------ CMA-ES

TARGET = np.array([1.0, -2.0, 3.0])


def quadratic_jax(pop):
    return jnp.sum(jnp.square(pop - jnp.asarray(TARGET)[None, :]), axis=-1)


def quadratic(pop):
    return torch.sum(torch.square(pop - torch.from_numpy(TARGET)), dim=-1)


def minimize_args():
    t = lambda x: torch.tensor(x, dtype=F64)  # noqa: E731
    return t([[0.0, 0.0, 0.0]]), t([1.0, 1.0, 1.0]), t([-10.0] * 3), t([10.0] * 3)


def test_cma_es_minimize_matches_jax_on_the_quadratic():
    """tests/test_mcts_cmaes.py's problem (popsize 16, 60 generations)."""
    key = jax.random.key(0)
    want_x, want_f = jcmaes.cma_es_minimize(
        quadratic_jax, jnp.zeros(3, jnp.float64), jnp.ones(3, jnp.float64),
        jnp.full(3, -10.0, jnp.float64), jnp.full(3, 10.0, jnp.float64), 16, 60, key)
    x0, scales, lo, hi = minimize_args()
    normals = torch.from_numpy(cma_normals(key, 60, 16, 3))[None]
    best_x, best_f = cmaes.cma_es_minimize(lambda p: quadratic(p), x0, scales, lo, hi, 16, 60,
                                           normals=normals, eigh=jax_eigh)
    np.testing.assert_allclose(best_x[0].numpy(), np.asarray(want_x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(best_f.numpy(), [float(want_f)], rtol=1e-9, atol=1e-15)
    assert float(best_f) < 1e-2


def test_cma_es_minimize_on_its_own_draws():
    """torch's eigh and generator, three problems at once: each reaches
    JAX's test's bounds."""
    x0, scales, lo, hi = minimize_args()
    x0 = torch.cat([x0, x0 + 1.0, x0 - 2.0])
    best_x, best_f = cmaes.cma_es_minimize(quadratic, x0, scales, lo, hi, 16, 60,
                                           generator=torch.Generator().manual_seed(0))
    assert best_x.shape == (3, 3) and best_f.shape == (3,)
    assert bool((best_f < 1e-2).all())
    np.testing.assert_allclose(best_x.numpy(), np.tile(TARGET, (3, 1)), atol=0.2)


def test_eigh_agrees_with_jax_up_to_column_signs():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(6, 15, 15))
    C = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(15)
    w, v = torch.linalg.eigh(torch.from_numpy(C))
    jw, jv = map(np.asarray, jnp.linalg.eigh(jnp.asarray(C)))
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-12)
    signs = np.sign(np.sum(v.numpy() * jv, axis=-2, keepdims=True))
    np.testing.assert_allclose(v.numpy() * signs, jv, atol=1e-10)


def test_selection_sorts_stably_on_ties():
    """Members on the penalty share f = 100 exactly: the stable sort keeps
    the first of them as the best and selects the first μ, as JAX does."""
    key = jax.random.key(3)

    def flat_jax(pop):
        return jnp.where(pop[:, 0] > 100.0, 0.0, 100.0)

    want_x, want_f = jcmaes.cma_es_minimize(
        flat_jax, jnp.zeros(3, jnp.float64), jnp.ones(3, jnp.float64),
        jnp.full(3, -10.0, jnp.float64), jnp.full(3, 10.0, jnp.float64), 8, 3, key)
    x0, scales, lo, hi = minimize_args()
    normals = torch.from_numpy(cma_normals(key, 3, 8, 3))[None]
    best_x, best_f = cmaes.cma_es_minimize(lambda p: torch.full(p.shape[:2], 100.0, dtype=F64),
                                           x0, scales, lo, hi, 8, 3, normals=normals,
                                           eigh=jax_eigh)
    assert float(best_f) == float(want_f) == 100.0
    # the best is the first member of the first generation
    np.testing.assert_allclose(best_x[0].numpy(), np.asarray(want_x), rtol=1e-12)
    np.testing.assert_allclose(best_x[0].numpy(), normals[0, 0, 0].numpy(), rtol=1e-12)


# ------------------------------------------------------------ the planner

@pytest.fixture(scope="module")
def setup(small_cfg):
    jworld = JaxWorld(small_cfg, dtype=jnp.float64)
    world = IPPWorld(port_cfg(small_cfg), dtype=F64, device="cpu")
    jplanner = jcmaes.CMAESPlanner(jworld, JaxMissionConfig(**MC))
    planner = cmaes.CMAESPlanner(world, MissionConfig(**MC))
    jstate = jworld.init_state(jax.random.key(1), 2)
    # one step in, so the two missions' beliefs differ from the prior
    jstate = jworld.step_position(jstate, jnp.asarray([[6.0, 10.0, 8.0], [14.0, 3.0, 14.0]]),
                                  jax.random.key(2))
    state = belief_state_from_arrays(jstate, device="cpu", dtype=F64)
    return jworld, world, jplanner, planner, jstate, state


def members(world, state, K, seed=0):
    """(B, K, D) candidate trajectories: random in-box ones, one out of the
    box, one of length zero (every waypoint at the start) and one far
    enough for its budget to run out on the way."""
    rng = np.random.default_rng(seed)
    env, con = world.cfg.environment, world.cfg.constraints
    B, H = state.batch_size, 2
    lo = np.array([0.0, 0.0, con.min_altitude])
    hi = np.array([env.extent_x, env.extent_y, con.max_altitude])
    x = lo + rng.random((B, K, H, 3)) * (hi - lo)
    x[:, 0, 0, 0] = -1.0  # out of bounds
    x[:, 1] = state.pos.numpy()[:, None, :]  # zero path
    x[:, 2] = [[0.0, 0.0, con.min_altitude], [env.extent_x, env.extent_y, con.max_altitude]]
    return x.reshape(B, K, 3 * H)


@pytest.fixture(scope="module")
def jax_losses(setup):
    """JAX's fitness of (B, K, D) members, compiled once."""
    jplanner = setup[2]
    return jax.jit(jax.vmap(lambda xs, P, m, p, b: jax.vmap(
        lambda xi: jplanner._trajectory_loss(xi, P, m, p, b))(xs)))


@pytest.mark.parametrize("budget", [None, 15.0])
def test_trajectory_loss_matches_jax(setup, jax_losses, budget):
    jworld, world, jplanner, planner, jstate, state = setup
    if budget is not None:  # the budget runs out inside the horizon
        jstate = jstate.replace(budget=jnp.full((2,), budget, jnp.float64))
        state = state.replace(budget=torch.full((2,), budget, dtype=F64))
    x = members(world, state, K=7)
    want = jax_losses(jnp.asarray(x), jstate.cov, jstate.mean, jstate.pos, jstate.budget)
    got = planner.trajectory_loss(torch.from_numpy(x), state.cov, state.mean, state.pos,
                                  state.budget)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    assert torch.all(got[:, :2] == 100.0) and bool((got[:, 3:] < 0).all())
    assert world.cfg.scenario.adaptive  # the adaptive mask is exercised


# -------------------------------------------------- the edge update's algebra

@pytest.fixture(scope="module")
def edge_inputs(canonical_cfg):
    jworld = JaxWorld(canonical_cfg, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    n, B = 100, 6
    prior = np.asarray(jworld.init_state(jax.random.key(0), 1).cov[0])
    Q = rng.normal(size=(B, n, n))
    P = prior * rng.uniform(0.3, 1.0, (B, 1, 1)) + 0.1 * Q @ np.swapaxes(Q, -1, -2) / n
    a = rng.integers(0, jworld.num_actions, B)
    mask = (rng.random((B, n)) > 0.4).astype(np.float64)
    H, R = np.asarray(jworld.H)[a], np.asarray(jworld.R_diag)[a]
    return jworld, P, a, mask, H, R


def test_kf_gain_factor_t_follows_jax_order(edge_inputs):
    """The repaired ``kf_gain_factor_t``: Wcᵀ = Uᵀ·A in ``_small_mm``'s
    order, against JAX (rtol 1e-12) and bit for bit against the edge
    update's plain version, which spells out the same order."""
    jworld, P, a, mask, H, R = edge_inputs
    want = jax.vmap(lambda p, h, r: jax_kf_gain_factor_t(p, h, r)[0])(
        jnp.asarray(P), jnp.asarray(H), jnp.asarray(R))
    t = torch.from_numpy
    WcT, S_inv = kalman.kf_gain_factor_t(t(P), t(H), t(R))
    np.testing.assert_allclose(WcT.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(want)).max())
    edge, _ = kalman.kf_edge_factor_gain(t(P), t(np.array(jworld.H)),
                                         t(np.array(jworld.R_diag)), t(a))
    assert torch.equal(WcT, edge)
    U = torch.linalg.cholesky(S_inv)
    assert not torch.equal(WcT, U.mT @ (t(H) @ t(P)))  # cuBLAS's order differs


def test_per_sample_edge_update_equals_the_table_form(edge_inputs):
    """``kf_edge_factor_gain_per_sample`` with H and R built per sample
    equals the table form on the table's rows, bit for bit, with and
    without the (B, N) mask."""
    jworld, P, a, mask, H, R = edge_inputs
    t = torch.from_numpy
    for m in (None, t(mask)):
        want = kalman.kf_edge_factor_gain(t(P), t(np.array(jworld.H)),
                                          t(np.array(jworld.R_diag)), t(a), m)
        got = kalman.kf_edge_factor_gain_per_sample(t(P), t(H), t(R), m)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cmaes_world_fits_the_kernels():
    """temperature_cmaes.yaml, the configuration CMA-ES runs: its
    continuous model has the kernels' M (9) rows and the planner its
    15-dimensional search space."""
    from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config

    cfg = load_config(str(CONFIG_DIR / "temperature_cmaes.yaml"))
    mc = cfg.missions[0]
    world = IPPWorld(cfg, device="cpu")
    planner = cmaes.CMAESPlanner(world, mc)
    assert world.m_max_cont == 9 and planner.sigma_scales.shape == (15,)
    assert dataclasses.asdict(mc)["cma_popsize"] == 12
