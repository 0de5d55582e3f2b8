"""The plain small-SPD functions at the kernels' large-M route (13 ≤ M ≤ 32)
against the JAX package, and the resolution-2 world that needs it.

At M = 13, 16, 25 and 32 in float64, on numpy-seeded inputs: the port's
``spd_inverse`` against the JAX package's ``smallchol.spd_inverse`` (and
the Pallas kernel ``spd_inverse_pallas`` in interpret mode at M = 13:
interpret mode takes ~10 s there and minutes at M = 25), ``spd_inverse_factor``
against ``spd_cholesky_dense(spd_inverse(S))``, ``spd_trace_product_packed``
against ``spd_trace_product`` and ``edge_factor_gain`` against the JAX
search's edge tail (``kf_gain_factor_t``'s Wcᵀ and the masked sum of its
squares, ipp_rl_tpu/planners/zero/mcts.py:187-207), all to rtol 1e-12:
the same unrolled recurrence, only the order of a few sums (the gain's,
the GEMMs') differs.  The JAX functions run eagerly, operation by
operation: compiling their unrolled programs takes minutes at M = 25.

example.yaml on a 20 × 20 grid at resolution 2 (the same 40 m field) has
M = 25 on the lattice and in the continuous world, A = 800 and N = 400;
its H, R, Z and sweep plan equal the JAX package's bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ipp_rl_tpu.config.schema import config_from_dict as jax_config_from_dict
from ipp_rl_tpu.env.world import _continuous_mmax as jax_continuous_mmax
from ipp_rl_tpu.ops import smallchol as jax_smallchol
from ipp_rl_tpu.ops.kalman import kf_gain_factor_t as jax_kf_gain_factor_t
from ipp_rl_tpu.ops.pallas_kernels import spd_inverse_pallas
from ipp_rl_tpu.ops.sensor_model import (
    build_action_table as jax_table,
    build_sweep_plan as jax_plan,
)
from ipp_rl_tpu_torch.config import CONFIG_DIR, config_from_dict
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kernels, smallchol
from ipp_rl_tpu_torch.ops.sensor_model import build_action_table, build_sweep_plan

from test_torch_zero_search import one_thread  # noqa: F401,E402 (an autouse fixture)

LARGE_M = [13, 16, 25, 32]
TOL = dict(rtol=1e-12, atol=1e-14)
#: example.yaml's field on a finer grid: 20 x 20 cells of 2 m
FINE_GRID = {"x_dim": 20, "y_dim": 20, "resolution": 2}


def fine_grid_raw():
    with open(CONFIG_DIR / "example.yaml") as f:
        raw = yaml.safe_load(f)
    raw["environment"] = dict(FINE_GRID)
    return raw


def random_spd(rng, batch, M):
    A = rng.normal(size=(batch, M, M))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(M)


def close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("M", LARGE_M)
def test_spd_inverse_matches_jax(M):
    rng = np.random.default_rng(M)
    S = random_spd(rng, 5, M)
    got = smallchol.spd_inverse(torch.from_numpy(S))
    close(got, jax_smallchol.spd_inverse(jnp.asarray(S)))
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(S), rtol=1e-8,
                               atol=1e-10 * np.abs(np.linalg.inv(S)).max())
    # the kernel wrapper takes the plain version on CPU tensors, at any M
    assert torch.equal(kernels.spd_inverse(torch.from_numpy(S)), got)


def test_spd_inverse_matches_the_pallas_kernel_at_m13():
    rng = np.random.default_rng(113)
    S = random_spd(rng, 5, 13)
    got = smallchol.spd_inverse(torch.from_numpy(S))
    close(got, spd_inverse_pallas(jnp.asarray(S), tile=8, interpret=True))


@pytest.mark.parametrize("M", LARGE_M)
def test_spd_inverse_factor_matches_jax(M):
    rng = np.random.default_rng(100 + M)
    S = random_spd(rng, 4, M)
    inv, U = smallchol.spd_inverse_factor(torch.from_numpy(S))
    want_inv = jax_smallchol.spd_inverse(jnp.asarray(S))
    close(inv, want_inv)
    close(U, jax_smallchol.spd_cholesky_dense(want_inv))
    assert torch.equal(torch.triu(U, 1), torch.zeros_like(U))


@pytest.mark.parametrize("M", LARGE_M)
def test_packed_trace_product_matches_jax(M):
    """Packed entries-major (outer, T, inner) blocks against the JAX
    package's unrolled trace product on the full blocks."""
    rng = np.random.default_rng(200 + M)
    outer, inner = 2, 3
    S = random_spd(rng, outer * inner, M)
    G = random_spd(rng, outer * inner, M)
    T = smallchol.packed_size(M)
    Sp, Gp = (smallchol.pack_lower(torch.from_numpy(X)).view(outer, inner, T)
              .transpose(1, 2).contiguous() for X in (S, G))
    got = smallchol.spd_trace_product_packed(Sp, Gp)
    Sj, Gj = jnp.asarray(S), jnp.asarray(G)
    want = jax_smallchol.spd_trace_product(lambda i, j: Sj[..., i, j],
                                           lambda i, j: Gj[..., i, j], M)
    close(got.reshape(-1), want)
    exact = np.einsum("bij,bji->b", np.linalg.inv(S), G)
    np.testing.assert_allclose(got.reshape(-1).numpy(), exact, rtol=1e-8)


@pytest.mark.parametrize("M", LARGE_M)
def test_edge_factor_gain_matches_jax_edge_tail(M):
    """Per mission: P (N, N) SPD, an action's H (M, N) and R (M,), a 0/1
    mask; S_raw = A·Hᵀ and A = H·P as the search forms them."""
    rng = np.random.default_rng(300 + M)
    B, N, actions = 3, 48, 5
    X = rng.normal(size=(B, N, N))
    P = X @ np.swapaxes(X, -1, -2) / N + 0.1 * np.eye(N)
    H = rng.normal(size=(actions, M, N)) / N ** 0.5
    R = rng.uniform(0.5, 1.5, size=(actions, M))
    a = rng.integers(0, actions, size=B)
    mask = (rng.random((B, N)) > 0.4).astype(np.float64)
    A = H[a] @ P
    WcT, gain = smallchol.edge_factor_gain(
        torch.from_numpy(A @ np.swapaxes(H[a], -1, -2)), torch.from_numpy(A),
        torch.from_numpy(R), torch.from_numpy(a), torch.from_numpy(mask))
    for b in range(B):  # the JAX tail runs per mission, unbatched, as the search vmaps it
        want_wct, _ = jax_kf_gain_factor_t(jnp.asarray(P[b]), jnp.asarray(H[a[b]]),
                                           jnp.asarray(R[a[b]]))
        want_wct = np.asarray(want_wct)
        close(WcT[b], want_wct)
        close(gain[b], np.sum(np.sum(want_wct * want_wct, axis=-2) * mask[b]))


@pytest.fixture(scope="module")
def fine_grid():
    raw = fine_grid_raw()
    jcfg, cfg = jax_config_from_dict(raw), config_from_dict(raw)
    return jcfg, cfg, jax_table(jcfg), build_action_table(cfg)


def test_fine_grid_has_m25(fine_grid):
    jcfg, cfg, jt, tt = fine_grid
    assert (tt.num_actions, cfg.environment.num_cells) == (800, 400)
    assert tt.H.shape == (800, 25, 400)
    world = IPPWorld(cfg, device="cpu")
    assert world.m_max_cont == jax_continuous_mmax(jcfg) == 25


def test_fine_grid_tables_and_sweep_plan_equal(fine_grid):
    jcfg, cfg, jt, tt = fine_grid
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
