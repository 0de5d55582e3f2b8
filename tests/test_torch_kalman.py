"""The port's Kalman algebra (ipp_rl_tpu_torch/ops/kalman.py) against the
JAX package on the same numpy-seeded inputs: the Joseph commit, the gain
factors, the dense sweep oracle and the batched all-action sweep.

Tolerances: float64 commits atol 1e-10 (as tests/test_kalman.py holds the
JAX commit against numpy); float64 sweeps rtol 1e-9 (same algebra, GEMMs
summed in another order); bf16 fast_math is held to argmax agreement."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.ops import kalman as jk
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kalman as tk
from ipp_rl_tpu_torch.ops.priors import gp_prior_cov


def random_spd(rng, n):
    A = rng.normal(size=(n, n))
    return A @ A.T / n + 0.5 * np.eye(n)


@pytest.fixture
def problem():
    rng = np.random.default_rng(0)
    n, m = 25, 6
    P = random_spd(rng, n)
    H = np.zeros((m, n))
    for i in range(m):
        H[i, rng.choice(n, size=4, replace=False)] = 0.25
    R = rng.uniform(0.01, 0.1, m)
    x = rng.uniform(0, 1, n)
    z = rng.uniform(0, 1, m)
    return P, H, R, x, z


def t64(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]


def test_kf_update_matches_jax(problem):
    P, H, R, x, z = problem
    mj, Pj = jk.kf_update(*map(jnp.asarray, (P, x, H, R, z)))
    mt, Pt = tk.kf_update(*t64(P, x, H, R, z))
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-10)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-10)
    assert torch.equal(Pt, Pt.mT)


def test_kf_update_cov_only_and_plain_form(problem):
    P, H, R, x, _ = problem
    for joseph in (True, False):
        _, Pj = jk.kf_update(*map(jnp.asarray, (P, x, H, R)), z=None, joseph=joseph)
        mt, Pt = tk.kf_update(*t64(P, x, H, R), z=None, joseph=joseph)
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-10)
        np.testing.assert_array_equal(mt.numpy(), x)


def test_kf_update_padded_rows_are_noop(problem):
    P, H, R, x, z = problem
    H_pad = np.vstack([H, np.zeros((4, H.shape[1]))])
    R_pad = np.concatenate([R, np.ones(4)])
    z_pad = np.concatenate([z, 0.37 * np.ones(4)])
    m_ref, P_ref = tk.kf_update(*t64(P, x, H, R, z))
    m_pad, P_pad = tk.kf_update(*t64(P, x, H_pad, R_pad, z_pad))
    np.testing.assert_allclose(P_pad.numpy(), P_ref.numpy(), atol=1e-10)
    np.testing.assert_allclose(m_pad.numpy(), m_ref.numpy(), atol=1e-10)


def test_kf_update_zero_rows_batch_is_exact_noop(problem):
    """A mission whose H is all zero (the world's inactive-mission fold)
    keeps P and the mean bit for bit, beside an active one."""
    P, H, R, x, z = problem
    P, H, R, x, z = t64(P, H, R, x, z)
    Hb = torch.stack([H, torch.zeros_like(H)])
    mean_b, P_b = tk.kf_update(
        torch.stack([P, P]), torch.stack([x, x]), Hb, torch.stack([R, R]), torch.stack([z, z])
    )
    assert torch.equal(P_b[1], P) and torch.equal(mean_b[1], x)
    assert not torch.equal(P_b[0], P)


def test_gain_factors_match_jax(problem):
    P, H, R, _, _ = problem
    Wj, Sj = jk.kf_gain_factor(*map(jnp.asarray, (P, H, R)))
    Wt, St = tk.kf_gain_factor(*t64(P, H, R))
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-10)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=1e-10)
    WTj, _ = jk.kf_gain_factor_t(*map(jnp.asarray, (P, H, R)), jitter=1e-6)
    WTt, _ = tk.kf_gain_factor_t(*t64(P, H, R), jitter=1e-6)
    np.testing.assert_allclose(WTt.numpy(), np.asarray(WTj), atol=1e-10)
    PHj, SIj = jk.innovation_inverse(*map(jnp.asarray, (P, H, R)))
    PHt, SIt = tk.innovation_inverse(*t64(P, H, R))
    np.testing.assert_allclose(PHt.numpy(), np.asarray(PHj), atol=1e-12)
    np.testing.assert_allclose(SIt.numpy(), np.asarray(SIj), rtol=1e-10)


def _evolved_beliefs(cfg, jworld, B, seed):
    """B float64 covariances, each after a few random covariance-only commits."""
    rng = np.random.default_rng(seed)
    H = jnp.asarray(jworld.table.H)
    R = jnp.asarray(jworld.table.R_diag)
    P = jnp.asarray(gp_prior_cov(cfg, device="cpu", dtype=torch.float64).numpy())
    n = P.shape[0]
    Ps = []
    for _ in range(B):
        Ps.append(np.asarray(P))
        for _ in range(3):
            a = int(rng.integers(0, jworld.num_actions))
            _, P = jk.kf_update(P, jnp.zeros(n), H[a], R[a], z=None)
    mask = (rng.random((B, n)) > 0.4).astype(np.float64)
    return np.stack(Ps), mask


@pytest.mark.parametrize("which", ["small", "canonical"])
def test_batched_sweep_matches_jax_and_dense(which, small_cfg, canonical_cfg):
    cfg = small_cfg if which == "small" else canonical_cfg
    jworld = JaxWorld(cfg, dtype=jnp.float64)
    world = IPPWorld(cfg, dtype=torch.float64, device="cpu")
    assert {g["kind"] for g in world.sweep_batched["groups"]} == {"gather", "taps"}
    Pb, mask = _evolved_beliefs(cfg, jworld, 4, seed=7)
    H = torch.from_numpy(world.table.H)
    R = torch.from_numpy(world.table.R_diag)
    for m, jitter in ((None, 0.0), (mask, 0.0), (mask, 1e-4)):
        want = np.asarray(
            jk.kf_sweep_gains_batched(
                jnp.asarray(Pb), jworld.sweep_batched,
                None if m is None else jnp.asarray(m), jitter=jitter,
            )
        )
        mt = None if m is None else torch.from_numpy(m)
        got = tk.kf_sweep_gains_batched(torch.from_numpy(Pb), world.sweep_batched, mt, jitter)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
        dense = torch.stack(
            [tk.kf_sweep_gains(torch.from_numpy(Pb[b]), H, R,
                               None if mt is None else mt[b], jitter) for b in range(len(Pb))]
        )
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-9, atol=1e-12)


def test_dense_sweep_matches_jax(canonical_cfg):
    jworld = JaxWorld(canonical_cfg, dtype=jnp.float64)
    Pb, mask = _evolved_beliefs(canonical_cfg, jworld, 2, seed=3)
    H, R = jworld.table.H, jworld.table.R_diag
    want = np.asarray(jk.kf_sweep_gains(jnp.asarray(Pb[1]), jnp.asarray(H), jnp.asarray(R),
                                        jnp.asarray(mask[1])))
    got = tk.kf_sweep_gains(*t64(Pb[1], H, R, mask[1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


def test_fast_math_decision_agreement(canonical_cfg):
    """bf16-streamed sweeps approximate the float32 gains and agree on the
    greedy argmax (as tests/test_kalman.py::test_fast_math_decision_agreement
    holds the JAX package), for the dense oracle and the batched sweep."""
    world = IPPWorld(canonical_cfg, dtype=torch.float32, device="cpu")
    H, R = world.H, world.R_diag
    P = gp_prior_cov(canonical_cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    agree, trials, Ps = 0, 20, []
    for t in range(trials):
        g32 = tk.kf_sweep_gains(P, H, R).numpy()
        g16 = tk.kf_sweep_gains(P, H, R, fast_math=True).numpy()
        rel = np.abs(g16 - g32) / np.maximum(np.abs(g32), 1e-6)
        assert rel.max() < 0.05, f"trial {t}: rel err {rel.max():.4f}"
        agree += int(np.argmax(g32) == np.argmax(g16))
        Ps.append(P)
        a = int(rng.integers(0, world.num_actions))
        _, P = tk.kf_update(P, torch.zeros(P.shape[0]), H[a], R[a], z=None)
    assert agree >= trials - 1, f"argmax agreement {agree}/{trials}"
    Pb = torch.stack(Ps)
    fast = tk.kf_sweep_gains_batched(Pb, world.sweep_batched, fast_math=True).numpy()
    exact = tk.kf_sweep_gains_batched(Pb, world.sweep_batched).numpy()
    assert np.abs(fast - exact).max() / np.abs(exact).max() < 0.05
    assert np.sum(np.argmax(fast, 1) == np.argmax(exact, 1)) >= trials - 1
