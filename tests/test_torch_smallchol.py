"""The port's plain small-SPD functions (ipp_rl_tpu_torch/ops/smallchol.py)
against the JAX package: the Pallas kernel in interpret mode, its XLA twin
and the unrolled trace product, on the same numpy-seeded inputs.

Tolerances: float64 rtol 1e-10 (the same unrolled recurrence; only the
rounding of a few hundred operations differs), float32 rtol 1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ipp_rl_tpu.ops import smallchol as jax_smallchol
from ipp_rl_tpu.ops.pallas_kernels import spd_inverse_pallas
from ipp_rl_tpu_torch.ops import kernels, smallchol

TOL = {np.float64: dict(rtol=1e-10, atol=1e-12), np.float32: dict(rtol=1e-4, atol=1e-5)}


def random_spd(rng, batch, M):
    A = rng.normal(size=(batch, M, M))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(M)


def indefinite(rng, batch, M):
    """SPD except the last pivot, which goes negative and is clamped."""
    S = random_spd(rng, batch, M)
    S[:, -1, -1] -= 2.0 * np.trace(S, axis1=-2, axis2=-1)
    return S


@pytest.mark.parametrize(
    "batch,M,dtype", [(37, 9, np.float64), (37, 9, np.float32), (5, 4, np.float64)]
)
def test_spd_inverse_matches_pallas_and_xla(batch, M, dtype):
    rng = np.random.default_rng(batch * 100 + M)
    S = random_spd(rng, batch, M).astype(dtype)
    got = smallchol.spd_inverse(torch.from_numpy(S)).numpy()
    # one tile: interpret mode costs seconds per grid step
    pallas = np.asarray(spd_inverse_pallas(jnp.asarray(S), tile=64, interpret=True))
    xla = np.asarray(jax_smallchol.spd_inverse(jnp.asarray(S)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    np.testing.assert_allclose(got, xla, **TOL[dtype])
    np.testing.assert_allclose(got, np.swapaxes(got, -1, -2), rtol=0, atol=0)


def test_spd_inverse_clamps_indefinite_pivot():
    """An indefinite S hits the 1e-30 pivot floor: finite, huge entries,
    identical to the Pallas kernel's, not NaN."""
    rng = np.random.default_rng(3)
    S = indefinite(rng, 37, 9)
    got = smallchol.spd_inverse(torch.from_numpy(S)).numpy()
    pallas = np.asarray(spd_inverse_pallas(jnp.asarray(S), tile=64, interpret=True))
    assert np.all(np.isfinite(got))
    assert np.abs(got[:, -1, -1]).min() == pytest.approx(1e30, rel=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch,M", [(41, 9), (6, 3)])
def test_spd_trace_product_matches_jax(dtype, batch, M):
    rng = np.random.default_rng(batch + M)
    S = random_spd(rng, batch, M).astype(dtype)
    G = random_spd(rng, batch, M).astype(dtype)
    got = smallchol.spd_trace_product(torch.from_numpy(S), torch.from_numpy(G)).numpy()
    Sj, Gj = jnp.asarray(S), jnp.asarray(G)
    want = np.asarray(
        jax_smallchol.spd_trace_product(
            lambda i, j: Sj[..., i, j], lambda i, j: Gj[..., i, j], M
        )
    )
    assert got.shape == (batch,)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    exact = np.einsum("bij,bji->b", np.linalg.inv(S.astype(np.float64)), G)
    np.testing.assert_allclose(got, exact, rtol=1e-8 if dtype == np.float64 else 1e-3)


def test_spd_cholesky_dense_matches_jax():
    rng = np.random.default_rng(11)
    S = random_spd(rng, 4, 9)
    got = smallchol.spd_cholesky_dense(torch.from_numpy(S)).numpy()
    want = np.asarray(jax_smallchol.spd_cholesky_dense(jnp.asarray(S)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got, np.linalg.cholesky(S), rtol=1e-10, atol=1e-12)


def test_wrappers_take_plain_path_on_cpu():
    """On CPU tensors the kernel wrappers are the plain versions and never
    count a launch."""
    rng = np.random.default_rng(5)
    S = torch.from_numpy(random_spd(rng, 3, 9))
    G = torch.from_numpy(random_spd(rng, 3, 9))
    Sp, Gp = (smallchol.pack_lower(X).T.contiguous()[None] for X in (S, G))
    before = kernels.launch_counts()
    assert torch.equal(kernels.spd_inverse(S), smallchol.spd_inverse(S))
    assert torch.equal(kernels.spd_trace_product_packed(Sp, Gp),
                       smallchol.spd_trace_product_packed(Sp, Gp))
    assert torch.equal(kernels.spd_trace_product_packed(Sp, Gp)[0],
                       smallchol.spd_trace_product(S, G))
    assert kernels.launch_counts() == before


def test_wrappers_reject_non_cuda_non_cpu_tensors():
    S = torch.eye(9, device="meta")[None]
    with pytest.raises(ValueError):
        kernels.spd_inverse(S)


@pytest.mark.parametrize("M", list(range(1, 13)))
def test_spd_inverse_factor_matches_jax(M):
    """(S⁻¹, chol(S⁻¹)) — the plain version of the edge update's kernel —
    against the JAX package's spd_cholesky_dense(spd_inverse(S)) in
    float64 (ipp_rl_tpu/ops/kalman.py:107-108)."""
    rng = np.random.default_rng(M)
    S = random_spd(rng, 17, M)
    inv, U = smallchol.spd_inverse_factor(torch.from_numpy(S))
    want_inv = jax_smallchol.spd_inverse(jnp.asarray(S))
    want_U = np.asarray(jax_smallchol.spd_cholesky_dense(want_inv))
    np.testing.assert_allclose(inv.numpy(), np.asarray(want_inv), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(U.numpy(), want_U, rtol=1e-12, atol=1e-15)
    assert not np.triu(U.numpy(), 1).any()
    np.testing.assert_allclose(U.numpy() @ np.swapaxes(U.numpy(), -1, -2),
                               np.linalg.inv(S), rtol=1e-8, atol=1e-12)


def test_spd_inverse_factor_clamps_pivots():
    """An indefinite S: the clamped pivot gives the inverse entries near
    1e30, and their factor overflows where the JAX package's does (the
    same inf and NaN entries); the plain wrapper path counts no launch."""
    rng = np.random.default_rng(7)
    S = indefinite(rng, 9, 9)
    before = kernels.launch_counts()
    inv, U = kernels.spd_inverse_factor(torch.from_numpy(S))
    assert kernels.launch_counts() == before
    want_inv = jax_smallchol.spd_inverse(jnp.asarray(S))
    want_U = np.asarray(jax_smallchol.spd_cholesky_dense(want_inv))
    assert np.all(np.isfinite(inv.numpy())) and not np.all(np.isfinite(U.numpy()))
    np.testing.assert_allclose(inv.numpy(), np.asarray(want_inv), rtol=1e-12)
    np.testing.assert_allclose(U.numpy(), want_U, rtol=1e-12, atol=1e-15)  # NaN where JAX's
    ref_inv = smallchol.spd_inverse(torch.from_numpy(S))
    assert torch.equal(inv, ref_inv)
    np.testing.assert_array_equal(U.numpy(), smallchol.spd_cholesky_dense(ref_inv).numpy())
