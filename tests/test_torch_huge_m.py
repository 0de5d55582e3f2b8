"""The plain small-SPD functions at the kernels' CTA route (M ≥ 33).

At M = 33 in float64, on numpy-seeded inputs, each of the four plain
versions against the JAX package run eagerly (``jax.disable_jit()``: its
unrolled programs take minutes to compile at this M), to rtol 1e-12:
``spd_inverse`` against ``smallchol.spd_inverse``, ``spd_inverse_factor``
against ``spd_cholesky_dense(spd_inverse(S))``, ``spd_trace_product_packed``
against ``spd_trace_product``, and ``edge_factor_gain`` against the JAX
search's edge tail (``kf_gain_factor_t``'s Wcᵀ and the masked sum of its
squares, ipp_rl_tpu/planners/zero/mcts.py:187-207).  The Pallas kernel is
not run in interpret mode here: that takes minutes at this M.

At M = 49, 81 and 121 (the 1.5 m and 1 m grids' lattice and continuous
M), through the kernel wrappers on CPU tensors (which take the plain
versions there) against numpy float64 (``np.linalg.inv``,
``np.linalg.cholesky``, ``np.trace(np.linalg.solve(S, G))`` and the
factor's Wcᵀ), to rtol 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.ops import smallchol as jax_smallchol
from ipp_rl_tpu.ops.kalman import kf_gain_factor_t as jax_kf_gain_factor_t
from ipp_rl_tpu_torch.ops import kernels, smallchol

from test_torch_zero_search import one_thread  # noqa: F401,E402 (an autouse fixture)

JAX_TOL = dict(rtol=1e-12, atol=1e-14)
NUMPY_RTOL = 1e-8
HUGE_M = [49, 81, 121]
FUNCTIONS = ["spd_inverse", "spd_inverse_factor", "spd_trace_product", "edge_factor_gain"]


def random_spd(rng, batch, M):
    A = rng.normal(size=(batch, M, M))
    return A @ np.swapaxes(A, -1, -2) / M + 0.5 * np.eye(M)


def packed(S, outer, inner):
    """(outer * inner, M, M) → the (outer, T, inner) entries-major layout."""
    T = smallchol.packed_size(S.shape[-1])
    return (smallchol.pack_lower(torch.from_numpy(S)).view(outer, inner, T)
            .transpose(1, 2).contiguous())


def edge_case(rng, M, B=2, N=40, actions=3):
    """Per mission: P (N, N) SPD, an action's H (M, N) and R (M,), a 0/1
    mask; S_raw = A·Hᵀ and A = H·P as the search forms them."""
    X = rng.normal(size=(B, N, N))
    P = X @ np.swapaxes(X, -1, -2) / N + 0.1 * np.eye(N)
    H = rng.normal(size=(actions, M, N)) / N ** 0.5
    R = rng.uniform(0.5, 1.5, size=(actions, M))
    a = rng.integers(0, actions, size=B)
    mask = (rng.random((B, N)) > 0.4).astype(np.float64)
    A = H[a] @ P
    return P, H, R, a, mask, A


def edge_args(P, H, R, a, mask, A):
    return (torch.from_numpy(A @ np.swapaxes(H[a], -1, -2)), torch.from_numpy(A),
            torch.from_numpy(R), torch.from_numpy(a), torch.from_numpy(mask))


def close_to_jax(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_TOL["rtol"],
                               atol=JAX_TOL["atol"] * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_plain_versions_match_jax_eagerly_at_m33(fn):
    M = 33
    rng = np.random.default_rng(M + FUNCTIONS.index(fn))
    with jax.disable_jit():
        if fn == "spd_inverse":
            S = random_spd(rng, 3, M)
            close_to_jax(smallchol.spd_inverse(torch.from_numpy(S)),
                         jax_smallchol.spd_inverse(jnp.asarray(S)))
        elif fn == "spd_inverse_factor":
            S = random_spd(rng, 3, M)
            inv, U = smallchol.spd_inverse_factor(torch.from_numpy(S))
            want_inv = jax_smallchol.spd_inverse(jnp.asarray(S))
            close_to_jax(inv, want_inv)
            close_to_jax(U, jax_smallchol.spd_cholesky_dense(want_inv))
            assert torch.equal(torch.triu(U, 1), torch.zeros_like(U))
        elif fn == "spd_trace_product":
            S, G = random_spd(rng, 4, M), random_spd(rng, 4, M)
            got = smallchol.spd_trace_product_packed(packed(S, 2, 2), packed(G, 2, 2))
            Sj, Gj = jnp.asarray(S), jnp.asarray(G)
            want = jax_smallchol.spd_trace_product(lambda i, j: Sj[..., i, j],
                                                   lambda i, j: Gj[..., i, j], M)
            close_to_jax(got.reshape(-1), want)
        else:
            P, H, R, a, mask, A = edge_case(rng, M)
            WcT, gain = smallchol.edge_factor_gain(*edge_args(P, H, R, a, mask, A))
            # the JAX tail runs per mission, as the search vmaps it; eagerly
            # ~7 s a mission at this M, so mission 1 of the two
            b = 1
            want, _ = jax_kf_gain_factor_t(jnp.asarray(P[b]), jnp.asarray(H[a[b]]),
                                           jnp.asarray(R[a[b]]))
            want = np.asarray(want)
            close_to_jax(WcT[b], want)
            close_to_jax(gain[b], np.sum(np.sum(want * want, axis=-2) * mask[b]))


def numpy_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=NUMPY_RTOL,
                               atol=NUMPY_RTOL * 1e-2 * np.abs(want).max())


@pytest.mark.parametrize("M", HUGE_M)
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_kernel_wrappers_on_cpu_match_numpy(fn, M):
    """The wrappers take CPU tensors to the plain versions at any M (at M =
    49 held bitwise against the plain version itself)."""
    rng = np.random.default_rng(1000 * M + FUNCTIONS.index(fn))
    if fn == "spd_inverse":
        S = random_spd(rng, 2, M)
        got = kernels.spd_inverse(torch.from_numpy(S))
        numpy_close(got, np.linalg.inv(S))
        plain = [smallchol.spd_inverse(torch.from_numpy(S))] if M == 49 else None
        got = [got]
    elif fn == "spd_inverse_factor":
        S = random_spd(rng, 2, M)
        got = kernels.spd_inverse_factor(torch.from_numpy(S))
        inv = np.linalg.inv(S)
        numpy_close(got[0], inv)
        numpy_close(got[1], np.linalg.cholesky(inv))
        plain = smallchol.spd_inverse_factor(torch.from_numpy(S)) if M == 49 else None
    elif fn == "spd_trace_product":
        S, G = random_spd(rng, 2, M), random_spd(rng, 2, M)
        Sp, Gp = packed(S, 1, 2), packed(G, 1, 2)
        got = [kernels.spd_trace_product_packed(Sp, Gp)]
        numpy_close(got[0][0], [np.trace(np.linalg.solve(s, g)) for s, g in zip(S, G)])
        plain = [smallchol.spd_trace_product_packed(Sp, Gp)] if M == 49 else None
    else:
        P, H, R, a, mask, A = edge_case(rng, M, N=M + 7)
        args = edge_args(P, H, R, a, mask, A)
        got = kernels.edge_factor_gain(*args)
        S = A @ np.swapaxes(H[a], -1, -2) + np.stack([np.diag(R[k]) for k in a])
        U = np.linalg.cholesky(np.linalg.inv(S))
        WcT = np.swapaxes(U, -1, -2) @ A
        numpy_close(got[0], WcT)
        numpy_close(got[1], np.sum(np.sum(WcT * WcT, axis=-2) * mask, axis=-1))
        plain = smallchol.edge_factor_gain(*args) if M == 49 else None
    if plain is not None:
        for g, p in zip(got, plain):
            assert torch.equal(g, p)
