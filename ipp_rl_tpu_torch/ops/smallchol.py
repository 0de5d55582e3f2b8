"""Unrolled small-SPD linear algebra — the plain PyTorch versions.

Port of ``ipp_rl_tpu/ops/smallchol.py``.  For a static small M (9 on
the canonical config) the Cholesky factorisation, the triangular inverse
and the S⁻¹ = L⁻ᵀL⁻¹ product are unrolled into elementwise operations on
batch-shaped tensors, exactly as in the JAX package.

These are the reference implementations of the hand-written CUDA kernels
in ``csrc/smallchol.cu``: ``ops/kernels.py`` calls them for CPU tensors,
and the tests and ``chip_smoke.py`` hold the kernels against them.  The
kernels perform the same operations in the same order, one rounding per
operation (built without FMA contraction), so on the card the two agree
to the last bit on the same inputs.

All functions treat the last two axes as the matrix and broadcast over
leading batch axes; only the lower triangle of S (and of G) is read.
"""

from __future__ import annotations

import torch

#: pivots below this are clamped before the square root (as in the TPU
#: kernel, ipp_rl_tpu/ops/pallas_kernels.py), so an indefinite S gives a
#: finite, huge inverse instead of NaN
PIVOT_FLOOR = 1e-30


def cholesky_ll(S: torch.Tensor) -> list:
    """Lower Cholesky factor of (..., M, M) SPD matrices as a list of
    lists of (...) tensors, L[i][j] for j <= i."""
    M = S.shape[-1]
    L = [[None] * M for _ in range(M)]
    for j in range(M):
        acc = S[..., j, j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(acc, min=PIVOT_FLOOR))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, M):
            acc = S[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc * inv_d
    return L


def _invert_lower(L: list, M: int) -> list:
    """Inverse of an unrolled lower-triangular factor (forward substitution)."""
    Li = [[None] * M for _ in range(M)]
    for j in range(M):
        Li[j][j] = 1.0 / L[j][j]
        for i in range(j + 1, M):
            acc = None
            for k in range(j, i):
                t = L[i][k] * Li[k][j]
                acc = t if acc is None else acc + t
            Li[i][j] = -acc / L[i][i]
    return Li


def _inverse_entry(Li: list, M: int, i: int, j: int) -> torch.Tensor:
    """S⁻¹[i][j] = Σ_{k ≥ max(i, j)} Li[k][i] · Li[k][j]."""
    acc = None
    for k in range(max(i, j), M):
        t = Li[k][i] * Li[k][j]
        acc = t if acc is None else acc + t
    return acc


def spd_inverse(S: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of small SPD matrices: S⁻¹ = L⁻ᵀ L⁻¹."""
    M = S.shape[-1]
    Li = _invert_lower(cholesky_ll(S), M)
    rows = [
        torch.stack([_inverse_entry(Li, M, i, j) for j in range(M)], dim=-1)
        for i in range(M)
    ]
    return torch.stack(rows, dim=-2)


def spd_trace_product(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """tr(S⁻¹ · G) for SPD S and SYMMETRIC G, (..., M, M) → (...):
    Cholesky → triangular inverse → Σ_{i>=j} (2−δ_ij)·S⁻¹[i,j]·G[i,j],
    never forming S⁻¹.  This is the all-action sweep's per-action output
    (ops/kalman.py)."""
    M = S.shape[-1]
    Li = _invert_lower(cholesky_ll(S), M)
    total = None
    for i in range(M):
        for j in range(i + 1):
            term = _inverse_entry(Li, M, i, j) * G[..., i, j]
            if i != j:
                term = term + term
            total = term if total is None else total + term
    return total


def spd_cholesky_dense(S: torch.Tensor) -> torch.Tensor:
    """Dense (..., M, M) lower Cholesky via the unrolled recurrence."""
    M = S.shape[-1]
    L = cholesky_ll(S)
    zero = torch.zeros_like(S[..., 0, 0])
    rows = [
        torch.stack([L[i][j] if j <= i else zero for j in range(M)], dim=-1)
        for i in range(M)
    ]
    return torch.stack(rows, dim=-2)
