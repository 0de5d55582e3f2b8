"""Unrolled small-SPD linear algebra — the plain PyTorch versions.

Port of ``ipp_rl_tpu/ops/smallchol.py``.  For a static small M (9 on
the canonical config) the Cholesky factorisation, the triangular inverse
and the S⁻¹ = L⁻ᵀL⁻¹ product are unrolled into elementwise operations on
batch-shaped tensors, exactly as in the JAX package.

These are the reference implementations of the hand-written CUDA kernels
in ``csrc/smallchol.cu`` (``spd_inverse``, ``spd_inverse_factor``,
``spd_trace_product_packed``): ``ops/kernels.py`` calls them for CPU tensors,
and the tests and ``chip_smoke.py`` hold the kernels against them.  The
kernels perform the same operations in the same order, one rounding per
operation (built without FMA contraction), so on the card the two agree
to the last bit on the same inputs.

The full-block functions treat the last two axes as the matrix and
broadcast over leading batch axes; only the lower triangle of S (and of
G) is read.  :func:`spd_trace_product_packed` reads the lower triangles
already packed, entries-major, which is the layout its kernel loads with
whole-warp contiguous reads.
"""

from __future__ import annotations

import torch

#: pivots below this are clamped before the square root (as in the TPU
#: kernel, ipp_rl_tpu/ops/pallas_kernels.py), so an indefinite S gives a
#: finite, huge inverse instead of NaN
PIVOT_FLOOR = 1e-30


def packed_index(i: int, j: int) -> int:
    """Position of entry (i, j), i >= j, in a packed lower triangle: the
    rows of the triangle one after another, k = i(i+1)/2 + j."""
    return i * (i + 1) // 2 + j


def packed_size(M: int) -> int:
    return M * (M + 1) // 2


def _cholesky(s, M: int) -> list:
    """Unrolled Cholesky of the SPD matrix whose entry (i, j), i >= j, is
    the tensor s(i, j); L[i][j] for j <= i."""
    L = [[None] * M for _ in range(M)]
    for j in range(M):
        acc = s(j, j)
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(acc, min=PIVOT_FLOOR))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, M):
            acc = s(i, j)
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc * inv_d
    return L


def cholesky_ll(S: torch.Tensor) -> list:
    """Lower Cholesky factor of (..., M, M) SPD matrices as a list of
    lists of (...) tensors, L[i][j] for j <= i."""
    return _cholesky(lambda i, j: S[..., i, j], S.shape[-1])


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


def _trace_product(s, g, M: int) -> torch.Tensor:
    Li = _invert_lower(_cholesky(s, M), M)
    total = None
    for i in range(M):
        for j in range(i + 1):
            term = _inverse_entry(Li, M, i, j) * g(i, j)
            if i != j:
                term = term + term
            total = term if total is None else total + term
    return total


def spd_trace_product(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """tr(S⁻¹ · G) for SPD S and SYMMETRIC G, (..., M, M) → (...):
    Cholesky → triangular inverse → Σ_{i>=j} (2−δ_ij)·S⁻¹[i,j]·G[i,j],
    never forming S⁻¹."""
    return _trace_product(lambda i, j: S[..., i, j], lambda i, j: G[..., i, j], S.shape[-1])


def packed_m(T: int) -> int:
    """M of a packed lower triangle of T entries."""
    M = int(round(((8 * T + 1) ** 0.5 - 1) / 2))
    if packed_size(M) != T:
        raise ValueError(f"{T} entries are no packed lower triangle")
    return M


def spd_trace_product_packed(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """:func:`spd_trace_product` on packed lower triangles in the
    entries-major layout (outer, T, inner) → (outer, inner): entry (i, j)
    of block (o, n) is ``S[o, packed_index(i, j), n]``, T = M(M+1)/2.
    The same operations in the same order, so the two agree to the last
    bit on the same blocks.  This is the all-action sweep's per-action
    output (ops/kalman.py)."""
    M = packed_m(S.shape[-2])
    return _trace_product(
        lambda i, j: S[..., packed_index(i, j), :],
        lambda i, j: G[..., packed_index(i, j), :],
        M,
    )


def pack_lower(S: torch.Tensor) -> torch.Tensor:
    """(..., M, M) → (..., T): the packed lower triangles."""
    i, j = torch.tril_indices(S.shape[-1], S.shape[-1], device=S.device)
    return S[..., i, j]


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


def spd_inverse_factor(S: torch.Tensor) -> tuple:
    """(S⁻¹, U) for (..., M, M) SPD S, with U the lower Cholesky factor of
    S⁻¹ (U·Uᵀ = S⁻¹): the two steps of the search's edge update
    (ipp_rl_tpu/ops/kalman.py:107-108, kf_gain_factor_t), one after the
    other, so the kernel that fuses them stays bitwise equal to this."""
    S_inv = spd_inverse(S)
    return S_inv, spd_cholesky_dense(S_inv)
