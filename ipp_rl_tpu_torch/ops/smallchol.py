"""Unrolled small-SPD linear algebra — the plain PyTorch versions.

Port of ``ipp_rl_tpu/ops/smallchol.py``.  For a static small M (9 on
the canonical config) the Cholesky factorisation, the triangular inverse
and the S⁻¹ = L⁻ᵀL⁻¹ product are unrolled into elementwise operations on
batch-shaped tensors, exactly as in the JAX package.

These are the reference implementations of the hand-written CUDA kernels
in ``csrc/smallchol.cu`` (``spd_inverse``, ``spd_inverse_factor``,
``spd_trace_product_packed``, ``edge_factor_gain``) and ``csrc/sweep_taps.cu``
(``sweep_tap_blocks``): ``ops/kernels.py`` calls them for CPU tensors,
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

import numpy as np
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


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as the kernels' IEEE ``sqrt`` and
    CUDA's ``torch.sqrt``.  torch's CPU kernel is not correctly rounded on
    every host (one ulp off for ~1.3% of float64 inputs on an AVX-512 AMD
    EPYC host, torch 2.13.0+cpu), numpy's is: CPU tensors go through it."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))  # 0-d stays an array
    return torch.sqrt(x)


def _cholesky(s, M: int) -> list:
    """Unrolled Cholesky of the SPD matrix whose entry (i, j), i >= j, is
    the tensor s(i, j); L[i][j] for j <= i."""
    L = [[None] * M for _ in range(M)]
    for j in range(M):
        acc = s(j, j)
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        L[j][j] = _sqrt(torch.clamp(acc, min=PIVOT_FLOOR))
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


def _dense_lower(L: list, M: int) -> torch.Tensor:
    """(..., M, M) lower-triangular matrix of the unrolled entries L[i][j],
    j <= i, zeros above."""
    zero = torch.zeros_like(L[0][0])
    rows = [
        torch.stack([L[i][j] if j <= i else zero for j in range(M)], dim=-1)
        for i in range(M)
    ]
    return torch.stack(rows, dim=-2)


def spd_cholesky_dense(S: torch.Tensor) -> torch.Tensor:
    """Dense (..., M, M) lower Cholesky via the unrolled recurrence."""
    return _dense_lower(cholesky_ll(S), S.shape[-1])


def small_mm(Sm: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(…, M, M) @ (…, M, N) in the JAX package's ``_small_mm`` order
    (ipp_rl_tpu/ops/kalman.py:113-126): row m is Sm[m,0]·X[0], then
    + Sm[m,k]·X[k] for k = 1..M−1, zero terms kept.  The edge update's
    Wcᵀ = Uᵀ·A (here and in ``ops/kalman.kf_gain_factor_t``) and the
    kernel ``edge_factor_gain`` take this order."""
    M = X.shape[-2]
    rows = []
    for m in range(M):
        acc = None
        for k in range(M):
            t = Sm[..., m, k, None] * X[..., k, :]
            acc = t if acc is None else acc + t
        rows.append(acc)
    return torch.stack(rows, dim=-2)


def spd_inverse_factor(S: torch.Tensor) -> tuple:
    """(S⁻¹, U) for (..., M, M) SPD S, with U the lower Cholesky factor of
    S⁻¹ (U·Uᵀ = S⁻¹): the two steps of the search's edge update
    (ipp_rl_tpu/ops/kalman.py:107-108, kf_gain_factor_t), one after the
    other, so the kernel that fuses them stays bitwise equal to this."""
    S_inv = spd_inverse(S)
    return S_inv, spd_cholesky_dense(S_inv)


#: lanes of the warp whose summation order :func:`warp_order_sum` spells out
WARP = 32


def warp_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis (length N) in the order of one warp: lane l
    adds x[l], x[l + 32], x[l + 64], … in turn (zeros past N), then the
    lanes' sums are halved pairwise, 16, 8, 4, 2, 1 apart (the kernel's
    xor-shuffle tree: a + b equals b + a bit for bit)."""
    N = x.shape[-1]
    chunks = -(-N // WARP)
    v = torch.nn.functional.pad(x, (0, chunks * WARP - N)).unflatten(-1, (chunks, WARP))
    acc = v[..., 0, :]
    for c in range(1, chunks):
        acc = acc + v[..., c, :]
    w = WARP // 2
    while w:
        acc = acc[..., :w] + acc[..., w:2 * w]
        w //= 2
    return acc[..., 0]


def edge_factor_gain(
    S_raw: torch.Tensor,
    A: torch.Tensor,
    R_table: torch.Tensor,
    a: torch.Tensor,
    diag_mask: torch.Tensor | None = None,
    round_bf16: bool = False,
) -> tuple:
    """The small-matrix tail of the search's edge update, per mission b:
    (Wcᵀ (B, M, N), gain (B,)) from S_raw = A·Hᵀ (B, M, M), A = H·P
    (B, M, N), the world's R table (num_actions, M), the actions a (B,)
    and a mask (N,) or (B, N) or None:

      S    = 0.5·(S_raw + S_rawᵀ) + diag(R[a])
      U    = chol(S⁻¹)                       (spd_inverse_factor's algebra)
      Wcᵀ  = Uᵀ·A in the JAX package's ``_small_mm`` order: row m is
             U[0,m]·A[0], then + U[k,m]·A[k] for k = 1..M−1, zero terms kept
      Wcᵀ  = Wcᵀ rounded to bfloat16 and back, if ``round_bf16``
      sq_n = Σ_m Wcᵀ[m,n]², m in order, × mask
      gain = warp_order_sum(sq)

    (ipp_rl_tpu/planners/zero/mcts.py:187-207 with ipp_rl_tpu/ops/kalman.py:88-126.)
    Every sum is written out in the order the kernel ``edge_factor_gain``
    of csrc/smallchol.cu takes, so the two agree to the last bit."""
    M = A.shape[-2]
    S = 0.5 * (S_raw + S_raw.mT) + torch.diag_embed(R_table[a])
    Li = _invert_lower(cholesky_ll(S), M)
    U = _dense_lower(_cholesky(lambda i, j: _inverse_entry(Li, M, i, j), M), M)
    WcT = small_mm(U.mT, A)
    if round_bf16:
        WcT = WcT.to(torch.bfloat16).to(A.dtype)
    sq = None
    for m in range(M):
        t = WcT[..., m, :] * WcT[..., m, :]
        sq = t if sq is None else sq + t
    if diag_mask is not None:
        sq = sq * diag_mask
    return WcT, warp_order_sum(sq)


def sweep_tap_blocks(
    P: torch.Tensor,
    Q: torch.Tensor,
    cells: torch.Tensor,
    weights: torch.Tensor,
    R: torch.Tensor,
    jitter: float = 0.0,
    round_p: bool = False,
) -> tuple:
    """The packed, symmetrised S and G blocks (B, T, Ag) of the sweep's
    dense group from its rows' taps, per mission b, entry t = (i, j) and
    action a:

      Xs      = 0.5·(X + Xᵀ)                      X = P (rounded to bfloat16
                                                  and back if ``round_p``), Q
      inner_k = Σ_l w[j,l,a]·Xs[b, c[i,k,a], c[j,l,a]]   from 0, l in order
      S       = Σ_k w[i,k,a]·inner_k over Ps, from 0, k in order, + R[t, a]
                (+ jitter·δ_ij where jitter is nonzero)
      G       = the same over Qs

    for P (B, N, N) in the accumulation dtype, Q (B, N, N) in it or in
    bfloat16, the taps ``cells`` (Mg, KT, Ag) (int32 cell indices) and
    ``weights`` (Mg, KT, Ag), padded with (0, 0.0), and R (T, Ag), the
    packed diagonals; entry t is (i, j) in packed order.  The
    kernel ``sweep_tap_blocks`` of csrc/sweep_taps.cu takes the same
    operations in the same order, so the two agree to the last bit."""
    acc_dt = P.dtype
    B, N, _ = P.shape
    i, j = torch.tril_indices(cells.shape[0], cells.shape[0], device=P.device)
    cells = cells.long()
    ci, cj = cells[i], cells[j]  # (T, KT, Ag)
    wi, wj = weights[i], weights[j]
    KT = cells.shape[1]

    def blocks(X):
        Xs = (0.5 * (X + X.mT)).reshape(B, N * N)
        acc = torch.zeros((B,) + ci[:, 0].shape, dtype=acc_dt, device=P.device)
        for k in range(KT):
            base = ci[:, k] * N
            inner = torch.zeros_like(acc)
            for l in range(KT):
                inner = inner + wj[:, l] * Xs[:, base + cj[:, l]]
            acc = acc + wi[:, k] * inner
        return acc

    Pa = P.to(torch.bfloat16).to(acc_dt) if round_p else P
    S = blocks(Pa) + R
    if jitter:
        S = S + jitter * (i == j).to(acc_dt)[:, None]
    return S, blocks(Q.to(acc_dt))
