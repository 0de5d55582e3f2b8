"""Batched Kalman-filter belief updates — the numerical heart.

Port of ``ipp_rl_tpu/ops/kalman.py``.  The algebra is the JAX package's:

  S  = H P Hᵀ + R             (innovation, symmetrized)
  K  = P Hᵀ S⁻¹               (gain)
  P' = (I−KH)·P·(I−KH)ᵀ + K·R·Kᵀ   (Joseph commit)

and the planner prices an action by its masked trace reduction
tr(S⁻¹·G) with G = H·Q·Hᵀ, Q = P·diag(m)·P.

Every function broadcasts over leading batch axes (the mission axis is an
explicit dimension; nothing is vmapped).  The (M, M) inverses go through
``ops/kernels.spd_inverse`` (``spd_inverse_factor`` where the Cholesky
factor of the inverse follows; the search's edge update hands its whole
small-matrix tail to ``edge_factor_gain``) and the
sweep's per-action trace products
through ``ops/kernels.spd_trace_product_packed``: hand-written CUDA on the
card, the plain versions of ops/smallchol.py on the CPU.  The sweep builds
its S and G blocks as packed lower triangles, entries-major, which is the
layout that kernel reads.  The GEMMs, which the JAX package left to XLA,
are ``torch.matmul``; float32 products must run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False, the default).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.ops import kernels
from ipp_rl_tpu_torch.ops.smallchol import (
    packed_index,
    packed_size,
    small_mm,
    spd_cholesky_dense,
)


def _eye_like(S: torch.Tensor) -> torch.Tensor:
    return torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)


def innovation_inverse(
    P: torch.Tensor, H: torch.Tensor, R_diag: torch.Tensor, jitter: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (PHt (..., N, M), S⁻¹ (..., M, M)) with S = H P Hᵀ + diag(R)
    symmetrized."""
    PHt = P @ H.mT
    S = H @ PHt + torch.diag_embed(R_diag)
    S = 0.5 * (S + S.mT)
    if jitter:
        S = S + jitter * _eye_like(S)
    return PHt, kernels.spd_inverse(S.contiguous())


def kf_gain_factor(
    P: torch.Tensor, H: torch.Tensor, R_diag: torch.Tensor, jitter: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whitened gain factor Wc (..., N, M) with Wc Wcᵀ = P Hᵀ S⁻¹ H P, and
    S⁻¹.  Wc = P Hᵀ U with U Uᵀ = S⁻¹; trace reduction = ‖Wc‖²_F."""
    PHt, S_inv = innovation_inverse(P, H, R_diag, jitter)
    return PHt @ spd_cholesky_dense(S_inv), S_inv


def kf_gain_factor_t(
    P: torch.Tensor, H: torch.Tensor, R_diag: torch.Tensor, jitter: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transposed-layout whitened gain factor: (Wcᵀ (..., M, N), S⁻¹) with
    Wc·Wcᵀ = P·Hᵀ·S⁻¹·H·P (P symmetric)."""
    A = H @ P
    S = A @ H.mT
    S = 0.5 * (S + S.mT) + torch.diag_embed(R_diag)
    if jitter:
        S = S + jitter * _eye_like(S)
    S_inv, U = kernels.spd_inverse_factor(S.contiguous())  # U lower, U·Uᵀ = S⁻¹
    return small_mm(U.mT, A), S_inv


def kf_edge_factor_gain(
    P: torch.Tensor,
    H_table: torch.Tensor,
    R_table: torch.Tensor,
    a: torch.Tensor,
    diag_mask: Optional[torch.Tensor] = None,
    round_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search's edge update for actions ``a`` (B,) int64 against the
    running covariances P (B, N, N): (Wcᵀ (B, M, N), gain (B,)) with
    Wc·Wcᵀ = P·Hᵀ·S⁻¹·H·P for H = H_table[a], and gain = Σ_n m_n·(Wc·Wcᵀ)_nn
    for the mask (N,) or (B, N) (all ones if None).  ``round_bf16`` rounds
    Wcᵀ to bfloat16 and back before the gain, as a tree that stores its
    edges in bfloat16 does.  The two GEMMs are ``torch.matmul`` (the JAX
    package leaves them to XLA); everything after them is one launch of
    ``kernels.edge_factor_gain``."""
    H = H_table[a]
    A = H @ P  # (B, M, N) — P is symmetric for every caller
    S_raw = A @ H.mT
    return kernels.edge_factor_gain(S_raw, A, R_table, a, diag_mask, round_bf16)


def kf_edge_factor_gain_per_sample(
    P: torch.Tensor,
    H: torch.Tensor,
    R_diag: torch.Tensor,
    diag_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`kf_edge_factor_gain` for measurement models built per sample:
    H (B, M, N) and R_diag (B, M) against P (B, N, N), the mask (N,) or
    (B, N).  Returns (Wcᵀ (B, M, N), gain (B,)), the algebra of
    :func:`kf_gain_factor_t` followed by the masked trace: R_diag is the
    kernel's R table and sample b reads its row b."""
    A = H @ P
    S_raw = A @ H.mT
    a = torch.arange(H.shape[0], device=H.device)
    return kernels.edge_factor_gain(S_raw, A, R_diag.contiguous(), a,
                                    None if diag_mask is None else diag_mask.contiguous())


def kf_update(
    P: torch.Tensor,
    mean: torch.Tensor,
    H: torch.Tensor,
    R_diag: torch.Tensor,
    z: Optional[torch.Tensor] = None,
    jitter: float = 0.0,
    joseph: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Kalman commit: returns (mean', P') for P (..., N, N), mean
    (..., N), H (..., M, N), R_diag (..., M), z (..., M) or None for a
    covariance-only update.

    ``joseph=True`` commits P' = (I−KH)·P·(I−KH)ᵀ + K·diag(R)·Kᵀ, expanded
    as in the JAX package into three products with A = H·P:
      P' = P + [Kᵀ; A; Kᵀ]ᵀ · [−A; −Kᵀ; S·Kᵀ].
    Zero rows of H are an exact no-op (Kᵀ rows vanish), which the world's
    inactive-mission fold relies on.
    """
    A = H @ P  # (..., M, N) = (P·Hᵀ)ᵀ — P is kept symmetric every commit
    S = A @ H.mT
    S = 0.5 * (S + S.mT) + torch.diag_embed(R_diag)
    if jitter:
        S = S + jitter * _eye_like(S)
    S_inv = kernels.spd_inverse(S.contiguous())
    KT = S_inv @ A  # (..., M, N) = Kᵀ
    if joseph:
        SKT = S @ KT
        F = torch.cat([KT, A, KT], dim=-2)  # (..., 3M, N)
        G = torch.cat([-A, -KT, SKT], dim=-2)
        P_next = P + F.mT @ G
    else:
        P_next = P - KT.mT @ A
    P_next = 0.5 * (P_next + P_next.mT)
    if z is None:
        return mean, P_next
    v = z - (H @ mean[..., None])[..., 0]
    mean_next = mean + (KT.mT @ v[..., None])[..., 0]
    return mean_next, P_next


def kf_sweep_gains(
    P: torch.Tensor,
    H_all: torch.Tensor,
    R_all: torch.Tensor,
    diag_mask: Optional[torch.Tensor] = None,
    jitter: float = 0.0,
    fast_math: bool = False,
) -> torch.Tensor:
    """Trace reduction for EVERY action at once — the dense oracle of the
    batched sweep.  P (N, N), H_all (A, M, N), R_all (A, M) → gains (A,):

      gain_a = Σ_j m_j · (PHt_a S_a⁻¹ PHt_aᵀ)_{jj}

    ``fast_math``: the streamed P·Hᵀ and Y products are rounded to bfloat16
    while every contraction accumulates in P's dtype, as in the JAX package.
    """
    A, M, N = H_all.shape
    acc_dt = P.dtype
    stream_dt = torch.bfloat16 if fast_math else acc_dt
    H_flat = H_all.reshape(A * M, N).to(stream_dt)
    PHt = (P.to(stream_dt) @ H_flat.T).reshape(N, A, M).transpose(0, 1)  # (A, N, M)
    PHt_acc = PHt.to(acc_dt)
    S = H_all.to(stream_dt).to(acc_dt) @ PHt_acc  # (A, M, M)
    S = 0.5 * (S + S.mT) + torch.diag_embed(R_all.to(acc_dt))
    if jitter:
        S = S + jitter * _eye_like(S)
    S_inv = kernels.spd_inverse(S.contiguous())
    Y = (PHt_acc @ S_inv.to(stream_dt).to(acc_dt)).to(stream_dt)  # (A, N, M)
    sq = torch.sum(Y.to(acc_dt) * PHt_acc, dim=-1)  # (A, N)
    if diag_mask is not None:
        sq = sq * diag_mask[None, :].to(acc_dt)
    return torch.sum(sq, dim=-1)


def _packed_diag(values: np.ndarray) -> np.ndarray:
    """(..., M) → (..., T): packed lower triangles of diag(values)."""
    M = values.shape[-1]
    out = np.zeros(values.shape[:-1] + (packed_size(M),), values.dtype)
    out[..., [packed_index(i, i) for i in range(M)]] = values
    return out


def prepare_batched_sweep(plan, dtype=torch.float32, device: str | torch.device = "cuda"):
    """Device-constant bundle for :func:`kf_sweep_gains_batched` from a
    SweepPlan built with grid dims (ops/sensor_model.build_sweep_plan).

    rf == 1 groups (one-hot H rows) become GATHER groups: each action's
    innovation block is S[i, j] = P[cell_i, cell_j] (and G the same from
    Q), read with one index gather.  A window group keeps the JAX
    package's full (2r+1)² slot layout: an out-of-grid slot gets zero P/Q
    entries and 1.0 on the diagonal, an in-grid one the action's R
    (ipp_rl_tpu/ops/kalman.py:319-326).  rf > 1 groups stay DENSE with
    group-local H rows.

    Blocks are packed lower triangles (ops/smallchol.packed_index): a
    gather group's tables are (T, Ag), so that one gather yields the
    (B, T, Ag) layout of the trace-product kernel; ``eye`` is the packed
    identity as a (T, 1) column, for both groups' layouts."""
    if plan.x_dim is None or plan.y_dim is None or not plan.groups:
        raise ValueError("the batched sweep needs a SweepPlan with grid dims")
    device = resolve_device(device)
    gx, gy = plan.x_dim, plan.y_dim
    N = gx * gy
    groups = []

    def table(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    for g in plan.groups:
        if g.win_radius is not None:
            r = g.win_radius
            slots = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
            cy, cx = np.divmod(np.asarray(g.win_centers, np.int64), gx)
            yy = cy[:, None] + np.array([s[0] for s in slots])[None, :]
            xx = cx[:, None] + np.array([s[1] for s in slots])[None, :]
            valid = (yy >= 0) & (yy < gy) & (xx >= 0) & (xx < gx)
            cells = np.where(valid, yy * gx + xx, 0)
            diag = np.where(valid, np.asarray(g.win_R, np.float64)[:, None], 1.0)
        elif g.cells is not None:
            valid = np.asarray(g.valid)
            cells = np.where(valid, np.asarray(g.cells, np.int64), 0)
            diag = np.asarray(g.R, np.float64)
        else:
            Ag, Mg, _ = g.H.shape
            ti, tj = np.tril_indices(Mg)
            groups.append(
                {
                    "kind": "dense",
                    "H_flat": table(g.H.reshape(Ag * Mg, N)),
                    "H": table(g.H),
                    # row-major positions of the (i, j) and (j, i) entries, i >= j
                    "lower": table(ti * Mg + tj, torch.long),
                    "upper": table(tj * Mg + ti, torch.long),
                    "R": table(_packed_diag(np.asarray(g.R, np.float64))),  # (Ag, T)
                    "eye": table(_packed_diag(np.ones(Mg))[:, None]),
                }
            )
            continue
        K = cells.shape[1]
        ti, tj = np.tril_indices(K)
        index = (cells[:, ti] * N + cells[:, tj]).T  # (T, Ag) into P.flatten
        vv = (valid[:, ti] & valid[:, tj]).T
        groups.append(
            {
                "kind": "gather",
                "index": table(index.reshape(-1), torch.long),
                "vv": table(vv),
                "diag": table(_packed_diag(diag).T),  # (T, Ag)
                "eye": table(_packed_diag(np.ones(K))[:, None]),
            }
        )
    return {
        "groups": groups,
        "perm": torch.as_tensor(plan.perm, dtype=torch.long, device=device),
    }


def _gather_group_gains(P, Q, g, jitter, stream_dt, acc_dt):
    """(B, Ag) gains of a one-hot (rf == 1) group: the packed S and G
    blocks are gathered entry by entry from P and Q, straight into the
    (B, T, Ag) layout.  Under fast_math the P entries are read as
    bfloat16, like the JAX package's bf16 offset planes."""
    B, N, _ = P.shape
    T, Ag = g["vv"].shape
    Pf = P.to(stream_dt).reshape(B, N * N)
    S = Pf[:, g["index"]].to(acc_dt).view(B, T, Ag) * g["vv"]
    S = S + g["diag"].to(acc_dt)
    if jitter:
        S = S + jitter * g["eye"]
    G = Q.reshape(B, N * N)[:, g["index"]].to(acc_dt).view(B, T, Ag) * g["vv"]
    return kernels.spd_trace_product_packed(S, G)


def _dense_group_gains(P, Q, g, jitter, stream_dt, acc_dt):
    """(B, Ag) gains of an rf > 1 group, with the mission axis as the large
    GEMM dimension (the JAX package's two-stage contraction):

      T[(a,j), (b,n)] = Σ_m H[(a,j), m] X[b, n, m]      one (K, N)×(N, B·N) GEMM
      S[a, i, (j,b)]  = Σ_n H[a, i, n] T[a, (j,b), n]    Ag GEMMs, batched

    for X = P (innovation) and X = Q (gain numerator).  T is rounded to the
    stream dtype and contracted in the accumulation dtype.  The symmetrised
    lower triangles are gathered from S straight into the (Ag, T, B)
    layout of the trace-product kernel."""
    B, N, _ = P.shape
    Ag, Mg, _ = g["H"].shape
    Hf = g["H_flat"].to(stream_dt)
    Hg = g["H"].to(stream_dt).to(acc_dt)

    def stage(X):
        Xt = X.to(stream_dt).permute(2, 0, 1).reshape(N, B * N)
        T = (Hf @ Xt).view(Ag, Mg * B, N)
        return torch.bmm(Hg, T.to(acc_dt).mT).view(Ag, Mg * Mg, B)  # (a, (i, j), b)

    def symmetric_lower(X):  # (Ag, Mg·Mg, B) → (Ag, T, B); copies whole B-rows
        return 0.5 * (X.index_select(1, g["lower"]) + X.index_select(1, g["upper"]))

    S = symmetric_lower(stage(P)) + g["R"].to(acc_dt)[..., None]
    if jitter:
        S = S + jitter * g["eye"]
    G = symmetric_lower(stage(Q))
    return kernels.spd_trace_product_packed(S, G).T


def kf_sweep_gains_batched(
    P: torch.Tensor,
    prep,
    diag_mask: Optional[torch.Tensor] = None,
    jitter: float = 0.0,
    fast_math: bool = False,
) -> torch.Tensor:
    """Whole-batch all-action sweep: P (B, N, N), diag_mask (B, N) →
    gains (B, A).  Matches the dense oracle :func:`kf_sweep_gains` per
    mission (tests/test_torch_kalman.py) and the JAX package's
    ``kf_sweep_gains_batched``.

    ``fast_math``: bfloat16 streams (Q, the staged products, the gathered
    P entries) with accumulation in P's dtype, as bench.py runs the JAX
    package; belief commits are unaffected."""
    acc_dt = P.dtype
    stream_dt = torch.bfloat16 if fast_math else acc_dt
    # Q = P·diag(m)·P, stored in the stream dtype
    Pm = P if diag_mask is None else P * diag_mask[:, None, :].to(acc_dt)
    Q = torch.matmul(Pm.to(stream_dt), P.to(stream_dt))
    parts = []
    for g in prep["groups"]:
        if g["kind"] == "gather":
            parts.append(_gather_group_gains(P, Q, g, jitter, stream_dt, acc_dt))
        else:
            parts.append(_dense_group_gains(P, Q, g, jitter, stream_dt, acc_dt))
    return torch.cat(parts, dim=1)[:, prep["perm"]]
