"""Sharded Kalman operations — scaling beyond one device's memory.

Port of ``ipp_rl_tpu/parallel/sharded_kalman.py`` onto
``torch.distributed``.  Two shardings cover the framework's scale axes
(the N² covariance is the state that outgrows one device):

  * ``sharded_kf_update``: the (N, N) covariance is sharded by ROWS over
    the mesh's ``mp`` axis; each rank passes its N/d rows of P and of the
    mean.  Per rank: the local P·Hᵀ rows (no communication), the
    innovation assembled with one all_reduce of an (M, M) block, the gain
    applied after one all_gather of the (N, M) P·Hᵀ, and the global
    symmetrisation with one all_to_all of (N/d, N/d) blocks, so the O(N²)
    state never moves whole.
  * ``sharded_sweep_gains``: candidate-action pricing sharded over the
    ACTION axis (each rank prices A/d actions against a replicated P),
    with one all_gather of the (A,) gains (the pod-level version of the
    reference's candidate-evaluation pool, reference
    planning/common/optimization.py:86-90).

The (M, M) inverse is ``ops/kernels.spd_inverse`` (K1) on every rank.
Mission-batch (dp) sharding needs no operation of its own: a rank runs the
batched planners on its slice (parallel/mesh.shard_batch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ipp_rl_tpu_torch.ops import kernels
from ipp_rl_tpu_torch.ops.kalman import kf_sweep_gains
from ipp_rl_tpu_torch.utils.tracing import span


def all_gather_rows(x: torch.Tensor, group, d: int) -> torch.Tensor:
    """The d ranks' x stacked along the leading axis, in rank order."""
    out = torch.empty((d * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    with span("grid.collective"):
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def sharded_kf_update(
    mesh: DeviceMesh,
    cov: torch.Tensor,  # (N/d, N) — this rank's rows
    mean: torch.Tensor,  # (N/d,) — this rank's rows
    H: torch.Tensor,  # (M, N) — replicated
    R_diag: torch.Tensor,  # (M,) — replicated
    z: Optional[torch.Tensor] = None,  # (M,) — replicated
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kalman commit with the covariance row-sharded over ``mp``: returns
    this rank's rows of (mean', P').  The non-Joseph form P − K·(P·Hᵀ)ᵀ,
    then 0.5·(P' + P'ᵀ) over the whole matrix, as the JAX package
    computes it; equal to ops/kalman.kf_update up to rounding.  ``z``
    None commits the covariance only."""
    with span("grid.commit"):
        group = mesh.get_group("mp")
        d, r = mesh["mp"].size(), mesh.get_local_rank("mp")
        n_loc, N = cov.shape
        if n_loc * d != N:
            raise ValueError(f"{n_loc} rows on each of {d} ranks do not make N = {N}")
        H_loc = H[:, r * n_loc:(r + 1) * n_loc]  # the columns of H that meet our rows
        PHt_loc = cov @ H.mT  # (N/d, M) — our rows of P·Hᵀ
        # S = H P Hᵀ = Σ_ranks H[:, rows] @ PHt[rows]
        S = H_loc @ PHt_loc
        with span("grid.collective"):
            dist.all_reduce(S, group=group)
        S = S + torch.diag(R_diag)
        S = 0.5 * (S + S.mT)
        K_loc = PHt_loc @ kernels.spd_inverse(S.contiguous())  # our rows of the gain
        PHt_full = all_gather_rows(PHt_loc, group, d)  # (N, M)
        P_next = cov - K_loc @ PHt_full.mT
        # 0.5·(P + Pᵀ): block (r, j) of Pᵀ is block (j, r) of P transposed, so
        # one all_to_all hands every rank the blocks it needs
        blocks = P_next.view(n_loc, d, n_loc).transpose(0, 1).contiguous()  # (d, N/d, N/d)
        theirs = torch.empty_like(blocks)
        with span("grid.collective"):
            dist.all_to_all_single(theirs, blocks, group=group)
        P_t = theirs.transpose(1, 2).transpose(0, 1).reshape(n_loc, N)
        P_next = 0.5 * (P_next + P_t)
        if z is None:
            return mean, P_next
        mean_full = all_gather_rows(mean, group, d)
        v = z - H @ mean_full
        return mean + K_loc @ v, P_next


def sharded_sweep_gains(
    mesh: DeviceMesh,
    cov: torch.Tensor,  # (N, N) — replicated
    H_all: torch.Tensor,  # (A, M, N) — replicated; this rank prices its A/d
    R_all: torch.Tensor,  # (A, M)
    diag_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All-action trace reductions (ops/kalman.kf_sweep_gains) with the
    action axis split over ``mp``: this rank prices actions
    [r·A/d, (r+1)·A/d) and one all_gather returns the (A,) gains."""
    with span("grid.sweep"):
        group = mesh.get_group("mp")
        d, r = mesh["mp"].size(), mesh.get_local_rank("mp")
        A, N = H_all.shape[0], cov.shape[0]
        if A % d or N % d:
            raise ValueError(f"A = {A} and N = {N} must both divide over mp = {d}")
        a_loc = A // d
        mask = diag_mask if diag_mask is not None else torch.ones(N, dtype=cov.dtype,
                                                                  device=cov.device)
        acts = slice(r * a_loc, (r + 1) * a_loc)
        gains = kf_sweep_gains(cov, H_all[acts], R_all[acts], mask)
        return all_gather_rows(gains, group, d)
