"""The sweep's packed trace product (ipp_rl_tpu_torch/ops/smallchol.py:
``spd_trace_product_packed``), the packed tables the batched all-action
sweep builds (ipp_rl_tpu_torch/ops/kalman.py: ``prepare_batched_sweep``),
and the sweep with bf16 streams.

Tolerances: the packed plain version performs the full-block version's
operations in the same order on the same entries, read from another
layout, so the two are held to bitwise equality.  With bf16 streams
(fast_math) the sweep is held to the JAX package's to the bf16 rounding
and to argmax agreement.  The float64 sweep against the JAX package's
``kf_sweep_gains_batched`` is tests/test_torch_kalman.py's
``test_batched_sweep_matches_jax_and_dense``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.ops import kalman as jk
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kalman as tk
from ipp_rl_tpu_torch.ops import smallchol

from test_torch_kalman import _evolved_beliefs

# (outer, inner) of the two sweep groups' layouts, at a small size: the
# dense group's (Ag, T, B) and the gather group's (B, T, Ag)
LAYOUTS = {"dense": (4, 37), "gather": (37, 4)}


def random_spd(rng, n, M):
    A = rng.normal(size=(n, M, M))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(M)


def pack(X, outer, inner):
    """(outer * inner, M, M) → (outer, T, inner)."""
    T = smallchol.packed_size(X.shape[-1])
    return smallchol.pack_lower(X).view(outer, inner, T).transpose(1, 2).contiguous()


def test_packed_index_is_row_order_of_the_lower_triangle():
    M = 9
    i, j = torch.tril_indices(M, M)
    assert [smallchol.packed_index(a, b) for a, b in zip(i.tolist(), j.tolist())] == list(
        range(smallchol.packed_size(M))
    )
    assert [smallchol.packed_m(smallchol.packed_size(m)) for m in range(1, 13)] == list(
        range(1, 13)
    )
    with pytest.raises(ValueError):
        smallchol.packed_m(44)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", list(range(1, 13)))
def test_packed_plain_is_bitwise_full_block(M, dtype, layout):
    outer, inner = LAYOUTS[layout]
    rng = np.random.default_rng(M)
    S = random_spd(rng, outer * inner, M)
    S[5, -1, -1] -= 2.0 * np.trace(S[5])  # one indefinite block: its last pivot is clamped
    S, G = (torch.from_numpy(X).to(dtype) for X in (S, random_spd(rng, outer * inner, M)))
    got = smallchol.spd_trace_product_packed(pack(S, outer, inner), pack(G, outer, inner))
    assert got.shape == (outer, inner) and got.dtype == dtype
    assert torch.equal(got, smallchol.spd_trace_product(S, G).view(outer, inner))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("which", ["small", "canonical"])
def test_sweep_tables_are_packed(which, small_cfg, canonical_cfg):
    """Each group's tables are in the trace-product kernel's layouts: a
    gather group's in (T, Ag) order, so one gather gives (B, T, Ag), with
    ``eye`` the packed identity; a taps group's (the rf > 1 actions on grids
    whose (N, N) block fits a CTA's shared memory) diagonals as (T, Ag) and
    its taps as (Mg, KT, Ag), for the (B, T, Ag) blocks its kernel writes."""
    cfg = small_cfg if which == "small" else canonical_cfg
    world = IPPWorld(cfg, dtype=torch.float64, device="cpu")
    groups = world.sweep_batched["groups"]
    assert {g["kind"] for g in groups} == {"gather", "taps"}
    for g in groups:
        if g["kind"] == "gather":
            T, Ag = g["vv"].shape
            assert g["index"].shape == (T * Ag,) and g["diag"].shape == (T, Ag)
            M = smallchol.packed_m(T)
            assert torch.equal(g["eye"][:, 0],
                               smallchol.pack_lower(torch.eye(M, dtype=g["eye"].dtype)))
        else:
            Mg, KT, Ag = g["cells"].shape
            T = smallchol.packed_size(Mg)
            assert g["diag"].shape == (T, Ag) and g["weights"].shape == (Mg, KT, Ag)


def test_packed_sweep_fast_math_agrees_with_jax(canonical_cfg):
    """float32 beliefs, bf16 streams in both packages: the gains agree to
    the bf16 rounding and the greedy argmax agrees."""
    jworld = JaxWorld(canonical_cfg, dtype=jnp.float32)
    world = IPPWorld(canonical_cfg, dtype=torch.float32, device="cpu")
    Pb, mask = _evolved_beliefs(canonical_cfg, JaxWorld(canonical_cfg, dtype=jnp.float64), 6, 5)
    Pb, mask = Pb.astype(np.float32), mask.astype(np.float32)
    want = np.asarray(jk.kf_sweep_gains_batched(
        jnp.asarray(Pb), jworld.sweep_batched, jnp.asarray(mask), fast_math=True
    ))
    got = tk.kf_sweep_gains_batched(
        torch.from_numpy(Pb), world.sweep_batched, torch.from_numpy(mask), fast_math=True
    ).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 0.05
    assert np.sum(np.argmax(got, 1) == np.argmax(want, 1)) >= len(Pb) - 1
