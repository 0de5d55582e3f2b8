"""The hand-written CUDA kernels (ipp_rl_tpu_torch/csrc/smallchol.cu) on the
card, against their plain PyTorch versions, the greedy slice on the
card against the same slice on the CPU, and greedy's mission loop that
leaves once no mission can move against the whole loop.

``spd_trace_product`` is tested through its packed entry, the one the
sweep calls, in both sweep layouts and against the full-block plain
version.  ``spd_inverse_factor`` (the search's edge update) returns the
inverse and its Cholesky factor; where a clamped pivot makes the factor
overflow, its inf and NaN entries must sit where the plain version's do.
``edge_factor_gain`` (the search's whole edge update after its two GEMMs)
is held to the same on clamped pivots, in both dtypes, with the bf16
round trip, for every column chunk and every mission of a batch.  Each
kernel is held at every M of its register-resident route (1..12), at
M = 13, 16, 25 and 32 of its warp route and at M =
33, 48, 64, 81 and 121 of its CTA route (one CTA per matrix), there with
its workspace in shared memory and, forced, in global memory (where a
larger M puts it).  Any M >= 1 is taken; M = 0 raises.  The CTA route's
edge update (a factor kernel, a tiled Uᵀ·A, a gain kernel) is held at M =
33 and 121 over ragged column tiles, every mask, the round trip and B = 1,
5 and 192; its trace product (2 blocks per CTA) over ragged runs of
blocks, each into NaN-filled memory; M = 177 takes the shared-memory form
of the factorisations.  ``spd_inverse`` and ``spd_trace_product`` take two
kinds of kernel at M = 13..32, runtime-M (a warp per matrix or block, the
factors in shared memory) and unrolled (a warp per matrix with its rows in
registers; a lane per block): both kinds and the default are held at every
M from 13 to 32 in both dtypes, the trace product over ragged runs of
blocks, the inverse over ragged and misaligned batches and both on
block-diagonal S (zero dividends), each into NaN-filled outputs;
``spd_inverse_factor`` and ``edge_factor_gain`` take two kinds there too
(the runtime-M kernels; a warp per matrix or mission with its factors'
rows in registers, the edge update's Uᵀ·A and gain then a CTA per mission
from Uᵀ in a workspace): both kinds and the default at every M from 13
to 32 in both dtypes (the edge update with the bf16 round trip too), at M =
13, 25, 32 over ragged column tiles (N = 70, 129) and N = 400 with every
mask (none, shared, per mission, per CMA-ES member), over batches of 1, 5
and 1025 missions, and the launch refused (-2) without its workspace.
With two cards, each wrapper runs
on the second while the first is current (one card skips that test).

These tests need an NVIDIA Hopper card and the CUDA toolkit; elsewhere
they skip.  They import no JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

The kernels perform the plain versions' operations in the same order with
one rounding each (no FMA contraction), so they are held to bitwise
equality."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, MissionConfig, load_config
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kernels, smallchol
from ipp_rl_tpu_torch.planners import GreedyPlanner

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


#: the register-resident route's M, and the large-M route's tested M
SMALL_M = list(range(1, 13))
LARGE_M = [13, 16, 25, 32]


def random_spd(n, M, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn((n, M, M), generator=gen, dtype=torch.float64)
    return (A @ A.mT + 0.5 * torch.eye(M, dtype=torch.float64)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", SMALL_M + LARGE_M)
def test_spd_inverse_kernel_is_bitwise_plain(cuda, M, dtype):
    S = random_spd(257, M, dtype, seed=M).to(cuda)
    got = kernels.spd_inverse(S)
    torch.cuda.synchronize()
    assert torch.equal(got, smallchol.spd_inverse(S))


def packed(X, outer, inner):
    """(outer * inner, M, M) → the kernel's (outer, T, inner) layout."""
    T = smallchol.packed_size(X.shape[-1])
    return smallchol.pack_lower(X).view(outer, inner, T).transpose(1, 2).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", [1, 2, 4, 9, 12] + LARGE_M)
def test_spd_trace_product_kernel_is_bitwise_plain(cuda, M, dtype):
    """The kernel on packed blocks against the full-block plain version."""
    S = random_spd(1000, M, dtype, seed=M).to(cuda)
    G = random_spd(1000, M, dtype, seed=100 + M).to(cuda)
    got = kernels.spd_trace_product_packed(packed(S, 1, 1000), packed(G, 1, 1000))
    torch.cuda.synchronize()
    assert got.shape == (1, 1000)
    assert torch.equal(got[0], smallchol.spd_trace_product(S, G))


@pytest.mark.parametrize("outer,inner", [(100, 64), (64, 100), (3, 1001)],
                         ids=["dense", "gather", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", SMALL_M + LARGE_M)
def test_packed_trace_product_kernel_is_bitwise_plain(cuda, M, dtype, outer, inner):
    """Both sweep layouts, (Ag, T, B) and (B, T, Ag), and an inner length
    that is no multiple of the warp, with one clamped pivot."""
    n = outer * inner
    S = random_spd(n, M, dtype, seed=M)
    S[7, -1, -1] -= 2.0 * S[7].diagonal().sum()  # indefinite: the last pivot is clamped
    Sp = packed(S.to(cuda), outer, inner)
    Gp = packed(random_spd(n, M, dtype, seed=200 + M).to(cuda), outer, inner)
    got = kernels.spd_trace_product_packed(Sp, Gp)
    torch.cuda.synchronize()
    assert got.shape == (outer, inner) and bool(torch.isfinite(got).all())
    assert torch.equal(got, smallchol.spd_trace_product_packed(Sp, Gp))


@pytest.mark.parametrize("B", [1, 31, 4096, 4097])
def test_inverse_tiles_cover_every_matrix(cuda, B):
    """The CTA tiles of spd_inverse (32 matrices each) cover every matrix:
    the output's memory is first filled with NaN, so a matrix no CTA wrote
    shows."""
    S = random_spd(B, 9, torch.float32, seed=B).to(cuda)
    torch.full_like(S, float("nan"))  # freed at once: the output reuses its block
    got = kernels.spd_inverse(S)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, smallchol.spd_inverse(S))


def test_batch_dims_ragged_tail_and_clamp(cuda):
    S = random_spd(3 * 129, 9, torch.float32, seed=1).reshape(3, 129, 9, 9).to(cuda)
    S[1, 5, -1, -1] -= 1e3  # indefinite: the last pivot is clamped
    got = kernels.spd_inverse(S)
    assert got.shape == S.shape and bool(torch.isfinite(got).all())
    assert torch.equal(got, smallchol.spd_inverse(S))
    assert got[1, 5, -1, -1].item() == pytest.approx(1e30, rel=1e-5)


def same(got, want):
    """Bitwise equal, NaN in the same places (payloads aside)."""
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", SMALL_M + LARGE_M)
def test_spd_inverse_factor_kernel_is_bitwise_plain(cuda, M, dtype):
    S = random_spd(257, M, dtype, seed=300 + M)
    S[5, -1, -1] -= 2.0 * S[5].diagonal().sum()  # indefinite: the last pivot is clamped
    S = S.to(cuda)
    inv, U = kernels.spd_inverse_factor(S)
    torch.cuda.synchronize()
    want_inv, want_U = smallchol.spd_inverse_factor(S)
    assert torch.equal(inv, want_inv)
    assert same(U, want_U)
    assert torch.equal(torch.triu(U, 1), torch.zeros_like(U))
    assert bool(torch.isfinite(U[:5]).all()) and bool(torch.isfinite(U[6:]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 31, 1024, 1025, 4097])
def test_inverse_factor_tiles_cover_every_matrix(cuda, B, dtype):
    """Both outputs are first filled with NaN and handed to the kernel
    directly, so a matrix that no CTA wrote shows."""
    S = random_spd(B, 9, dtype, seed=B).to(cuda)
    kernels.spd_inverse_factor(S[:1])  # builds and loads the library
    inv = torch.full_like(S, float("nan"))
    U = torch.full_like(S, float("nan"))
    err = kernels._lib.smallchol_spd_inverse_factor(
        S.data_ptr(), inv.data_ptr(), U.data_ptr(), B, 9, kernels._DTYPE_CODES[dtype], None,
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err == 0
    want_inv, want_U = smallchol.spd_inverse_factor(S)
    assert bool(torch.isfinite(inv).all()) and bool(torch.isfinite(U).all())
    assert torch.equal(inv, want_inv) and torch.equal(U, want_U)
    got_inv, got_U = kernels.spd_inverse_factor(S)  # and through the wrapper
    assert torch.equal(got_inv, want_inv) and torch.equal(got_U, want_U)


def edge_inputs(B, M, N, dtype, seed, clamp=False):
    """S_raw (B, M, M) and A (B, M, N) as one descent step builds them
    (A = H·P, S_raw = A·Hᵀ, one SPD P), an R table of 7 actions, actions (B,)
    and a 0/1 mask (B, N); with ``clamp``, mission 1's S goes indefinite."""
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn((N, N), generator=gen, dtype=torch.float64)
    P = X @ X.T / N + 0.1 * torch.eye(N, dtype=torch.float64)
    H = torch.randn((B, M, N), generator=gen, dtype=torch.float64) / N ** 0.5
    A = H @ P
    S_raw = A @ H.mT
    if clamp and B > 1:
        S_raw[1, -1, -1] -= 4.0 * S_raw[1].diagonal().sum() + 10.0
    R = torch.rand((7, M), generator=gen, dtype=torch.float64) + 0.5
    a = torch.randint(0, 7, (B,), generator=gen)
    mask = (torch.rand((B, N), generator=gen) > 0.4).to(torch.float64)
    return [t.to(dtype) for t in (S_raw, A, R)] + [a, mask.to(dtype)]


EDGE_DTYPES = [(torch.float32, False), (torch.float32, True), (torch.float64, False)]
EDGE_IDS = ["float32", "float32-bf16", "float64"]


@pytest.mark.parametrize("use_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype,round_bf16", EDGE_DTYPES, ids=EDGE_IDS)
@pytest.mark.parametrize("M", SMALL_M + LARGE_M)
def test_edge_factor_gain_kernel_is_bitwise_plain(cuda, M, dtype, round_bf16, use_mask):
    """N = 100 (four column chunks, the last ragged), one clamped pivot:
    its overflowing factor must put inf and NaN where the plain version
    does."""
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(67, M, 100, dtype, seed=M,
                                                             clamp=True))
    mask = mask if use_mask else None
    got = kernels.edge_factor_gain(S_raw, A, R, a, mask, round_bf16)
    torch.cuda.synchronize()
    want = smallchol.edge_factor_gain(S_raw, A, R, a, mask, round_bf16)
    assert same(got[0], want[0]) and same(got[1], want[1])
    keep = torch.arange(67, device=cuda) != 1
    assert bool(torch.isfinite(got[0][keep]).all()) and bool(torch.isfinite(got[1][keep]).all())
    assert not bool((got[0][1].abs() < 1e10).all())  # the clamped mission's factor is huge


@pytest.mark.parametrize("N", [1, 31, 33, 100])
def test_edge_factor_gain_column_chunks(cuda, N):
    """Fewer columns than lanes, one past a chunk, and a shared (N,) mask."""
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(40, 9, N, torch.float32, seed=N))
    for m in (None, mask[0].contiguous(), mask):
        got = kernels.edge_factor_gain(S_raw, A, R, a, m)
        want = smallchol.edge_factor_gain(S_raw, A, R, a, m)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 31, 1024, 1025, 4097])
def test_edge_factor_gain_covers_every_mission(cuda, B, dtype):
    """Both outputs are first filled with NaN and handed to the kernel
    directly, so a mission that no warp wrote shows."""
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(B, 9, 100, dtype, seed=B))
    kernels.edge_factor_gain(S_raw[:1], A[:1], R, a[:1])  # builds and loads the library
    WcT = torch.full_like(A, float("nan"))
    gain = torch.full((B,), float("nan"), dtype=dtype, device=cuda)
    err = kernels._lib.smallchol_edge_factor_gain(
        S_raw.data_ptr(), A.data_ptr(), R.data_ptr(), a.data_ptr(), mask.data_ptr(), 100,
        WcT.data_ptr(), gain.data_ptr(), B, 9, 100, 0, kernels._DTYPE_CODES[dtype], None,
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err == 0
    want = smallchol.edge_factor_gain(S_raw, A, R, a, mask)
    assert bool(torch.isfinite(WcT).all()) and bool(torch.isfinite(gain).all())
    assert torch.equal(WcT, want[0]) and torch.equal(gain, want[1])
    got = kernels.edge_factor_gain(S_raw, A, R, a, mask)  # and through the wrapper
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 1025])
def test_large_m_route_covers_every_matrix(cuda, B, dtype):
    """The large-M route (M = 25, four warps per CTA) writes every matrix,
    block and mission of a ragged batch: the outputs' memory is first
    filled with NaN (freed at once, so the outputs reuse it)."""
    M = 25
    S = random_spd(B, M, dtype, seed=B).to(cuda)
    torch.full((4 * B * M * 400,), float("nan"), dtype=dtype, device=cuda)
    assert torch.equal(kernels.spd_inverse(S), smallchol.spd_inverse(S))
    torch.full((4 * B * M * 400,), float("nan"), dtype=dtype, device=cuda)
    for got, want in zip(kernels.spd_inverse_factor(S), smallchol.spd_inverse_factor(S)):
        assert torch.equal(got, want)
    Sp, Gp = packed(S, 1, B), packed(random_spd(B, M, dtype, seed=B + 1).to(cuda), 1, B)
    torch.full((4 * B * M * 400,), float("nan"), dtype=dtype, device=cuda)
    got = kernels.spd_trace_product_packed(Sp, Gp)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, smallchol.spd_trace_product_packed(Sp, Gp))
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(B, M, 400, dtype, seed=B))
    torch.full((4 * B * M * 400,), float("nan"), dtype=dtype, device=cuda)
    got = kernels.edge_factor_gain(S_raw, A, R, a, mask)
    torch.cuda.synchronize()
    want = smallchol.edge_factor_gain(S_raw, A, R, a, mask)
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


#: every M of the warp route; the kinds of kernel there (None: the default,
#: which picks by M and dtype)
WARP_M = list(range(13, 33))
WARP_KINDS = [None, "runtime_m", "unrolled"]


def warp_kind(kind):
    return contextlib.nullcontext() if kind is None else kernels.warp_route(kind)


def inverse_into_nan(S):
    """spd_inverse's launch on (n, M, M) S into a NaN-filled output handed
    to the library, so a matrix no warp wrote shows."""
    n, M = S.shape[0], S.shape[-1]
    kernels.spd_inverse(S[:1])  # builds and loads the library
    out = torch.full_like(S, float("nan"))
    err = kernels._lib.smallchol_spd_inverse(
        S.data_ptr(), out.data_ptr(), n, M, kernels._DTYPE_CODES[S.dtype], None,
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err == 0
    return out


def trace_into_nan(Sp, Gp):
    """spd_trace_product's launch on packed (outer, T, inner) blocks into a
    NaN-filled output handed to the library."""
    outer, T, inner = Sp.shape
    kernels.spd_trace_product_packed(Sp[:1, :, :1].contiguous(), Gp[:1, :, :1].contiguous())
    out = torch.full((outer, inner), float("nan"), dtype=Sp.dtype, device=Sp.device)
    err = kernels._lib.smallchol_spd_trace_product(
        Sp.data_ptr(), Gp.data_ptr(), out.data_ptr(), outer, inner, smallchol.packed_m(T),
        kernels._DTYPE_CODES[Sp.dtype], None, torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err == 0
    return out


def same_finite(got, want):
    """Bitwise equal, NaN in the same places, and finite where the plain
    version is (a clamped pivot's huge entries)."""
    return same(got, want) and torch.equal(torch.isfinite(got), torch.isfinite(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", WARP_M)
def test_spd_inverse_warp_route_every_m(cuda, M, dtype):
    """spd_inverse at every M of the warp route, by default and with each
    kind of kernel forced, on 67 matrices (one clamped) into NaN-filled
    outputs."""
    S = random_spd(67, M, dtype, seed=500 + M)
    S[5, -1, -1] -= 2.0 * S[5].diagonal().sum()  # indefinite: the last pivot is clamped
    S = S.to(cuda)
    want = smallchol.spd_inverse(S)
    for kind in WARP_KINDS:
        with warp_kind(kind):
            got = inverse_into_nan(S)
        assert same_finite(got, want), kind


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", WARP_M)
def test_trace_product_warp_route_every_m(cuda, M, dtype):
    """spd_trace_product at every M of the warp route, by default and with
    each kind of kernel forced, on (3, T, 37) packed blocks (one clamped):
    111 blocks, so the last warp of a lane per block is ragged and warps
    cross an o; into NaN-filled outputs."""
    outer, inner = 3, 37
    S = random_spd(outer * inner, M, dtype, seed=600 + M)
    S[40, -1, -1] -= 2.0 * S[40].diagonal().sum()
    Sp = packed(S.to(cuda), outer, inner)
    Gp = packed(random_spd(outer * inner, M, dtype, seed=700 + M).to(cuda), outer, inner)
    want = smallchol.spd_trace_product_packed(Sp, Gp)
    for kind in WARP_KINDS:
        with warp_kind(kind):
            got = trace_into_nan(Sp, Gp)
        assert same_finite(got, want), kind


@pytest.mark.parametrize("inner", [1, 7, 31, 33, 400])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trace_product_lanes_ragged_runs(cuda, dtype, inner):
    """The trace product at M = 25 on (3, 325, inner) blocks: outer·inner is
    no multiple of a warp's 32 blocks, and for inner < 32 or no multiple of
    32 a warp's lanes span several o; both kinds of kernel, into NaN-filled
    outputs."""
    M, outer = 25, 3
    n = outer * inner
    S = random_spd(n, M, dtype, seed=inner)
    S[n // 2, -1, -1] -= 2.0 * S[n // 2].diagonal().sum()
    Sp = packed(S.to(cuda), outer, inner)
    Gp = packed(random_spd(n, M, dtype, seed=50 + inner).to(cuda), outer, inner)
    want = smallchol.spd_trace_product_packed(Sp, Gp)
    for kind in ("runtime_m", "unrolled"):
        with kernels.warp_route(kind):
            got = trace_into_nan(Sp, Gp)
        assert same_finite(got, want), kind


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 31, 33, 4097])
def test_spd_inverse_warp_route_batches(cuda, B, dtype, offset):
    """spd_inverse at M = 25 on B matrices (one clamped), both kinds of
    kernel, into NaN-filled outputs; with ``offset`` the input starts one
    matrix into its storage (625 elements: not 16-byte aligned), so the
    staging copies' single-element head and tail and the stores' element
    path run."""
    M = 25
    S = random_spd(B + offset, M, dtype, seed=B)
    S[offset + B // 2, -1, -1] -= 2.0 * S[offset + B // 2].diagonal().sum()
    S = S.to(cuda)[offset:]
    want = smallchol.spd_inverse(S)
    for kind in ("runtime_m", "unrolled"):
        with kernels.warp_route(kind):
            got = inverse_into_nan(S)
        assert same_finite(got, want), kind
        with kernels.warp_route(kind):  # and through the wrapper
            assert same_finite(kernels.spd_inverse(S), want), kind


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", [13, 25, 32])
def test_warp_route_zero_dividends(cuda, M, dtype):
    """Block-diagonal S (three interleaved blocks), as the 2 m sweep's
    blocks are in part: most entries of L and L⁻¹ are zeros, so most of the
    forward substitution's divisions have a zero dividend, which the
    unrolled kernels answer without dividing.  Both kinds, bitwise, the
    zeros' signs included."""
    i = torch.arange(M)
    pattern = (i[:, None] % 3 == i[None, :] % 3).to(torch.float64)
    gen = torch.Generator().manual_seed(M)
    A = torch.randn((111, M, M), generator=gen, dtype=torch.float64) * pattern
    S = (A @ A.mT + 0.5 * torch.eye(M, dtype=torch.float64)).to(dtype).to(cuda)
    G = random_spd(111, M, dtype, seed=800 + M).to(cuda)
    Sp, Gp = packed(S, 3, 37), packed(G, 3, 37)
    want_inv = smallchol.spd_inverse(S)
    want_tr = smallchol.spd_trace_product_packed(Sp, Gp)
    assert bool((want_inv == 0).any())
    for kind in ("runtime_m", "unrolled"):
        with kernels.warp_route(kind):
            got_inv = inverse_into_nan(S)
            got_tr = trace_into_nan(Sp, Gp)
        assert same_finite(got_inv, want_inv), kind
        assert torch.equal(torch.signbit(got_inv), torch.signbit(want_inv)), kind
        assert same_finite(got_tr, want_tr), kind


def test_warp_route_refuses_an_unknown_kind(cuda):
    kernels.spd_inverse(random_spd(1, 13, torch.float32, seed=0).to(cuda))
    assert kernels._lib.smallchol_set_warp_route(3) == -1
    with pytest.raises(KeyError):
        with kernels.warp_route("cta"):
            pass


def factor_into_nan(S):
    """spd_inverse_factor's launch on (n, M, M) S into NaN-filled outputs
    handed to the library (no workspace below M = 33)."""
    n, M = S.shape[0], S.shape[-1]
    kernels.spd_inverse_factor(S[:1])  # builds and loads the library
    inv, U = torch.full_like(S, float("nan")), torch.full_like(S, float("nan"))
    err = kernels._lib.smallchol_spd_inverse_factor(
        S.data_ptr(), inv.data_ptr(), U.data_ptr(), n, M, kernels._DTYPE_CODES[S.dtype], None,
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err == 0
    return inv, U


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", WARP_M)
def test_spd_inverse_factor_warp_route_every_m(cuda, M, dtype):
    """spd_inverse_factor at every M of the warp route on 67 matrices (one
    clamped: its factor overflows where the plain version's does) into
    NaN-filled outputs."""
    S = random_spd(67, M, dtype, seed=900 + M)
    S[5, -1, -1] -= 2.0 * S[5].diagonal().sum()
    S = S.to(cuda)
    want_inv, want_U = smallchol.spd_inverse_factor(S)
    inv, U = factor_into_nan(S)
    assert same_finite(inv, want_inv) and same(U, want_U)
    assert torch.equal(torch.triu(U, 1), torch.zeros_like(U))


def edge_masks(mask, lam=3):
    """The masks the edge update takes: none, one shared (N,), one per
    mission (B, N), and CMA-ES's per member: each mission's row repeated
    for its λ members, cut to B rows."""
    B = mask.shape[0]
    member = mask[:(B + lam - 1) // lam].repeat_interleave(lam, dim=0)[:B]
    return {"none": None, "shared": mask[0].contiguous(), "per_mission": mask,
            "per_member": member.contiguous()}


@pytest.mark.parametrize("dtype,round_bf16", EDGE_DTYPES, ids=EDGE_IDS)
@pytest.mark.parametrize("M", WARP_M)
def test_edge_factor_gain_warp_route_every_m(cuda, M, dtype, round_bf16):
    """edge_factor_gain at every M of the warp route, N = 400, B = 67 (no
    multiple of 4; one mission clamped), a per-mission mask: bitwise, NaN
    where the plain version has it."""
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(67, M, 400, dtype, seed=M,
                                                             clamp=True))
    want = smallchol.edge_factor_gain(S_raw, A, R, a, mask, round_bf16)
    poisoned(2 * A.numel() * A.element_size(), cuda)
    got = kernels.edge_factor_gain(S_raw, A, R, a, mask, round_bf16)
    torch.cuda.synchronize()
    assert same_finite(got[0], want[0]) and same_finite(got[1], want[1])


@pytest.mark.parametrize("mask", ["none", "shared", "per_mission", "per_member"])
@pytest.mark.parametrize("N", [70, 129, 400])
@pytest.mark.parametrize("dtype,round_bf16", EDGE_DTYPES, ids=EDGE_IDS)
@pytest.mark.parametrize("M", [13, 25, 32])
def test_edge_factor_gain_warp_route_columns_and_masks(cuda, M, dtype, round_bf16, N, mask):
    """M = 13, 25, 32 over ragged passes of columns (N = 70, 129: the last
    pass part empty, N not a multiple of 4) and N = 400, every mask, B =
    37, into NaN-filled memory."""
    S_raw, A, R, a, per = (t.to(cuda) for t in edge_inputs(37, M, N, dtype, seed=M + N))
    m = edge_masks(per)[mask]
    want = smallchol.edge_factor_gain(S_raw, A, R, a, m, round_bf16)
    poisoned(2 * A.numel() * A.element_size(), cuda)
    got = kernels.edge_factor_gain(S_raw, A, R, a, m, round_bf16)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B", [1, 5, 1025])
def test_edge_factor_gain_warp_route_batches(cuda, B):
    """The route's one warp and one CTA per mission at B = 1, 5 and 1025,
    M = 25, N = 400, each output and the workspace first filled with NaN
    and handed to the library."""
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(B, 25, 400, torch.float32, seed=B))
    kernels.edge_factor_gain(S_raw[:1], A[:1], R, a[:1])  # builds and loads the library
    want = smallchol.edge_factor_gain(S_raw, A, R, a, mask)
    ws = kernels._workspace(kernels._lib, kernels._EDGE, 25, 400, B, 0, cuda)
    assert ws is not None and ws.numel() >= B * 25 * 32 * 4
    ws.fill_(255)  # NaN bytes
    WcT = torch.full_like(A, float("nan"))
    gain = torch.full((B,), float("nan"), device=cuda)
    err = kernels._lib.smallchol_edge_factor_gain(
        S_raw.data_ptr(), A.data_ptr(), R.data_ptr(), a.data_ptr(), mask.data_ptr(), 400,
        WcT.data_ptr(), gain.data_ptr(), B, 25, 400, 0, 0, ws.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(WcT, want[0]) and torch.equal(gain, want[1])


def test_edge_factor_gain_warp_route_workspace(cuda):
    """The route asks for Uᵀ's bytes (rows of 32) whatever kind K1 and K2
    are forced to, K3 for none; without its workspace the edge launch
    returns -2 (nothing launched) and the wrapper's check raises."""
    B, M, N = 8, 25, 400
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(B, M, N, torch.float32, seed=7))
    kernels.edge_factor_gain(S_raw, A, R, a, mask)  # builds and loads the library
    lib = kernels._lib
    for code, elem in ((0, 4), (1, 8)):
        for kind in WARP_KINDS:
            with warp_kind(kind):
                nbytes = lib.smallchol_workspace_bytes(kernels._EDGE, M, N, B, code)
                assert nbytes == -(-B * M * 32 * elem // 256) * 256, kind
                assert lib.smallchol_workspace_bytes(kernels._INVERSE_FACTOR, M, 0, B, code) == 0
    WcT, gain = torch.empty_like(A), torch.empty((B,), device=cuda)
    err = lib.smallchol_edge_factor_gain(
        S_raw.data_ptr(), A.data_ptr(), R.data_ptr(), a.data_ptr(), mask.data_ptr(), N,
        WcT.data_ptr(), gain.data_ptr(), B, M, N, 0, 0, None,
        torch.cuda.current_stream().cuda_stream,
    )
    assert err == -2
    with pytest.raises(RuntimeError, match="workspace missing"):
        kernels._raise_on("edge_factor_gain", err)


def test_edge_factor_gain_is_the_edge_update(cuda):
    """kf_edge_factor_gain on the card equals kf_gain_factor_t's factor and
    the squared norm of its columns, to float64 rounding."""
    from ipp_rl_tpu_torch.ops import kalman

    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(16, 9, 100, torch.float64, seed=5))
    gen = torch.Generator().manual_seed(6)
    X = torch.randn((16, 100, 100), generator=gen, dtype=torch.float64).to(cuda)
    P = X @ X.mT / 100 + 0.1 * torch.eye(100, dtype=torch.float64, device=cuda)
    H_table = torch.randn((7, 9, 100), generator=gen, dtype=torch.float64).to(cuda) / 10
    WcT, gain = kalman.kf_edge_factor_gain(P, H_table, R, a, mask)
    want, _ = kalman.kf_gain_factor_t(P, H_table[a], R[a])
    torch.testing.assert_close(WcT, want, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(gain, ((want * want).sum(-2) * mask).sum(-1), rtol=1e-10, atol=0)


def test_launch_counts_and_empty_batch(cuda):
    S = random_spd(4, 9, torch.float32, seed=2).to(cuda)
    before = kernels.launch_counts()
    kernels.spd_inverse(S)
    kernels.spd_trace_product_packed(packed(S, 1, 4), packed(S, 1, 4))
    assert kernels.launch_counts()["spd_inverse"] == before["spd_inverse"] + 1
    assert kernels.launch_counts()["spd_trace_product"] == before["spd_trace_product"] + 1
    empty = kernels.spd_inverse(S[:0])
    assert empty.shape == (0, 9, 9)
    assert kernels.launch_counts()["spd_inverse"] == before["spd_inverse"] + 1
    kernels.spd_inverse_factor(S)
    inv, U = kernels.spd_inverse_factor(S[:0])
    assert inv.shape == U.shape == (0, 9, 9)
    assert kernels.launch_counts()["spd_inverse_factor"] == before["spd_inverse_factor"] + 1
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(4, 9, 100, torch.float32, seed=2))
    kernels.edge_factor_gain(S_raw, A, R, a, mask)
    WcT, gain = kernels.edge_factor_gain(S_raw[:0], A[:0], R, a[:0], mask[:0])
    assert WcT.shape == (0, 9, 100) and gain.shape == (0,)
    assert kernels.launch_counts()["edge_factor_gain"] == before["edge_factor_gain"] + 1
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_span_holds_its_kernels_launch_on_the_profilers_clock(cuda):
    """The tracer's spans and the profiler share a clock on the card: a
    span around a sleep kernel (synchronised inside it) holds the kernel's
    runtime launch event in its host interval and overlaps the kernel's
    device interval, and its CUDA events time at least the sleep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ipp_rl_tpu_torch.utils import tracing

    torch.cuda._sleep(1000)  # the kernel's first launch outside the profile
    torch.cuda.synchronize()
    tracing.reset()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with tracing.span("probe") as span:
                torch.cuda._sleep(20_000_000)  # ~10 ms
                torch.cuda.synchronize()
    finally:
        tracing.disable()
    tracing.snapshot()
    tracing.reset()
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    # the sleep (torch's spin kernel) is the profile's only kernel of 5 ms or more
    sleeps = [e for e in device if e.duration_ns() >= 5_000_000 and "ync" not in e.name()]
    assert len(sleeps) == 1, [(e.name(), e.duration_ns()) for e in device]
    kernel = sleeps[0]
    k_start, k_end = kernel.start_ns(), kernel.start_ns() + kernel.duration_ns()
    launch = [e for e in events if e.device_type() != DeviceType.CUDA
              and e.correlation_id() == kernel.correlation_id()]
    assert len(launch) == 1 and launch[0].name().startswith("cu")
    assert span.start_ns <= launch[0].start_ns() <= span.end_ns
    assert k_start < span.end_ns and k_end > span.start_ns
    assert span.device_ms * 1e6 >= 0.99 * (k_end - k_start)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    S = random_spd(4, 9, torch.float32, seed=3).to(cuda)
    with pytest.raises(ValueError):
        kernels.spd_inverse(S.mT)  # not contiguous
    with pytest.raises(TypeError):
        kernels.spd_inverse(S.half())
    with pytest.raises(ValueError):
        kernels.spd_inverse_factor(S.mT)  # not contiguous
    with pytest.raises(TypeError):
        kernels.spd_inverse_factor(S.half())
    Sp = packed(S, 1, 4)
    with pytest.raises(ValueError):
        kernels.spd_trace_product_packed(Sp, Sp.double())
    with pytest.raises(ValueError):
        kernels.spd_trace_product_packed(Sp, Sp.cpu())
    with pytest.raises(ValueError):
        kernels.spd_trace_product_packed(Sp[:, :44], Sp[:, :44])  # 44 entries: no triangle
    with pytest.raises(ValueError):
        kernels.spd_trace_product_packed(Sp[0], Sp[0])  # not (outer, T, inner)
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(4, 9, 100, torch.float32, seed=3))
    with pytest.raises(ValueError):
        kernels.edge_factor_gain(S_raw.mT, A, R, a, mask)  # not contiguous
    with pytest.raises(ValueError):
        kernels.edge_factor_gain(S_raw, A, R, a, mask.T.contiguous().T)  # not contiguous
    with pytest.raises(TypeError):
        kernels.edge_factor_gain(S_raw.half(), A.half(), R.half(), a, mask.half())
    with pytest.raises(TypeError):
        kernels.edge_factor_gain(S_raw, A, R, a.int(), mask)
    with pytest.raises(ValueError):
        kernels.edge_factor_gain(S_raw, A, R, a.cpu(), mask)
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    from ipp_rl_tpu_torch.planners.zero.mcts import ZeroMCTS

    world = IPPWorld(cfg)
    mcts = ZeroMCTS(world, cfg.missions[0].hyper_params, 5, None, edge_dtype=torch.float16)
    P = torch.eye(cfg.environment.num_cells, device=cuda)[None]
    with pytest.raises(ValueError):  # an edge dtype the kernel does not round to
        mcts.edge_update(P, torch.zeros((1,), dtype=torch.long, device=cuda), None)


def test_wrappers_take_m33_and_refuse_m0(cuda):
    """M = 33, the CTA route's first M, is taken by every wrapper (the warp
    route stopped at 32); M = 0 and integer dtypes still raise."""
    S = random_spd(2, 33, torch.float32, seed=4).to(cuda)
    assert torch.equal(kernels.spd_inverse(S), smallchol.spd_inverse(S))
    for got, want in zip(kernels.spd_inverse_factor(S), smallchol.spd_inverse_factor(S)):
        assert torch.equal(got, want)
    Sp = packed(S, 1, 2)
    assert torch.equal(kernels.spd_trace_product_packed(Sp, Sp),
                       smallchol.spd_trace_product_packed(Sp, Sp))
    S33, A33, R33, a33, _ = (t.to(cuda) for t in edge_inputs(2, 33, 20, torch.float32, seed=4))
    for got, want in zip(kernels.edge_factor_gain(S33, A33, R33, a33),
                         smallchol.edge_factor_gain(S33, A33, R33, a33)):
        assert torch.equal(got, want)
    empty = torch.zeros((2, 0, 0), device=cuda)
    with pytest.raises(ValueError):
        kernels.spd_inverse(empty)  # M = 0
    with pytest.raises(ValueError):
        kernels.spd_inverse_factor(empty)
    with pytest.raises(ValueError):
        kernels.spd_trace_product_packed(torch.zeros((1, 0, 2), device=cuda),
                                         torch.zeros((1, 0, 2), device=cuda))
    with pytest.raises(ValueError):
        kernels.edge_factor_gain(torch.zeros((2, 0, 0), device=cuda),
                                 torch.zeros((2, 0, 5), device=cuda),
                                 torch.zeros((3, 0), device=cuda), a33)
    with pytest.raises(TypeError):
        kernels.spd_inverse(S.int())
    with pytest.raises(TypeError):
        kernels.spd_inverse_factor(S.long())
    with pytest.raises(TypeError):
        kernels.edge_factor_gain(S33.int(), A33.int(), R33.int(), a33)


#: the CTA route's tested M: the 1 m grid's lattice (81) and continuous (121) M among them
CTA_M = [33, 48, 64, 81, 121]
CTA_KERNELS = ["spd_inverse", "spd_inverse_factor", "spd_trace_product", "edge_factor_gain"]


def kernel_and_plain(name, M, dtype, cuda, seed):
    """(the kernel's call, the plain version's outputs) on inputs with one
    clamped pivot: (9, M, M) matrices, (3, T, 3) packed blocks, or 5
    missions of N = 1600 columns with a per-mission mask."""
    if name in ("spd_inverse", "spd_inverse_factor"):
        S = random_spd(9, M, dtype, seed=seed)
        S[4, -1, -1] -= 2.0 * S[4].diagonal().sum()
        S = S.to(cuda)
        return (lambda: getattr(kernels, name)(S)), getattr(smallchol, name)(S)
    if name == "spd_trace_product":
        S = random_spd(9, M, dtype, seed=seed)
        S[4, -1, -1] -= 2.0 * S[4].diagonal().sum()
        Sp = packed(S.to(cuda), 3, 3)
        Gp = packed(random_spd(9, M, dtype, seed=seed + 1).to(cuda), 3, 3)
        return (lambda: kernels.spd_trace_product_packed(Sp, Gp)), \
            smallchol.spd_trace_product_packed(Sp, Gp)
    args = [t.to(cuda) for t in edge_inputs(5, M, 1600, dtype, seed=seed, clamp=True)]
    return (lambda: kernels.edge_factor_gain(*args)), smallchol.edge_factor_gain(*args)


@pytest.mark.parametrize("name", CTA_KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", CTA_M)
def test_cta_route_is_bitwise_plain(cuda, M, dtype, name):
    """Each kernel at the CTA route's M, its workspace in shared memory and
    then in global memory, against one plain result: bitwise, inf and NaN
    where the plain version has them (the clamped pivot)."""
    call, want = kernel_and_plain(name, M, dtype, cuda, seed=M + CTA_KERNELS.index(name))
    want = want if isinstance(want, tuple) else (want,)
    for route in ("shared", "global"):
        if route == "shared":
            got = call()
        else:
            with kernels.cta_workspace_in_global_memory():
                got = call()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert same(g, w), (route, name)


@pytest.mark.parametrize("N", [1, 31, 33, 1600])
@pytest.mark.parametrize("dtype,round_bf16", EDGE_DTYPES, ids=EDGE_IDS)
def test_cta_edge_factor_gain_columns_masks_and_rounding(cuda, N, dtype, round_bf16):
    """M = 33: fewer columns than a warp, one past a warp, the 1 m grid's
    1600; no mask, a shared (N,) mask and a per-mission (B, N) mask."""
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(6, 33, N, dtype, seed=N))
    for m in (None, mask[0].contiguous(), mask):
        want = smallchol.edge_factor_gain(S_raw, A, R, a, m, round_bf16)
        for glob in (False, True):
            if glob:
                with kernels.cta_workspace_in_global_memory():
                    got = kernels.edge_factor_gain(S_raw, A, R, a, m, round_bf16)
            else:
                got = kernels.edge_factor_gain(S_raw, A, R, a, m, round_bf16)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 5, 600])
def test_cta_route_covers_every_matrix(cuda, B, dtype):
    """The CTA route (M = 33) writes every matrix, block and mission of a
    batch, in shared memory (one CTA each) and in global memory (264 CTAs
    striding over the batch: B = 600 takes three rounds): the outputs'
    memory is first filled with NaN (freed at once, so the outputs reuse it)."""
    M = 33
    S = random_spd(B, M, dtype, seed=B).to(cuda)
    Sp, Gp = packed(S, 1, B), packed(random_spd(B, M, dtype, seed=B + 1).to(cuda), 1, B)
    edge = [t.to(cuda) for t in edge_inputs(B, M, 40, dtype, seed=B)]
    want = (smallchol.spd_inverse(S), smallchol.spd_inverse_factor(S),
            smallchol.spd_trace_product_packed(Sp, Gp), smallchol.edge_factor_gain(*edge))

    def run():
        out = []
        for fn in (lambda: (kernels.spd_inverse(S),), lambda: kernels.spd_inverse_factor(S),
                   lambda: (kernels.spd_trace_product_packed(Sp, Gp),),
                   lambda: kernels.edge_factor_gain(*edge)):
            torch.full((4 * B * M * 64,), float("nan"), dtype=dtype, device=cuda)
            out.append(fn())
        return out

    for glob in (False, True):
        if glob:
            with kernels.cta_workspace_in_global_memory():
                got = run()
        else:
            got = run()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            for gi, wi in zip(g, w if isinstance(w, tuple) else (w,)):
                assert bool(torch.isfinite(gi).all()) and torch.equal(gi, wi)


def poisoned(nbytes, cuda):
    """Fill nbytes of the caching allocator's memory with NaN and free it at
    once, so that the next outputs of that size reuse it: a matrix, block or
    mission that no CTA writes shows as NaN."""
    torch.full((nbytes // 8 + 1,), float("nan"), dtype=torch.float64, device=cuda)


def kernel_both_workspaces(call, nbytes, cuda):
    """call() with the CTA route's workspace in shared memory, then forced
    into global memory, each time into NaN-filled memory."""
    poisoned(nbytes, cuda)
    shared = call()
    poisoned(nbytes, cuda)
    with kernels.cta_workspace_in_global_memory():
        glob = call()
    torch.cuda.synchronize()
    return shared, glob


#: edge_factor_gain's CTA route at M = 33: every column count (N = 1 and 37
#: leave most of a 64-column tile empty, 1600 is the 1 m grid's 25 tiles),
#: every mask, with and without the bf16 round trip
EDGE_CTA_CASES = [(N, mask, rb) for N in (1, 37, 1600) for mask in ("none", "shared", "per")
                  for rb in (False, True)]
#: at M = 121, the 1 m continuous world's M (a plain call is ~20 s there)
EDGE_CTA_121 = [(5, 1, "shared", False), (5, 37, "none", True), (1, 1600, "per", False),
                (192, 1600, "per", False)]


def edge_case(B, M, N, mask, round_bf16, cuda, seed):
    S_raw, A, R, a, per = (t.to(cuda) for t in edge_inputs(B, M, N, torch.float32, seed=seed,
                                                           clamp=B > 1))
    m = {"none": None, "shared": per[0].contiguous(), "per": per}[mask]
    args = (S_raw, A, R, a, m, round_bf16)
    want = smallchol.edge_factor_gain(*args)
    for got in kernel_both_workspaces(lambda: kernels.edge_factor_gain(*args),
                                      A.numel() * A.element_size(), cuda):
        assert same(got[0], want[0]) and same(got[1], want[1])
    keep = torch.arange(B, device=cuda) != 1  # mission 1's clamped factor overflows
    assert bool(torch.isfinite(want[0][keep]).all()) and bool(torch.isfinite(want[1][keep]).all())


@pytest.mark.parametrize("N,mask,round_bf16", EDGE_CTA_CASES)
def test_cta_edge_factor_gain_ragged_tiles(cuda, N, mask, round_bf16):
    """M = 33, B = 5 (one mission clamped): Uᵀ·A's column tiles, the masks
    and the round trip, bitwise, in shared and global workspace."""
    edge_case(5, 33, N, mask, round_bf16, cuda, seed=N + len(mask) + round_bf16)


@pytest.mark.parametrize("B", [1, 192])
def test_cta_edge_factor_gain_batches(cuda, B):
    """M = 33, N = 1600: one mission, and CMA-ES's 192 members."""
    edge_case(B, 33, 1600, "per", False, cuda, seed=B)


@pytest.mark.parametrize("B,N,mask,round_bf16", EDGE_CTA_121)
def test_cta_edge_factor_gain_m121(cuda, B, N, mask, round_bf16):
    """M = 121 (passes of 128 rows of Wcᵀ), ragged and whole column tiles."""
    edge_case(B, 121, N, mask, round_bf16, cuda, seed=B + N)


@pytest.mark.parametrize("outer,inner", [(1, 1), (1, 7), (1, 16), (1, 1600), (3, 7)])
def test_cta_trace_product_slots(cuda, outer, inner):
    """M = 81: the trace product's CTA takes 2 blocks consecutive in inner;
    inner = 1 and 7 leave a slot empty, 16 fills eight CTAs, 1600 is the
    1 m sweep's gather layout, (3, 7) puts a CTA's blocks across two o.
    One block clamped; bitwise, in shared and global workspace."""
    M, n = 81, outer * inner
    S = random_spd(n, M, torch.float32, seed=inner)
    S[n // 2, -1, -1] -= 2.0 * S[n // 2].diagonal().sum()
    Sp = packed(S.to(cuda), outer, inner)
    Gp = packed(random_spd(n, M, torch.float32, seed=inner + 1).to(cuda), outer, inner)
    want = smallchol.spd_trace_product_packed(Sp, Gp)
    assert bool(torch.isfinite(want).all())
    for got in kernel_both_workspaces(lambda: kernels.spd_trace_product_packed(Sp, Gp),
                                      4 * n, cuda):
        assert torch.equal(got, want)


def test_cta_route_past_the_register_tiles(cuda):
    """M = 177, past the register tiles (M <= 176): the same wavefronts on
    the packed triangle in shared memory, one thread per row; one clamped
    pivot; bitwise, in shared and global workspace."""
    S = random_spd(3, 177, torch.float32, seed=177)
    S[1, -1, -1] -= 2.0 * S[1].diagonal().sum()
    S = S.to(cuda)
    want = smallchol.spd_inverse(S)
    for got in kernel_both_workspaces(lambda: kernels.spd_inverse(S), S.numel() * 4, cuda):
        assert same(got, want)


@pytest.fixture(scope="module")
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards (a launch on the inputs' card, not the current one)")
    return torch.device("cuda:0"), torch.device("cuda:1")


@pytest.mark.parametrize("M", [9, 81])
def test_kernels_launch_on_their_inputs_card(two_cards, M):
    """Each wrapper on tensors of cuda:1 while cuda:0 is current: the
    kernels launch there, on cuda:1's current stream, bitwise the plain
    version; cuda:0 stays current."""
    card0, card1 = two_cards
    S = random_spd(3, M, torch.float32, seed=M).to(card1)
    Sp = packed(S, 1, 3)
    edge = [t.to(card1) for t in edge_inputs(3, M, 50, torch.float32, seed=M)]
    want = (smallchol.spd_inverse(S), smallchol.spd_inverse_factor(S),
            smallchol.spd_trace_product_packed(Sp, Sp), smallchol.edge_factor_gain(*edge))
    with torch.cuda.device(card0):
        got = (kernels.spd_inverse(S), kernels.spd_inverse_factor(S),
               kernels.spd_trace_product_packed(Sp, Sp), kernels.edge_factor_gain(*edge))
        torch.cuda.synchronize(card1)
        assert torch.cuda.current_device() == card0.index
    for g, w in zip(got, want):
        for gi, wi in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert gi.device == card1 and torch.equal(gi, wi)


def test_edge_factor_gain_past_the_register_route_takes_the_cta_route(cuda):
    """M = 9 with N = 1700 columns: the register route's shared slices of
    four missions pass a CTA's shared memory, so the CTA route takes the
    launch, bitwise as well."""
    args = [t.to(cuda) for t in edge_inputs(7, 9, 1700, torch.float32, seed=17)]
    got = kernels.edge_factor_gain(*args)
    want = smallchol.edge_factor_gain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_greedy_slice_on_card_matches_cpu(cuda):
    """float64, canonical config: the slice on the card (through the
    kernels) chooses the CPU run's actions and matches its curves."""
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    B, T = 8, 4
    cpu_world = IPPWorld(cfg, dtype=torch.float64, device="cpu")
    state0 = cpu_world.init_state(B, torch.Generator().manual_seed(5))
    noise = torch.randn((T, B, cpu_world.H.shape[1]), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(6))
    want = GreedyPlanner(cpu_world, MissionConfig(type="greedy")).run(
        B, T, init_state=state0, noise=noise
    )
    card_world = IPPWorld(cfg, dtype=torch.float64)
    card_state0 = state0.replace(
        **{f.name: getattr(state0, f.name).to(cuda) for f in dataclasses.fields(state0)}
    )
    got = GreedyPlanner(card_world, MissionConfig(type="greedy")).run(
        B, T, init_state=card_state0, noise=noise.to(cuda)
    )
    np.testing.assert_array_equal(got.waypoints, want.waypoints)
    for k, v in want.metrics.items():
        np.testing.assert_allclose(got.metrics[k], v, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("seed", [3, 4100000000123])
def test_greedy_loop_exit_on_card_is_the_whole_loop(cuda, seed):
    """The greedy benchmark cell's inputs (B = 4096, bf16-streamed sweeps):
    ``Planner.run``, which leaves once no mission can move, gives the
    whole T-step loop's result bitwise, in fewer than T steps."""
    from benchmark import harness, inputs
    from ipp_rl_tpu_torch.config import config_from_dict
    from ipp_rl_tpu_torch.utils import tracing
    from test_torch_loop_exit import assert_same_result, full_loop

    config = harness.data_file("configs", "example")
    world = IPPWorld(config_from_dict(config["config"]), fast_sweeps=True)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    B, T = 4096, planner.max_steps()
    g = inputs.generator(seed, 0, cuda)
    gt = inputs.fields(config, B, g, cuda)
    noise = torch.randn((T, B, world.H.shape[1]), generator=g, device=cuda)
    mean0, cov0 = inputs.prior(config, cuda)
    budget = float(config["config"]["experiment"]["constraints"]["budget"])
    state = inputs.belief_state(mean0, cov0, inputs.start_pos(config, cuda), budget, gt)
    before = tracing.counts("plan.steps")
    got = planner.run(B, init_state=state, noise=noise)
    steps = tracing.counts("plan.steps")["plan.steps"] - before.get("plan.steps", 0)
    want = full_loop(planner, state, T, noise=noise)
    assert_same_result(got, want)
    assert steps < T


@pytest.fixture
def datasets(monkeypatch):
    """temperature_cmaes.yaml's ground truth: the repository's dataset."""
    import pathlib

    monkeypatch.setenv("DATASETS_DIR", str(pathlib.Path(__file__).resolve().parents[1]
                                           / "datasets"))


def _to(state, device):
    return state.replace(**{f.name: getattr(state, f.name).to(device)
                            for f in dataclasses.fields(state)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_measurement_model_at_on_card_matches_cpu(cuda, dtype):
    """The continuous model on the card: cell indices, weights and padded
    rows exact, R to the two exps' rounding (4 ulps)."""
    cfg = load_config(str(CONFIG_DIR / "temperature_cmaes.yaml"))
    gen = torch.Generator().manual_seed(0)
    pos = torch.rand((999, 3), generator=gen, dtype=torch.float64)
    pos = (pos * torch.tensor([34.0, 34.0, 12.0], dtype=torch.float64)
           - torch.tensor([2.0, 2.0, -4.0], dtype=torch.float64)).to(dtype)
    pos[:50, 2] = 10.0
    want = IPPWorld(cfg, dtype=dtype, device="cpu").measurement_model_at(pos)
    got = IPPWorld(cfg, dtype=dtype).measurement_model_at(pos.to(cuda))
    for g, w in zip(got[:4:2], want[:4:2]):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[3].cpu(), want[3])
    rtol = 4 * torch.finfo(dtype).eps
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=rtol, atol=0)


def test_step_position_commit_kernel_is_bitwise_plain(cuda):
    """K1 on a step_position commit's innovation matrices (padded rows R = 1,
    rf = 1 and rf = 2 positions), ragged B, bitwise."""
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg)
    B = 4097
    gen = torch.Generator(device=cuda).manual_seed(1)
    state = world.init_state(B, gen)
    wp = torch.rand((B, 3), generator=gen, device=cuda) * torch.tensor(
        [40.0, 40.0, 10.0], device=cuda) + torch.tensor([0.0, 0.0, 5.0], device=cuda)
    H, R, _, valid = world.measurement_model_at(wp)
    assert bool((~valid).any()) and bool((wp[:, 2] > 10).any()) and bool((wp[:, 2] <= 10).any())
    A = H @ state.cov
    S = A @ H.mT
    S = (0.5 * (S + S.mT) + torch.diag_embed(R)).contiguous()
    assert torch.equal(kernels.spd_inverse(S), smallchol.spd_inverse(S))


@pytest.mark.parametrize("B", [12, 12289])
def test_per_sample_edge_update_is_bitwise_plain(cuda, datasets, B):
    """The CMA-ES fitness's edge update: per-sample H and R from the
    continuous model, a (B, N) mask, kernel against plain, bitwise."""
    from ipp_rl_tpu_torch.ops import kalman

    cfg = load_config(str(CONFIG_DIR / "temperature_cmaes.yaml"))
    world = IPPWorld(cfg)
    gen = torch.Generator(device=cuda).manual_seed(2)
    state = world.init_state(1, gen)
    P = state.cov.expand(B, -1, -1).contiguous()
    wp = torch.rand((B, 3), generator=gen, device=cuda) * torch.tensor(
        [30.0, 30.0, 6.0], device=cuda) + torch.tensor([0.0, 0.0, 8.0], device=cuda)
    H, R, _, _ = world.measurement_model_at(wp)
    mask = (torch.rand((B, 100), generator=gen, device=cuda) > 0.3).float()
    got = kalman.kf_edge_factor_gain_per_sample(P, H, R, mask)
    A = H @ P
    want = smallchol.edge_factor_gain(A @ H.mT, A, R, torch.arange(B, device=cuda), mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cmaes_replan_on_card_kernels_equal_plain(cuda, datasets):
    """One CMA-ES replan (horizon 2, λ 4, 2 generations, B 4) through the
    kernels and through their plain versions: the same plans."""
    from ipp_rl_tpu_torch.planners import CMAESPlanner

    cfg = load_config(str(CONFIG_DIR / "temperature_cmaes.yaml"))
    world = IPPWorld(cfg)
    mc = dataclasses.replace(cfg.missions[0], episode_horizon=2, cma_popsize=4, cma_maxiter=2)
    planner = CMAESPlanner(world, mc)
    state = world.init_state(4, torch.Generator(device=cuda).manual_seed(3))

    def replan():
        return planner.replan_batch(state, generator=torch.Generator(device=cuda).manual_seed(4))

    got = replan()
    saved = {k: getattr(kernels, k) for k in ("spd_inverse", "spd_trace_product_packed",
                                              "edge_factor_gain")}
    try:
        for k in saved:
            setattr(kernels, k, getattr(smallchol, k))
        want = replan()
    finally:
        for k, fn in saved.items():
            setattr(kernels, k, fn)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_static_baseline_on_card_matches_cpu(cuda):
    """The lawnmower in float64 on the card against the CPU run, from one
    state and noise."""
    from ipp_rl_tpu_torch.planners import LawnmowerPlanner

    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    B, T = 4, 12
    cpu_world = IPPWorld(cfg, dtype=torch.float64, device="cpu")
    state0 = cpu_world.init_state(B, torch.Generator().manual_seed(5))
    noise = torch.randn((T, B, cpu_world.m_max_cont), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(6))
    mc = MissionConfig(type="lawnmower", step_size=5.0)
    want = LawnmowerPlanner(cpu_world, mc).run(B, T, init_state=state0, noise=noise)
    got = LawnmowerPlanner(IPPWorld(cfg, dtype=torch.float64), mc).run(
        B, T, init_state=_to(state0, cuda), noise=noise.to(cuda))
    np.testing.assert_array_equal(got.waypoints, want.waypoints)
    for k, v in want.metrics.items():
        np.testing.assert_allclose(got.metrics[k], v, rtol=1e-9, atol=1e-12)


def _classic(world, **changes):
    from ipp_rl_tpu_torch.planners import ClassicMCTSPlanner

    knobs = dict(type="mcts", num_simulations=6, episode_horizon=3, gamma=0.95, uct_c=2.0, k=4.0,
                 alpha=0.75, epsilon_expand=0.2, epsilon_rollout=0.5, horizontal_spacing=10.0)
    return ClassicMCTSPlanner(world, MissionConfig(**{**knobs, **changes}))


CLASSIC_TREE = ("parent", "action_in", "children", "num_children", "next_free", "visits",
                "value_sum", "budget", "wc_in")


@pytest.mark.parametrize("R", [256, 1025])
def test_classic_sweep_and_edge_inputs_are_bitwise_plain(cuda, R):
    """The classic planner's sweep (float32 streams, per-row masks of a root
    mean after commits) and edge update: each K2 launch and the edge kernel
    against their plain versions, bitwise."""
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg)
    planner = _classic(world)
    gen = torch.Generator(device=cuda).manual_seed(7)
    state = world.init_state(R, gen)
    for _ in range(3):
        a = torch.randint(0, world.num_actions, (R,), generator=gen, device=cuda)
        state = world.step_index(state, a, generator=gen)
    dmask = planner._diag_mask(state.mean, state.cov)
    assert bool((dmask == 0).any()) and not bool((dmask == dmask[:1]).all())
    recorded, launch = [], kernels.spd_trace_product_packed

    def record(S, G):
        recorded.append((S, G))
        return launch(S, G)

    kernels.spd_trace_product_packed = record
    try:
        planner._sweep_rewards(state.cov, planner._costs(state.pos), dmask)
    finally:
        kernels.spd_trace_product_packed = launch
    assert len(recorded) == 2 and all(S.dtype == torch.float32 for S, _ in recorded)
    for S, G in recorded:
        assert torch.equal(kernels.spd_trace_product_packed(S, G),
                           smallchol.spd_trace_product_packed(S, G))
    H = world.H[a]
    A = H @ state.cov
    args = (A @ H.mT, A, world.R_diag, a, dmask)
    for got, want in zip(kernels.edge_factor_gain(*args), smallchol.edge_factor_gain(*args)):
        assert torch.equal(got, want)


def test_classic_search_on_card_kernels_equal_plain(cuda):
    """One root-parallel GCB search (B 4, W 2) through the kernels and
    through their plain versions, from one generator seed: the same trees."""
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg)
    planner = _classic(world, num_simulations=12, num_mcts_workers=2, use_gcb_rollout=True)
    state = world.init_state(4, torch.Generator(device=cuda).manual_seed(8))

    def search():
        return planner.search(state, torch.Generator(device=cuda).manual_seed(9))[0]

    got = search()
    saved = {k: getattr(kernels, k) for k in ("spd_inverse", "spd_trace_product_packed",
                                              "edge_factor_gain")}
    try:
        for k in saved:
            setattr(kernels, k, getattr(smallchol, k))
        want = search()
    finally:
        for k, fn in saved.items():
            setattr(kernels, k, fn)
    for f in CLASSIC_TREE:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.visits[:, 0].tolist() == [6.0] * 8


def test_classic_search_on_card_matches_cpu(cuda):
    """float64, canonical config: one search on the card (through the
    kernels) with the CPU run's injected draws builds the CPU run's trees."""
    from ipp_rl_tpu_torch.planners.mcts_classic import ClassicDraws, gumbel

    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    cpu_world = IPPWorld(cfg, dtype=torch.float64, device="cpu")
    cpu = _classic(cpu_world, num_mcts_workers=2)
    B, R = 3, 6
    S, H, A, C = cpu.num_simulations, cpu.horizon, cpu_world.num_actions, cpu.max_children
    gen = torch.Generator().manual_seed(10)
    state0 = cpu_world.init_state(B, gen)
    draws = ClassicDraws(
        select=gumbel((S, H + 1, R, C), gen, torch.float64, "cpu"),
        expand=gumbel((S, H + 1, R, A), gen, torch.float64, "cpu"),
        expand_u=torch.rand((S, H + 1, R), generator=gen, dtype=torch.float64),
        rollout=gumbel((S, H, R, A), gen, torch.float64, "cpu"),
        rollout_u=torch.rand((S, H, R), generator=gen, dtype=torch.float64))
    want, want_stats = cpu.search(state0, draws=draws)
    card = _classic(IPPWorld(cfg, dtype=torch.float64), num_mcts_workers=2)
    got, got_stats = card.search(_to(state0, cuda), draws=ClassicDraws(
        **{f.name: getattr(draws, f.name).to(cuda) for f in dataclasses.fields(draws)
           if getattr(draws, f.name) is not None}))
    for f in CLASSIC_TREE[:5]:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in CLASSIC_TREE[5:]:
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f), rtol=1e-9, atol=1e-12)
    assert torch.equal(got_stats.best_child_action.cpu(), want_stats.best_child_action)


def test_classic_cell_search_on_card_graph_equal_eager_and_plain(cuda):
    """The classic benchmark cell's search at its R = 1024 rows (its
    configuration, its inputs and uniform draws from a seed, 4 of its
    simulations): the CUDA graph's replays, the Python loop through the
    kernels, and the loop through their plain versions build the same
    trees, bitwise, for two sets of draws in turn (the graph's inputs are
    refilled), with S·(Hc + H) lockstep steps counted a search."""
    from benchmark import harness, inputs
    from ipp_rl_tpu_torch.config import config_from_dict
    from ipp_rl_tpu_torch.planners.mcts_classic import ClassicDraws, ClassicMCTSPlanner
    from ipp_rl_tpu_torch.utils import tracing

    config = harness.data_file("configs", "example_classic")
    world = IPPWorld(config_from_dict(config["config"]), fast_sweeps=config["fast_sweeps"])
    mission = next(m for m in world.cfg.missions if m.type == "mcts")
    planner = ClassicMCTSPlanner(world, dataclasses.replace(mission, num_simulations=4))
    B, S, H = 1024, planner.num_simulations, planner.horizon
    A, K = world.num_actions, planner.max_children
    g = inputs.generator(18, 0, cuda)
    mean0, cov0 = inputs.prior(config, cuda)
    state = inputs.belief_state(mean0, cov0, inputs.start_pos(config, cuda), 200.0,
                                inputs.fields(config, B, g, cuda))
    state = state.replace(budget=50.0 + 150.0 * torch.rand((B,), generator=g, device=cuda))

    def u(*shape):
        return torch.rand(shape, generator=g, device=cuda)

    def search(draws, graphs):
        planner.use_graphs = graphs
        before = tracing.counts("classic.").get("classic.lockstep_steps", 0)
        tree = planner.search(state, draws=draws)[0]
        assert tracing.counts("classic.")["classic.lockstep_steps"] - before == S * (2 * H + 1)
        return {f: getattr(tree, f).clone() for f in CLASSIC_TREE}

    for _ in range(2):
        draws = ClassicDraws(select=u(S, H + 1, B, K), expand=u(S, H + 1, B, A),
                             expand_u=u(S, H + 1, B), rollout=u(S, H, B, A),
                             rollout_u=u(S, H, B))
        graphed, eager = search(draws, True), search(draws, False)
        saved = {k: getattr(kernels, k) for k in ("spd_inverse", "spd_trace_product_packed",
                                                  "edge_factor_gain")}
        try:
            for k in saved:
                setattr(kernels, k, getattr(smallchol, k))
            plain = search(draws, False)
        finally:
            for k, fn in saved.items():
                setattr(kernels, k, fn)
        for f in CLASSIC_TREE:
            assert torch.equal(graphed[f], eager[f]), f
            assert torch.equal(eager[f], plain[f]), f
        assert bool((graphed["visits"][:, 0] == S).all())


def _committed_state(world, B, seed, steps=3):
    gen = torch.Generator(device=world.device).manual_seed(seed)
    state = world.init_state(B, gen)
    for _ in range(steps):
        a = torch.randint(0, world.num_actions, (B,), generator=gen, device=world.device)
        state = world.step_index(state, a, generator=gen)
    return state, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_deployed_batch_of_one_is_bitwise_plain(cuda, dtype):
    """The deployed mission's shapes (one mission): each K2 launch of a
    greedy sweep (both groups in the (1, T, Ag) layout) and its tap launch,
    the commit's S for K1, and a zero replan's edge update, bitwise against
    their plain versions."""
    from ipp_rl_tpu_torch.ops.rewards import adaptive_mask
    from ipp_rl_tpu_torch.planners.base import sweep_rewards

    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg, dtype=dtype)
    state, gen = _committed_state(world, 1, seed=9)
    recorded, launch = [], kernels.spd_trace_product_packed
    taps, launch_taps = [], kernels.sweep_tap_blocks

    def record(S, G):
        recorded.append((S, G))
        return launch(S, G)

    def record_taps(*args, **kw):
        taps.append((args, kw))
        return launch_taps(*args, **kw)

    kernels.spd_trace_product_packed = record
    kernels.sweep_tap_blocks = record_taps
    try:
        sweep_rewards(world, state)
    finally:
        kernels.spd_trace_product_packed = launch
        kernels.sweep_tap_blocks = launch_taps
    assert sorted(tuple(S.shape) for S, _ in recorded) == [(1, 45, 100), (1, 45, 100)]
    for S, G in recorded:
        assert torch.equal(kernels.spd_trace_product_packed(S, G),
                           smallchol.spd_trace_product_packed(S, G))
    assert len(taps) == 1
    args, kw = taps[0]
    for got, want in zip(kernels.sweep_tap_blocks(*args, **kw),
                         smallchol.sweep_tap_blocks(*args, **kw)):
        assert torch.equal(got, want)
    a = torch.randint(0, world.num_actions, (1,), generator=gen, device=cuda)
    H = world.H[a]
    A = H @ state.cov
    S = A @ H.mT
    S_commit = (0.5 * (S + S.mT) + torch.diag_embed(world.R_diag[a])).contiguous()
    assert torch.equal(kernels.spd_inverse(S_commit), smallchol.spd_inverse(S_commit))
    scen = cfg.scenario
    mask = adaptive_mask(state.mean, torch.diagonal(state.cov, dim1=-2, dim2=-1),
                         scen.value_threshold, scen.interval_factor)
    args = (S, A, world.R_diag, a, mask)
    for got, want in zip(kernels.edge_factor_gain(*args), smallchol.edge_factor_gain(*args)):
        assert torch.equal(got, want)


def test_sharded_kalman_at_world_size_one_on_nccl(cuda):
    """parallel/sharded_kalman.py on a one-rank NCCL group: the row-sharded
    commit against the dense (Joseph) commit, float64 atol 1e-10, P'
    exactly symmetric; the action-sharded sweep equal to the dense one."""
    import torch.distributed as dist

    from ipp_rl_tpu_torch.ops.kalman import kf_sweep_gains, kf_update
    from ipp_rl_tpu_torch.ops.rewards import adaptive_mask
    from ipp_rl_tpu_torch.parallel import make_mesh
    from ipp_rl_tpu_torch.parallel.sharded_kalman import sharded_kf_update, sharded_sweep_gains

    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg, dtype=torch.float64)
    state, gen = _committed_state(world, 1, seed=10)
    P, mean = state.cov[0], state.mean[0]
    a = int(torch.randint(0, world.num_actions, (1,), generator=gen, device=cuda))
    z = torch.rand((world.H.shape[1],), generator=gen, device=cuda, dtype=torch.float64)
    scen = cfg.scenario
    mask = adaptive_mask(mean, torch.diagonal(P), scen.value_threshold, scen.interval_factor)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(mp=1)
        for zz in (z, None):
            mean_s, P_s = sharded_kf_update(mesh, P, mean, world.H[a], world.R_diag[a], zz)
            mean_d, P_d = kf_update(P, mean, world.H[a], world.R_diag[a], zz)
            torch.testing.assert_close(P_s, P_d, atol=1e-10, rtol=0)
            torch.testing.assert_close(mean_s, mean_d, atol=1e-10, rtol=0)
            assert torch.equal(P_s, P_s.mT)
        gains = sharded_sweep_gains(mesh, P, world.H, world.R_diag, mask)
        assert torch.equal(gains, kf_sweep_gains(P, world.H, world.R_diag, mask))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the sweep's taps

def taps_world(dtype, cuda):
    """example.yaml's dense group on the taps route: its tables on the card."""
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), dtype=dtype)
    (g,) = [g for g in world.sweep_batched["groups"] if g["kind"] == "taps"]
    return world, g


def taps_beliefs(B, N, dtype, fast, seed, cuda):
    """B random covariances (B, N, N) on the card, a mask with zeros, and
    Q = P·diag(m)·P in the stream dtype, as the sweep forms it."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    A = torch.randn((B, N, N), generator=gen, device=cuda, dtype=dtype) / N ** 0.5
    P = A @ A.mT + 0.1 * torch.eye(N, device=cuda, dtype=dtype)
    P = 0.5 * (P + P.mT)
    mask = (torch.rand((B, N), generator=gen, device=cuda) > 0.4).to(dtype)
    stream = torch.bfloat16 if fast else dtype
    Q = torch.matmul((P * mask[:, None, :]).to(stream), P.to(stream))
    return P, Q


def same_or_both_nan(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


#: name: (B, dtype, bf16 streams, jitter): greedy's cell, classic's, CMA-ES's init
TAPS_SHAPES = {
    "greedy-b4096-bf16": (4096, torch.float32, True, 0.0),
    "classic-r1024-f32": (1024, torch.float32, False, 0.0),
    "cmaes-b8192-f32": (8192, torch.float32, False, 0.0),
    "f32-jitter": (33, torch.float32, False, 1e-4),
    "f64": (33, torch.float64, False, 1e-4),
    "f64-bf16": (33, torch.float64, True, 0.0),
}


@pytest.mark.parametrize("shape", TAPS_SHAPES)
def test_sweep_tap_blocks_kernel_is_bitwise_plain(cuda, shape):
    """The kernel against its plain version on the card at the three paths'
    batches (bf16 streams at greedy's), in both dtypes and with jitter."""
    B, dtype, fast, jitter = TAPS_SHAPES[shape]
    _, g = taps_world(dtype, cuda)
    P, Q = taps_beliefs(B, 100, dtype, fast, seed=B, cuda=cuda)
    args = (P, Q, g["cells"], g["weights"], g["diag"], jitter, fast)
    got, want = kernels.sweep_tap_blocks(*args), smallchol.sweep_tap_blocks(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.shape == (B, 45, 100) and torch.equal(x, y)


def test_sweep_tap_blocks_masked_and_degenerate_beliefs(cuda):
    """A batch with all-zero masks, zero and 1e30-scaled covariances, and
    an inf and a NaN entry: equal to the plain version, NaN where it has NaN."""
    _, g = taps_world(torch.float32, cuda)
    P, _ = taps_beliefs(64, 100, torch.float32, False, seed=9, cuda=cuda)
    P[1] = 0.0
    P[2] *= 1e30
    P[3, 5, 7] = float("inf")
    P[4, 40, 41] = P[4, 41, 40] = float("nan")
    mask = (torch.rand((64, 100), device=cuda) > 0.4).float()
    mask[5:9] = 0.0
    for fast in (False, True):
        stream = torch.bfloat16 if fast else torch.float32
        Q = torch.matmul((P * mask[:, None, :]).to(stream), P.to(stream))
        args = (P, Q, g["cells"], g["weights"], g["diag"], 1e-4, fast)
        got, want = kernels.sweep_tap_blocks(*args), smallchol.sweep_tap_blocks(*args)
        for x, y in zip(got, want):
            assert same_or_both_nan(x, y)
        assert bool(torch.isnan(got[0][4]).any()) and bool((got[1][5:9] == 0).all())


@pytest.mark.parametrize("N,KT,dtype,offset", [
    (7, 1, torch.float32, 0), (37, 3, torch.float32, 0), (100, 8, torch.float32, 1),
    (100, 5, torch.float64, 1), (160, 2, torch.float64, 0), (64, 6, torch.float32, 0),
], ids=["n7", "n37", "n100-kt8-offset", "f64-offset", "f64-n160", "n64"])
def test_sweep_tap_blocks_any_taps_and_layout(cuda, N, KT, dtype, offset):
    """Random taps (KT = 1..8, repeated cells), grids whose rows fill no
    16-byte vector or whose blocks start off one, and an f64 block past 48 KB
    of shared memory: bitwise the plain version, both stream kinds."""
    gen = torch.Generator(device=cuda).manual_seed(N * 10 + KT)
    Mg, Ag = 3, 37
    cells = torch.randint(0, N, (Mg, KT, Ag), generator=gen, device=cuda, dtype=torch.int32)
    weights = torch.randn((Mg, KT, Ag), generator=gen, device=cuda, dtype=dtype)
    R = torch.rand((smallchol.packed_size(Mg), Ag), generator=gen, device=cuda, dtype=dtype)
    for fast in (False, True):
        P, Q = taps_beliefs(5, N, dtype, fast, seed=N, cuda=cuda)
        if offset:  # blocks that start one value past a 16-byte boundary
            P = torch.cat([P.new_zeros(1), P.reshape(-1)])[1:].view(P.shape)
        args = (P, Q, cells, weights, R, 1e-3, fast)
        got, want = kernels.sweep_tap_blocks(*args), smallchol.sweep_tap_blocks(*args)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_sweep_tap_blocks_refuses_and_counts(cuda):
    """Past a CTA's shared memory (N = 400 in f32) and past TAPS_MAX taps
    the kernel refuses; wrong dtypes and CPU inputs raise; each launch and
    no empty batch is counted on ``kernel.sweep_tap_blocks``."""
    _, g = taps_world(torch.float32, cuda)
    P, Q = taps_beliefs(2, 100, torch.float32, True, seed=1, cuda=cuda)
    args = [P, Q, g["cells"], g["weights"], g["diag"]]
    before = kernels.launch_counts()["sweep_tap_blocks"]
    kernels.sweep_tap_blocks(*args)
    S, G = kernels.sweep_tap_blocks(P[:0], Q[:0], *args[2:])
    assert S.shape == G.shape == (0, 45, 100)
    assert kernels.launch_counts()["sweep_tap_blocks"] == before + 1
    with pytest.raises(TypeError):
        kernels.sweep_tap_blocks(P.half(), Q, *args[2:])
    with pytest.raises(TypeError):
        kernels.sweep_tap_blocks(P, Q.half(), *args[2:])
    with pytest.raises(TypeError):
        kernels.sweep_tap_blocks(P, Q, g["cells"].long(), *args[3:])
    with pytest.raises(ValueError):
        kernels.sweep_tap_blocks(P, Q, g["cells"].cpu(), *args[3:])
    big = torch.zeros((1, 400, 400), device=cuda)
    cells = torch.zeros((9, 4, 100), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):
        kernels.sweep_tap_blocks(big, big, cells, g["weights"], g["diag"])
    many = torch.zeros((9, kernels.TAPS_MAX + 1, 100), device=cuda)
    with pytest.raises(RuntimeError):
        kernels.sweep_tap_blocks(P, Q, many.int(), many, g["diag"])


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_sweep_takes_one_tap_launch_and_no_two_stage(cuda, fast):
    """A sweep on the card: one ``sweep_tap_blocks`` launch, no two-stage
    call (``sweep.dense_two_stage``), and the gains of the sweep with the
    plain tap version in the kernel's place, bit for bit."""
    from ipp_rl_tpu_torch.ops import kalman
    from ipp_rl_tpu_torch.utils import tracing

    world, _ = taps_world(torch.float32, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    state = world.init_state(256, gen)
    for _ in range(2):
        a = torch.randint(0, world.num_actions, (256,), generator=gen, device=cuda)
        state = world.step_index(state, a, generator=gen)
    mask = (torch.rand(state.cov.shape[:2], generator=gen, device=cuda) > 0.4).float()
    before, two = kernels.launch_counts(), tracing.counts("sweep.")
    got = kalman.kf_sweep_gains_batched(state.cov, world.sweep_batched, mask, 1e-4, fast)
    after = kernels.launch_counts()
    assert after["sweep_tap_blocks"] == before["sweep_tap_blocks"] + 1
    assert after["spd_trace_product"] == before["spd_trace_product"] + 2
    assert tracing.counts("sweep.") == two
    launch = kernels.sweep_tap_blocks
    kernels.sweep_tap_blocks = smallchol.sweep_tap_blocks
    try:
        want = kalman.kf_sweep_gains_batched(state.cov, world.sweep_batched, mask, 1e-4, fast)
    finally:
        kernels.sweep_tap_blocks = launch
    assert torch.equal(got, want)
