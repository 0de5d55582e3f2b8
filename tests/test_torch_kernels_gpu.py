"""The hand-written CUDA kernels (ipp_rl_tpu_torch/csrc/smallchol.cu) on the
card, against their plain PyTorch versions, and the greedy slice on the
card against the same slice on the CPU.

``spd_trace_product`` is tested through its packed entry, the one the
sweep calls, in both sweep layouts and against the full-block plain
version.  ``spd_inverse_factor`` (the search's edge update) returns the
inverse and its Cholesky factor; where a clamped pivot makes the factor
overflow, its inf and NaN entries must sit where the plain version's do.
``edge_factor_gain`` (the search's whole edge update after its two GEMMs)
is held to the same on clamped pivots, in both dtypes, with the bf16
round trip, for every column chunk and every mission of a batch.

These tests need an NVIDIA Hopper card and the CUDA toolkit; elsewhere
they skip.  They import no JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

The kernels perform the plain versions' operations in the same order with
one rounding each (no FMA contraction), so they are held to bitwise
equality."""

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


def random_spd(n, M, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn((n, M, M), generator=gen, dtype=torch.float64)
    return (A @ A.mT + 0.5 * torch.eye(M, dtype=torch.float64)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", list(range(1, 13)))
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
@pytest.mark.parametrize("M", [1, 2, 4, 9, 12])
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
@pytest.mark.parametrize("M", list(range(1, 13)))
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
@pytest.mark.parametrize("M", list(range(1, 13)))
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
        S.data_ptr(), inv.data_ptr(), U.data_ptr(), B, 9, kernels._DTYPE_CODES[dtype],
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
@pytest.mark.parametrize("M", list(range(1, 13)))
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
        WcT.data_ptr(), gain.data_ptr(), B, 9, 100, 0, kernels._DTYPE_CODES[dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err == 0
    want = smallchol.edge_factor_gain(S_raw, A, R, a, mask)
    assert bool(torch.isfinite(WcT).all()) and bool(torch.isfinite(gain).all())
    assert torch.equal(WcT, want[0]) and torch.equal(gain, want[1])
    got = kernels.edge_factor_gain(S_raw, A, R, a, mask)  # and through the wrapper
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
    n_inv, n_tr = kernels.spd_inverse.launches, kernels.spd_trace_product_packed.launches
    kernels.spd_inverse(S)
    kernels.spd_trace_product_packed(packed(S, 1, 4), packed(S, 1, 4))
    assert kernels.spd_inverse.launches == n_inv + 1
    assert kernels.spd_trace_product_packed.launches == n_tr + 1
    empty = kernels.spd_inverse(S[:0])
    assert empty.shape == (0, 9, 9) and kernels.spd_inverse.launches == n_inv + 1
    n_fac = kernels.spd_inverse_factor.launches
    kernels.spd_inverse_factor(S)
    inv, U = kernels.spd_inverse_factor(S[:0])
    assert inv.shape == U.shape == (0, 9, 9)
    assert kernels.spd_inverse_factor.launches == n_fac + 1
    S_raw, A, R, a, mask = (t.to(cuda) for t in edge_inputs(4, 9, 100, torch.float32, seed=2))
    n_edge = kernels.edge_factor_gain.launches
    kernels.edge_factor_gain(S_raw, A, R, a, mask)
    WcT, gain = kernels.edge_factor_gain(S_raw[:0], A[:0], R, a[:0], mask[:0])
    assert WcT.shape == (0, 9, 100) and gain.shape == (0,)
    assert kernels.edge_factor_gain.launches == n_edge + 1
    kernels.reset_launch_counts()
    assert (kernels.spd_inverse.launches, kernels.spd_inverse_factor.launches,
            kernels.spd_trace_product_packed.launches, kernels.edge_factor_gain.launches) == (
        0, 0, 0, 0)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    S = random_spd(4, 9, torch.float32, seed=3).to(cuda)
    with pytest.raises(ValueError):
        kernels.spd_inverse(S.mT)  # not contiguous
    with pytest.raises(ValueError):
        kernels.spd_inverse(random_spd(2, 13, torch.float32, seed=4).to(cuda))
    with pytest.raises(TypeError):
        kernels.spd_inverse(S.half())
    with pytest.raises(ValueError):
        kernels.spd_inverse_factor(S.mT)  # not contiguous
    with pytest.raises(ValueError):
        kernels.spd_inverse_factor(random_spd(2, 13, torch.float32, seed=4).to(cuda))
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
    S13, A13, R13, a13, _ = (t.to(cuda) for t in edge_inputs(2, 13, 20, torch.float32, seed=4))
    with pytest.raises(ValueError):
        kernels.edge_factor_gain(S13, A13, R13, a13)  # M = 13
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    from ipp_rl_tpu_torch.planners.zero.mcts import ZeroMCTS

    world = IPPWorld(cfg)
    mcts = ZeroMCTS(world, cfg.missions[0].hyper_params, 5, None, edge_dtype=torch.float16)
    P = torch.eye(cfg.environment.num_cells, device=cuda)[None]
    with pytest.raises(ValueError):  # an edge dtype the kernel does not round to
        mcts.edge_update(P, torch.zeros((1,), dtype=torch.long, device=cuda), None)


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
