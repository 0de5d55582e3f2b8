"""The search's edge update, from (S, A) to the edge factor and its gain
(ipp_rl_tpu_torch/ops/smallchol.edge_factor_gain, the plain version of the
kernel of the same name, and ops/kalman.kf_edge_factor_gain, its caller),
against the JAX package's kf_gain_factor_t (ipp_rl_tpu/ops/kalman.py:88)
and ZeroMCTS.edge_update (ipp_rl_tpu/planners/zero/mcts.py:187), on
numpy-seeded covariances and actions with the worlds' own H and R tables,
on small_cfg and the canonical config.

Also the orders the plain version fixes for the kernel: the gain's warp
order (lane sums of every 32nd column, then a halving tree) and Uᵀ·A in
the JAX package's ``_small_mm`` order, each against a hand-written copy.

Tolerances: float64 rtol 1e-12 (the same unrolled algebra; only the two
GEMMs and the gain's summation order differ), float32 rtol 1e-5 (the
GEMMs' rounding, through a 9×9 factorisation); entries near zero are held
to the same tolerance times the largest entry.  The bf16 round trip is
held to one bfloat16 step (2⁻⁸ of the value): float32 inputs that differ
in the last bits can round to neighbouring bfloat16 values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.ops.kalman import kf_gain_factor_t as jax_kf_gain_factor_t
from ipp_rl_tpu.planners.zero.mcts import ZeroMCTS as JaxMCTS
from ipp_rl_tpu_torch.config import MCTSZeroHyperParams
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kalman, kernels, smallchol
from ipp_rl_tpu_torch.planners.zero.mcts import ZeroMCTS

from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

B = 5
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JAX_DT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def inputs(jworld, dtype, seed=0):
    """P (B, N, N): the world's GP prior scaled per mission plus a random
    SPD term; actions (B,); a 0/1 mask (B, N)."""
    rng = np.random.default_rng(seed)
    n = jworld.cfg.environment.num_cells
    prior = np.asarray(jworld.init_state(jax.random.key(0), 1).cov[0], np.float64)
    Q = rng.normal(size=(B, n, n))
    P = prior * rng.uniform(0.3, 1.0, size=(B, 1, 1)) + 0.1 * Q @ np.swapaxes(Q, -1, -2) / n
    a = rng.integers(0, jworld.num_actions, size=B)
    mask = (rng.random((B, n)) > 0.4).astype(np.float64)
    t = lambda x: torch.from_numpy(np.array(x, np.float64)).to(dtype)  # noqa: E731
    return P, a, mask, {"P": t(P), "a": torch.from_numpy(a), "mask": t(mask),
                        "H": t(jworld.H), "R": t(jworld.R_diag)}


def jax_edge_updates(jworld, edge_dtype=None):
    """One compile: kf_gain_factor_t's Wcᵀ and ZeroMCTS.edge_update's
    (Wcᵀ, gain) without and with the mask, vmapped over the missions."""
    jmcts = JaxMCTS(jworld, JaxHP(), 3, None, edge_dtype=edge_dtype)

    @jax.jit
    def run(P, a, mask):
        kf = jax.vmap(lambda p, ai: jax_kf_gain_factor_t(p, jworld.H[ai], jworld.R_diag[ai])[0])
        plain = jax.vmap(lambda p, ai: jmcts.edge_update(p, ai, None))
        return kf(P, a), plain(P, a), jax.vmap(jmcts.edge_update)(P, a, mask)

    return run


@pytest.fixture(scope="module")
def refs(small_cfg, canonical_cfg):
    """(inputs, JAX outputs) per (config, dtype, edge dtype), computed once."""
    cfgs = {"small": small_cfg, "canonical": canonical_cfg}
    cache = {}

    def get(name, dtype, edge_dtype=None):
        key = (name, dtype, edge_dtype)
        if key not in cache:
            jworld = JaxWorld(cfgs[name], dtype=JAX_DT[dtype])
            P, a, mask, port = inputs(jworld, dtype)
            jdt = JAX_DT[dtype]
            out = jax_edge_updates(jworld, edge_dtype)(
                jnp.asarray(P, jdt), jnp.asarray(a), jnp.asarray(mask, jdt))
            cache[key] = port, jax.tree_util.tree_map(np.asarray, out)
        return cache[key]

    return get


def close(got, want, rtol):
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


CASES = [(c, d, m) for c in ("small", "canonical") for d in (torch.float64, torch.float32)
         for m in (False, True)]
IDS = [f"{c}-{str(d)[6:]}-{'mask' if m else 'nomask'}" for c, d, m in CASES]


@pytest.mark.parametrize("cfg,dtype,use_mask", CASES, ids=IDS)
def test_edge_factor_gain_matches_jax(refs, cfg, dtype, use_mask):
    """The plain version on S_raw = A·Hᵀ and A = H·P against
    kf_gain_factor_t's Wcᵀ and edge_update's gain."""
    port, (kf_wct, plain, masked) = refs(cfg, dtype)
    H = port["H"][port["a"]]
    A = H @ port["P"]
    WcT, gain = smallchol.edge_factor_gain(A @ H.mT, A, port["R"], port["a"],
                                           port["mask"] if use_mask else None)
    assert WcT.dtype == gain.dtype == dtype and gain.shape == (B,)
    close(WcT, kf_wct, RTOL[dtype])
    close(gain, (masked if use_mask else plain)[1], RTOL[dtype])
    assert (gain > 0).all()


@pytest.mark.parametrize("cfg,dtype,use_mask", CASES, ids=IDS)
def test_kf_edge_factor_gain_matches_jax_edge_update(refs, cfg, dtype, use_mask):
    port, (_, plain, masked) = refs(cfg, dtype)
    want_wct, want_gain = masked if use_mask else plain
    WcT, gain = kalman.kf_edge_factor_gain(port["P"], port["H"], port["R"], port["a"],
                                           port["mask"] if use_mask else None)
    close(WcT, want_wct, RTOL[dtype])
    close(gain, want_gain, RTOL[dtype])
    # and the same factor as the port's own kf_gain_factor_t
    H = port["H"][port["a"]]
    close(WcT, kalman.kf_gain_factor_t(port["P"], H, port["R"][port["a"]])[0].numpy(),
          RTOL[dtype])


@pytest.mark.parametrize("cfg", ["small", "canonical"])
def test_bf16_round_trip_matches_jax(refs, cfg):
    """float32 P with bfloat16 edges: Wcᵀ is rounded to bfloat16 and back
    before the gain, as the JAX package's edge_update with
    edge_dtype=bfloat16 does; within one bfloat16 step of it."""
    port, (_, _, (want_wct, want_gain)) = refs(cfg, torch.float32, jnp.bfloat16)
    WcT, gain = kalman.kf_edge_factor_gain(port["P"], port["H"], port["R"], port["a"],
                                           port["mask"], round_bf16=True)
    assert torch.equal(WcT, WcT.to(torch.bfloat16).to(torch.float32))
    close(WcT, want_wct, 2.0 ** -8)
    np.testing.assert_allclose(gain.numpy(), want_gain, rtol=2.0 ** -8)
    exact, exact_gain = kalman.kf_edge_factor_gain(port["P"], port["H"], port["R"], port["a"],
                                                   port["mask"])
    assert torch.equal(WcT, exact.to(torch.bfloat16).to(torch.float32))
    assert not torch.equal(gain, exact_gain)


def lane_order_sum(x):
    """The warp's order by hand: lane l sums x[l], x[l + 32], … (zeros past
    N), then lane l takes lane l + w's sum for w = 16, 8, 4, 2, 1."""
    n = x.shape[-1]
    end = -(-n // 32) * 32
    zero = np.zeros_like(x[..., 0])
    lanes = []
    for lane in range(32):
        cols = [x[..., col] if col < n else zero for col in range(lane, end, 32)]
        acc = cols[0]
        for v in cols[1:]:
            acc = acc + v
        lanes.append(acc)
    w = 16
    while w:
        lanes = [lanes[lane] + lanes[lane + w] for lane in range(w)]
        w //= 2
    return lanes[0]


@pytest.mark.parametrize("n", [1, 31, 32, 100, 129])
def test_warp_order_sum_is_the_documented_order(n):
    x = np.random.default_rng(n).random((7, n))
    got = smallchol.warp_order_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, lane_order_sum(x))
    np.testing.assert_allclose(got, x.sum(axis=-1), rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wct_is_the_unrolled_small_mm(dtype):
    """Wcᵀ = Uᵀ·A bit for bit as the JAX package's _small_mm unrolls it
    (ipp_rl_tpu/ops/kalman.py:113): U[0,m]·A[0], then + U[k,m]·A[k]."""
    rng = np.random.default_rng(3)
    M, n = 9, 37
    X = rng.normal(size=(4, M, M))
    S_raw = (X @ np.swapaxes(X, -1, -2)).astype(dtype)
    A = rng.normal(size=(4, M, n)).astype(dtype)
    R = rng.uniform(0.5, 1.5, size=(6, M)).astype(dtype)
    a = torch.tensor([0, 5, 2, 5])
    WcT, gain = smallchol.edge_factor_gain(torch.from_numpy(S_raw), torch.from_numpy(A),
                                           torch.from_numpy(R), a)
    S = 0.5 * (S_raw + np.swapaxes(S_raw, -1, -2)) + np.stack([np.diag(r) for r in R[a]])
    U = smallchol.spd_inverse_factor(torch.from_numpy(S))[1].numpy()
    rows = []
    for m in range(M):
        acc = U[:, 0, m, None] * A[:, 0]
        for k in range(1, M):
            acc = acc + U[:, k, m, None] * A[:, k]
        rows.append(acc)
    want = np.stack(rows, axis=-2)
    np.testing.assert_array_equal(WcT.numpy(), want)
    sq = want[:, 0] * want[:, 0]
    for m in range(1, M):
        sq = sq + want[:, m] * want[:, m]
    np.testing.assert_array_equal(gain.numpy(), lane_order_sum(sq))


def test_cpu_route_launches_nothing(refs):
    port, _ = refs("small", torch.float64)
    H = port["H"][port["a"]]
    A = H @ port["P"]
    args = (A @ H.mT, A, port["R"], port["a"], port["mask"])
    before = kernels.launch_counts()
    got = kernels.edge_factor_gain(*args)
    want = smallchol.edge_factor_gain(*args)
    kalman.kf_edge_factor_gain(port["P"], port["H"], port["R"], port["a"], port["mask"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.launch_counts() == before


def test_edge_update_refuses_other_edge_dtypes(small_cfg):
    world = IPPWorld(port_cfg(small_cfg), dtype=torch.float32, device="cpu")
    P = torch.eye(world.cfg.environment.num_cells)[None]
    a = torch.tensor([3])
    mcts = ZeroMCTS(world, MCTSZeroHyperParams(), 3, None, edge_dtype=torch.float16)
    with pytest.raises(ValueError):
        mcts.edge_update(P, a, None)
    for edge_dtype in (None, torch.float32, torch.bfloat16):
        WcT, gain = ZeroMCTS(world, MCTSZeroHyperParams(), 3, None,
                             edge_dtype=edge_dtype).edge_update(P, a, None)
        assert WcT.dtype == gain.dtype == torch.float32
