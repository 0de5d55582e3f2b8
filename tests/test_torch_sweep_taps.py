"""The sweep's dense group from H's taps (ops/kalman.py's taps route, with
``ops/smallchol.sweep_tap_blocks`` its plain version) against the two-stage
contraction it replaces and the JAX package's ``kf_sweep_gains_batched``.

On both configurations (example.yaml, temperature_cmaes.yaml) the dense
group is H (100, 9, 100) with at most 4 nonzeros a row: the taps route.
Held, over configurations and precisions: the taps tables give H back; the
packed S and G blocks equal H·X·Hᵀ symmetrised, and the all-zero padding
rows get R (+ jitter) and 0 exactly; the gains against the two-stage
route and JAX (float64: rtol 1e-12 against the two-stage form; bf16
streams: the existing bf16 tolerance and argmax agreement).  A plan whose
(N, N) block passes a CTA's shared memory (the 2 m grid, N = 400) keeps
the two-stage route and counts it.  The kernel itself is held bitwise to
the plain version in tests/test_torch_kernels_gpu.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

from ipp_rl_tpu.config.schema import load_config as jax_load_config
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.ops import kalman as jk
from ipp_rl_tpu_torch.config import CONFIG_DIR, config_from_dict, load_config
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kalman as tk
from ipp_rl_tpu_torch.ops import kernels, smallchol
from ipp_rl_tpu_torch.ops.sensor_model import build_sweep_plan
from ipp_rl_tpu_torch.utils import tracing

from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

CONFIGS = ("example.yaml", "temperature_cmaes.yaml")
JAX_CONFIG_DIR = CONFIG_DIR.parents[1] / "ipp_rl_tpu" / "config"
#: name: (belief dtype, bf16 streams)
PRECISIONS = {"f64": (torch.float64, False), "f32": (torch.float32, False),
              "bf16": (torch.float32, True)}


def worlds(name, dtype, monkeypatch):
    """The port's world on the taps route, its plan's sweep on the two-stage
    route, and the JAX world."""
    # temperature_cmaes.yaml's ground truth is the repository's dataset
    monkeypatch.setenv("DATASETS_DIR", str(CONFIG_DIR.parents[1] / "datasets"))
    cfg = load_config(str(CONFIG_DIR / name))
    world = IPPWorld(cfg, dtype=dtype, device="cpu")
    plan = build_sweep_plan(world.table, x_dim=cfg.environment.x_dim, y_dim=cfg.environment.y_dim)
    with monkeypatch.context() as m:
        m.setattr(kernels, "sweep_taps_fit", lambda *args: False)
        two_stage = tk.prepare_batched_sweep(plan, dtype, "cpu")
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return world, two_stage, JaxWorld(jax_load_config(str(JAX_CONFIG_DIR / name)), dtype=jdt)


def beliefs(world, B, seed):
    """B covariances after 0, 1, 2, ... commits of random actions, and a
    per-mission mask with zeros."""
    gen = torch.Generator().manual_seed(seed)
    state = world.init_state(B, gen)
    Ps = [state.cov[0]]
    for b in range(1, B):
        a = torch.randint(0, world.num_actions, (B,), generator=gen)
        state = world.step_index(state, a, generator=gen)
        Ps.append(state.cov[b])
    mask = (torch.rand((B, world.H.shape[-1]), generator=gen) > 0.4).to(world.dtype)
    return torch.stack(Ps), mask


def taps_group(sweep):
    (g,) = [g for g in sweep["groups"] if g["kind"] == "taps"]
    return g


@pytest.mark.parametrize("name", CONFIGS)
def test_taps_tables_give_h_back(name, monkeypatch):
    """Each row's taps are its nonzeros in cell order, padded with (0, 0.0):
    scattered back they give the group's H, and KT is 4."""
    world, two_stage, _ = worlds(name, torch.float64, monkeypatch)
    assert [g["kind"] for g in world.sweep_batched["groups"]] == ["gather", "taps"]
    assert [g["kind"] for g in two_stage["groups"]] == ["gather", "dense"]
    g, H = taps_group(world.sweep_batched), two_stage["groups"][1]["H"]
    Ag, Mg, N = H.shape
    assert g["cells"].shape == g["weights"].shape == (Mg, 4, Ag)
    assert g["cells"].dtype == torch.int32
    back = torch.zeros_like(H)
    cells, weights = g["cells"].long().permute(2, 0, 1), g["weights"].permute(2, 0, 1)
    back.scatter_add_(-1, cells, weights)
    assert torch.equal(back, H)
    assert bool((cells[weights == 0] == 0).all())
    assert int((H == 0).all(-1).sum()) > 0  # all-zero padding rows are there
    assert torch.equal(g["diag"], two_stage["groups"][1]["R"].T)


@pytest.mark.parametrize("jitter", [0.0, 1e-4], ids=["nojitter", "jitter"])
@pytest.mark.parametrize("name", CONFIGS)
def test_tap_blocks_are_h_x_ht(name, jitter, monkeypatch):
    """float64: S = sym(H·P·Hᵀ) + R (+ jitter) and G = sym(H·Q·Hᵀ) packed
    in (B, T, Ag), to rtol 1e-12; on all-zero rows exactly R (+ jitter)
    and 0."""
    world, two_stage, _ = worlds(name, torch.float64, monkeypatch)
    g, H = taps_group(world.sweep_batched), two_stage["groups"][1]["H"]
    P, mask = beliefs(world, 4, seed=11)
    Q = (P * mask[:, None, :]) @ P
    S, G = smallchol.sweep_tap_blocks(P, Q, g["cells"], g["weights"], g["diag"], jitter)
    Mg = H.shape[1]

    def packed(X):  # (B, Ag, Mg, Mg) → (B, T, Ag)
        return smallchol.pack_lower(X).transpose(1, 2)

    def sym(X):
        Y = torch.einsum("aim,bmn,ajn->baij", H, X, H)
        return 0.5 * (Y + Y.mT)

    R = g["diag"][None]  # the packed diagonals of R, (1, T, Ag)
    eye = jitter * torch.eye(Mg, dtype=P.dtype)
    np.testing.assert_allclose(S.numpy(), (packed(sym(P) + eye) + R).numpy(), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(G.numpy(), packed(sym(Q)).numpy(), rtol=1e-12, atol=1e-15)
    zero = (H == 0).all(-1)  # (Ag, Mg)
    ti, tj = np.tril_indices(Mg)
    rows = (zero[:, ti] | zero[:, tj]).T  # (T, Ag): entries with an all-zero row
    want_s = (R + jitter * torch.as_tensor(ti == tj, dtype=P.dtype)[:, None]).expand_as(S)
    assert torch.equal(S[:, rows], want_s[:, rows])
    assert bool((G[:, rows] == 0).all()) and not bool(torch.signbit(G[:, rows]).any())


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", CONFIGS)
def test_taps_sweep_matches_two_stage_and_jax(name, precision, monkeypatch):
    """The whole sweep on the taps route against the two-stage route and
    the JAX package, with a per-mission mask and with jitter: float64 to
    rtol 1e-12 against the two-stage form (1e-9 against JAX, whose GEMMs sum
    in another order), float32 to 1e-5 of the largest gain, bf16 streams to
    0.05 of it with the greedy argmax agreeing."""
    dtype, fast = PRECISIONS[precision]
    world, two_stage, jworld = worlds(name, dtype, monkeypatch)
    P, mask = beliefs(world, 6, seed=5)
    for m, jitter in ((None, 0.0), (mask, 1e-4)):
        got = tk.kf_sweep_gains_batched(P, world.sweep_batched, m, jitter, fast).numpy()
        before = tracing.counts("sweep.").get("sweep.dense_two_stage", 0)
        ref = tk.kf_sweep_gains_batched(P, two_stage, m, jitter, fast).numpy()
        assert tracing.counts("sweep.")["sweep.dense_two_stage"] == before + 1
        want = np.asarray(jk.kf_sweep_gains_batched(
            jnp.asarray(P.numpy()), jworld.sweep_batched,
            None if m is None else jnp.asarray(m.numpy()), jitter=jitter, fast_math=fast))
        if precision == "f64":
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
            continue
        tol = 0.05 if fast else 1e-5
        for other in (ref, want):
            assert np.abs(got - other).max() / np.abs(other).max() < tol
            if fast:
                assert np.sum(np.argmax(got, 1) == np.argmax(other, 1)) >= len(P) - 1


def test_two_stage_route_past_shared_memory():
    """The 2 m grid (N = 400): one mission's (N, N) block passes a CTA's
    shared memory in either dtype, so its dense group keeps the two-stage
    route, which counts each sweep; the canonical grid's counts none."""
    with open(CONFIG_DIR / "example.yaml") as f:
        raw = yaml.safe_load(f)
    raw["environment"] = {"x_dim": 20, "y_dim": 20, "resolution": 2}
    world = IPPWorld(config_from_dict(raw), dtype=torch.float32, device="cpu")
    kinds = [g["kind"] for g in world.sweep_batched["groups"]]
    assert "dense" in kinds and "taps" not in kinds
    assert not kernels.sweep_taps_fit(400, torch.float32, 4)
    assert kernels.sweep_taps_fit(100, torch.float64, 4)
    assert not kernels.sweep_taps_fit(100, torch.float32, kernels.TAPS_MAX + 1)
    P = world.init_state(2, torch.Generator().manual_seed(0)).cov
    before = tracing.counts("sweep.").get("sweep.dense_two_stage", 0)
    tk.kf_sweep_gains_batched(P, world.sweep_batched)
    assert tracing.counts("sweep.")["sweep.dense_two_stage"] == before + 1
    canonical = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), device="cpu")
    tk.kf_sweep_gains_batched(canonical.init_state(2, torch.Generator().manual_seed(0)).cov,
                              canonical.sweep_batched)
    assert tracing.counts("sweep.")["sweep.dense_two_stage"] == before + 1
