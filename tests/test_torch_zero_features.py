"""The port's feature planes (ipp_rl_tpu_torch/planners/zero/features.py)
against the JAX package's, in float64 on the same numpy-seeded histories:
the history ring, the FoV footprint (exact) and the planes (within 1e-12),
with the adaptive mask on and off, FoV planes on and off, action costs
on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.planners.zero import features as jf
from ipp_rl_tpu_torch.config import MCTSZeroHyperParams
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners.zero import features

from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

B, L = 3, 3


def histories(cfg, seed):
    """A JAX (vmapped) history with two of its three slots pushed, and the
    same history for the port."""
    n = cfg.environment.num_cells
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(2, B, n, n))
    covs = A @ np.swapaxes(A, -1, -2) / n + 0.1 * np.eye(n)
    pos = rng.uniform([0, 0, 8], [24, 24, 14], size=(2, B, 3))
    pos[0, 0] = [2.0, 2.0, 14.0]  # a lattice position
    budgets = rng.uniform(0.2, 1.0, size=(2, B))
    jhp = JaxHP(input_history_length=L)
    jh = jax.vmap(lambda _: jf.init_history(cfg, jhp, jnp.float64))(jnp.arange(B))
    h = features.init_history(cfg, MCTSZeroHyperParams(input_history_length=L), B,
                              torch.float64, device="cpu")
    for k in range(2):
        jh = jax.vmap(jf.push_history)(jh, jnp.asarray(covs[k]), jnp.asarray(pos[k]),
                                       jnp.asarray(budgets[k]))
        h = features.push_history(h, torch.from_numpy(covs[k]), torch.from_numpy(pos[k]),
                                  torch.from_numpy(budgets[k]))
    return jh, h


def assert_history_equal(h, jh):
    for name in ("covs", "positions", "budgets", "length"):
        np.testing.assert_array_equal(getattr(h, name).numpy(), np.asarray(getattr(jh, name)))


def test_push_history_matches_jax(small_cfg):
    jh, h = histories(small_cfg, seed=0)
    assert_history_equal(h, jh)
    assert h.length.tolist() == [2] * B
    for _ in range(2):  # the ring is capped at L
        jh = jax.vmap(jf.push_history)(jh, jh.covs[:, 0], jh.positions[:, 0], jh.budgets[:, 0])
        h = features.push_history(h, h.covs[:, 0], h.positions[:, 0], h.budgets[:, 0])
    assert_history_equal(h, jh)
    assert h.length.tolist() == [L] * B


def test_fov_cell_mask_matches_jax(small_cfg):
    rng = np.random.default_rng(1)
    pos = rng.uniform([-2, -2, 6], [26, 26, 16], size=(64, 3))
    pos[:8] = [[2, 2, 8], [22, 22, 14], [0, 0, 10], [10, 6, 8],
               [14, 10, 14], [2, 22, 8], [23.9, 0.1, 14], [12, 12, 11]]
    want = np.asarray(jax.vmap(lambda p: jf.fov_cell_mask(small_cfg, p))(jnp.asarray(pos)))
    got = features.fov_cell_mask(port_cfg(small_cfg), torch.from_numpy(pos)).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # footprints of many sizes, some emptied by the dropped last row/column
    assert want.any(axis=1)[:8].all() and len(set(want.sum(axis=1))) > 3


def cfg_variant(cfg, adaptive):
    return dataclasses.replace(cfg, scenario=dataclasses.replace(cfg.scenario, adaptive=adaptive))


@pytest.mark.parametrize("use_fov_input", [False, True])
@pytest.mark.parametrize("adaptive", [True, False])
def test_feature_planes_match_jax(small_cfg, adaptive, use_fov_input):
    jcfg = cfg_variant(small_cfg, adaptive)
    jworld = JaxWorld(jcfg, dtype=jnp.float64)
    world = IPPWorld(port_cfg(jcfg), dtype=torch.float64, device="cpu")
    kw = dict(input_history_length=L, use_fov_input=use_fov_input, use_action_costs_input=True)
    jhp, hp = JaxHP(**kw), MCTSZeroHyperParams(**kw)
    jh, h = histories(jcfg, seed=2)
    mean = np.random.default_rng(3).uniform(0.0, 1.0, size=(B, jcfg.environment.num_cells))
    want = np.asarray(jax.vmap(lambda hh, m: jf.feature_planes(jworld, jhp, hh, mean=m))(
        jh, jnp.asarray(mean)))
    got = features.feature_planes(world, hp, h, mean=torch.from_numpy(mean))
    n = jcfg.environment.num_cells
    assert got.shape == want.shape == (B, n, n, (3 if use_fov_input else 5) * L + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # the third history slot is zero padding
    per_step = 3 if use_fov_input else 5
    assert not got[..., 2 * per_step: 3 * per_step].any()
    # NHWC view of channel-major memory: the network's NCHW permute is free
    assert got.permute(0, 3, 1, 2).is_contiguous()


def test_min_max_normalize_degenerate_rules():
    x = torch.tensor([[[0.0, 0.0], [0.0, 0.0]], [[2.0, 2.0], [2.0, 2.0]],
                      [[1.0, 3.0], [2.0, 5.0]]], dtype=torch.float64)
    got = features.min_max_normalize(x)
    for k in range(3):
        want = np.asarray(jf._min_max_normalize(jnp.asarray(x[k].numpy())))
        np.testing.assert_array_equal(got[k].numpy(), want)
