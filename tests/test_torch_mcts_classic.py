"""The port's classic MCTS (ipp_rl_tpu_torch/planners/mcts_classic.py)
against the JAX package's, in float64 on small_cfg.

The JAX planner draws every choice from its key chain; the port takes the
same draws injected (``ClassicDraws``), reproduced here by following that
chain: split(key, B) → split(·, W) → split(·, S) → per descent step
split(·, 4) = (pw, exp, sel, next), exp → split(·, 3) = (mode, rand,
soft); after the descent split(carry.key)[0] → split(·, H), each rollout
key split(·, 3) the same way (ipp_rl_tpu/planners/mcts_classic.py:122,
142, 232, 240, 300, 312, 378, 397, 433).  A categorical is the argmax of
its Gumbel draws plus the logits.

The JAX planner keeps its trees inside ``plan``; ``jax_search`` runs
plan's worker (mcts_classic.py:372-392) with the tree kept, and
``plan_from_trees`` takes the action from those trees as plan does
(:394-435; a JAX compile of the search costs ~25 s here, so ``plan``
itself runs in ``test_run_matches_jax`` and, for W = 2, in
tests/test_torch_mcts_classic_workers.py).  The searches start from a state after
two commits: at the GP prior the grid's mirror symmetry makes mirrored
actions' rewards tie exactly, and the greedy argmax would then follow the
last bit of two different sweep algorithms (JAX's structured sweep, the
port's batched one).

Tolerances: integer tree fields and actions identical; visits, value sums,
budgets and edge factors rtol 1e-10; sweep rewards and edge gains rtol
1e-10; metric curves rtol 1e-9."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MissionConfig as JaxMissionConfig
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.planners import mcts_classic as jmc
from ipp_rl_tpu_torch.config import MissionConfig
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, draws_from_arrays
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners import mcts_classic as mc

from test_torch_static_paths import step_noise
from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

B = 3
F64 = torch.float64
# the reference's knobs (scripts/quality_parity.py:74-78) at a small size
KNOBS = dict(type="mcts", gamma=0.95, uct_c=2.0, episode_horizon=3, k=2.0, alpha=0.5,
             epsilon_expand=0.2, epsilon_rollout=0.5, horizontal_spacing=10.0)
CONFIGS = {  # name: mission config fields beyond KNOBS
    "w1": dict(num_simulations=8),
    "w1_gcb": dict(num_simulations=8, use_gcb_rollout=True),
}
TREE_INTS = ("parent", "action_in", "children", "num_children", "next_free")
TREE_FLOATS = ("visits", "value_sum", "budget", "wc_in")


def gumbel(keys, n):
    return jax.vmap(lambda k: jax.random.gumbel(k, (n,), jnp.float64))(keys)


def jax_classic_draws(jp, key, batch):
    """``ClassicDraws`` (rows mission-major) of ``jp.plan(state, key)``."""
    W, S, H = jp.num_workers, jp.num_simulations, jp.horizon
    A, Cmax = jp.world.num_actions, jp.max_children

    def policy(k):  # one _policy_action's draws: (rand, mode, soft)
        k_mode, k_rand, k_soft = jax.random.split(k, 3)
        return (jax.random.gumbel(k_rand, (A,), jnp.float64),
                jax.random.uniform(k_mode, dtype=jnp.float64),
                jax.random.gumbel(k_soft, (A,), jnp.float64))

    def simulation(kk):
        def step(k, _):
            _, k_exp, k_sel, k_next = jax.random.split(k, 4)
            g_exp, u_exp, _ = policy(k_exp)
            return k_next, (jax.random.gumbel(k_sel, (Cmax,), jnp.float64), g_exp, u_exp)

        k_end, (sel, exp, exp_u) = jax.lax.scan(step, kk, None, length=H + 1)
        roll, roll_u, roll_gcb = jax.vmap(policy)(jax.random.split(jax.random.split(k_end)[0], H))
        return sel, exp, exp_u, roll, roll_u, roll_gcb

    def worker(kw):
        return jax.vmap(simulation)(jax.random.split(kw, S))

    def mission(k):
        return jax.vmap(worker)(jax.random.split(k, W))

    if not hasattr(jp, "_test_draws"):  # one compile per planner
        jp._test_draws = jax.jit(lambda k: jax.vmap(mission)(jax.random.split(k, batch)))
    out = jp._test_draws(key)  # each (B, W, S, step, …)

    def rows(x):  # (B, W, S, step, …) → (S, step, B·W, …)
        x = np.asarray(x)
        x = np.moveaxis(x.reshape((batch * W,) + x.shape[2:]), 0, 2)
        return torch.from_numpy(np.ascontiguousarray(x))

    sel, exp, exp_u, roll, roll_u, roll_gcb = (rows(x) for x in out)
    return mc.ClassicDraws(select=sel, expand=exp, expand_u=exp_u, rollout=roll,
                           rollout_u=roll_u, rollout_gcb=roll_gcb)


def jax_search(jp, state, key):
    """The trees of ``jp.plan(state, key)``: plan's worker (mcts_classic.py:
    372-392) with its tree returned, vmapped over missions and workers as
    plan vmaps it; leading axes (B, W)."""
    dt = state.cov.dtype
    n, m = jp.cfg.environment.num_cells, jp.world.H.shape[1]
    C, Cmax = jp.num_simulations + 2, jp.max_children

    def worker(P, pos, budget, mean, kw):
        tree = jmc.CTree(
            parent=jnp.full((C,), jmc.NO_NODE),
            action_in=jnp.full((C,), jmc.NO_NODE),
            wc_in=jnp.zeros((C, m, n), dt),
            budget=jnp.zeros((C,), dt).at[0].set(budget),
            visits=jnp.zeros((C,), dt),
            value_sum=jnp.zeros((C,), dt),
            num_children=jnp.zeros((C,), jnp.int32),
            children=jnp.full((C, Cmax), jmc.NO_NODE),
            next_free=jnp.int32(1),
        )

        def sim(tree, kk):
            return jp._simulate_one(tree, P, pos, mean, kk), None

        tree, _ = jax.lax.scan(sim, tree, jax.random.split(kw, jp.num_simulations))
        return tree

    def one(P, pos, budget, mean, k):
        return jax.vmap(lambda kw: worker(P, pos, budget, mean, kw))(
            jax.random.split(k, jp.num_workers))

    return jax.jit(jax.vmap(one))(state.cov, state.pos, state.budget, state.mean,
                                  jax.random.split(key, state.mean.shape[0]))


def plan_from_trees(jp, jtrees):
    """plan's action from the JAX trees (leading axis B·W), in numpy with
    its operations: the best child by its own mean for W = 1, else the
    per-action sums (a sequential scatter-add, as XLA's on the CPU) merged
    over the workers (mcts_classic.py:394-435)."""
    W, A, Cmax = jp.num_workers, jp.world.num_actions, jp.max_children
    R = jtrees.visits.shape[0]
    cidx = np.maximum(jtrees.children[:, 0], 0)
    exists = np.arange(Cmax) < jtrees.num_children[:, :1]
    acts = np.maximum(np.take_along_axis(jtrees.action_in, cidx, 1), 0)
    vis = np.where(exists, np.take_along_axis(jtrees.visits, cidx, 1), 0.0)
    val = np.where(exists, np.take_along_axis(jtrees.value_sum, cidx, 1), 0.0)
    if W == 1:
        child_val = np.where(exists, val / np.maximum(vis, 1e-30), -np.inf)
        return acts[np.arange(R), np.argmax(child_val, axis=1)]
    vis_a, val_a = np.zeros((R, A)), np.zeros((R, A))
    rows = np.repeat(np.arange(R)[:, None], Cmax, 1)
    np.add.at(vis_a, (rows, acts), vis)
    np.add.at(val_a, (rows, acts), val)
    vis_m = vis_a.reshape(-1, W, A).sum(axis=1)
    val_m = val_a.reshape(-1, W, A).sum(axis=1)
    return np.argmax(np.where(vis_m > 0, val_m / np.maximum(vis_m, 1e-30), -np.inf), axis=1)


def search_state(jworld, budgets):
    """B missions after two commits at fixed actions, then the budgets."""
    state = jworld.init_state(jax.random.key(0), B)
    for t, acts in enumerate(([7, 20, 41], [13, 2, 50])):
        state = jworld.step_index(state, jnp.asarray(acts), jax.random.key(100 + t))
    return state.replace(budget=jnp.asarray(budgets, jnp.float64))


def planners(jcfg, fields):
    jworld = JaxWorld(jcfg, dtype=jnp.float64)
    fields = {**KNOBS, **fields}
    jp = jmc.ClassicMCTSPlanner(jworld, JaxMissionConfig(**fields))
    world = IPPWorld(port_cfg(jcfg), dtype=F64, device="cpu")
    return jp, mc.ClassicMCTSPlanner(world, MissionConfig(**fields))


def search_both(jcfg, fields, budgets=(60.0, 30.0, 12.0), seed=7, real_plan=False):
    """(JAX trees with leading (B·W,), JAX actions, port trees, port actions,
    port root stats, the port's planner) of one replan; the JAX actions
    from ``jp.plan`` itself with ``real_plan``, else from its trees."""
    jp, pp = planners(jcfg, fields)
    state = search_state(jp.world, budgets)
    key = jax.random.key(seed)
    jtrees = jax.tree_util.tree_map(
        lambda x: np.asarray(x).reshape((-1,) + x.shape[2:]), jax_search(jp, state, key))
    if real_plan:
        jactions = np.asarray(jax.jit(lambda s, k: jp.plan(s, k, jnp.int32(0)))(state, key))
    else:
        jactions = plan_from_trees(jp, jtrees)
    draws = jax_classic_draws(jp, key, B)
    pstate = belief_state_from_arrays(state, device="cpu", dtype=F64)
    tree, root = pp.search(pstate, draws=draws)
    actions = pp.plan(pstate, None, 0, draws)
    return jtrees, jactions, tree, actions, root, pp


def assert_same_trees(tree, jtrees):
    for name in TREE_INTS:
        np.testing.assert_array_equal(getattr(tree, name).numpy(), getattr(jtrees, name),
                                      err_msg=name)
    for name in TREE_FLOATS:
        np.testing.assert_allclose(getattr(tree, name).numpy(), getattr(jtrees, name),
                                   rtol=1e-10, atol=1e-13, err_msg=name)


@pytest.fixture(scope="module", params=list(CONFIGS))
def searched(request, small_cfg):
    return request.param, search_both(small_cfg, CONFIGS[request.param])


def test_trees_and_actions_match_jax(searched):
    name, (jtrees, jactions, tree, actions, root, pp) = searched
    assert_same_trees(tree, jtrees)
    np.testing.assert_array_equal(actions.numpy(), jactions)
    S = pp.num_simulations
    # every simulation's first edge leaves the root of a mission with budget
    assert tree.visits[:, 0].tolist() == [float(S)] * B
    # the search went below the root's children, and widened the root
    assert (tree.parent.max(dim=1).values >= 1).all() and (tree.num_children[:, 0] > 1).all()
    # W = 1: the action is the best child's by its own mean
    assert torch.equal(actions, root.best_child_action)


def test_root_stats_sum_the_children(searched):
    """Per action, the root statistics are the sums over the root's
    children (duplicate actions merged), as the JAX merge's scatter-add."""
    _, (_, _, tree, _, root, pp) = searched
    for r in range(tree.parent.shape[0]):
        want_v, want_s = np.zeros(pp.world.num_actions), np.zeros(pp.world.num_actions)
        for slot in range(int(tree.num_children[r, 0])):
            c = int(tree.children[r, 0, slot])
            want_v[int(tree.action_in[r, c])] += tree.visits[r, c].item()
            want_s[int(tree.action_in[r, c])] += tree.value_sum[r, c].item()
        np.testing.assert_array_equal(root.visits[r].numpy(), want_v)
        np.testing.assert_allclose(root.values[r].numpy(), want_s, rtol=1e-14)


def test_sweep_rewards_and_edges_match_jax(small_cfg):
    """One sweep and one edge per row against the JAX planner's
    ``_sweep_rewards`` (kf_sweep_gains_structured) and ``_edge``
    (kf_gain_factor_t), with the root-mean mask against each P."""
    jp, pp = planners(small_cfg, CONFIGS["w1"])
    state = search_state(jp.world, (60.0, 30.0, 12.0))
    want_r, want_c = jax.vmap(jp._sweep_rewards)(state.cov, state.pos, state.mean)
    a = jnp.asarray([5, 33, 70])
    want_wct, want_gain = jax.vmap(jp._edge)(state.cov, a, state.mean)
    ps = belief_state_from_arrays(state, device="cpu", dtype=F64)
    costs = pp._costs(ps.pos)
    dmask = pp._diag_mask(ps.mean, ps.cov)
    np.testing.assert_allclose(costs.numpy(), np.asarray(want_c), rtol=1e-13)
    np.testing.assert_allclose(pp._sweep_rewards(ps.cov, costs, dmask).numpy(),
                               np.asarray(want_r), rtol=1e-10, atol=1e-14)
    wct, gain = pp._edge(ps.cov, torch.as_tensor(np.array(a)), dmask)
    np.testing.assert_allclose(gain.numpy(), np.asarray(want_gain), rtol=1e-10)
    np.testing.assert_allclose(wct.numpy(), np.asarray(want_wct), rtol=1e-10, atol=1e-13)
    # the mask is not all ones, so the masked gains are exercised
    assert 0 < float(dmask.sum()) < dmask.numel()


def uct_trees(C=6, Cmax=4):
    """Handmade trees, one per row, each a case of the UCT rule: the quirk's
    general branch, max == 0, max == min, unvisited children (+inf, tied),
    an unaffordable child (−inf), and every child unaffordable (all −inf:
    any slot, an empty one included)."""
    rows = [  # (children's visits, children's value sums, children's actions, budget)
        ([2, 3, 1], [1.0, 3.0, -0.5], [1, 8, 15], 40.0),
        ([2, 1, 4], [0.0, 0.0, 0.0], [1, 8, 15], 40.0),
        ([1, 2], [2.0, 4.0], [3, 9], 40.0),
        ([0, 3, 0], [0.0, 1.5, 0.0], [2, 8, 20], 40.0),
        ([2, 2, 2], [1.0, 1.0, 2.0], [1, 8, 71], 20.0),
        ([1, 2], [0.5, 0.5], [40, 71], 5.0),
    ]
    R = len(rows)
    parent = np.full((R, C), -1)
    action_in = np.full((R, C), -1)
    visits, value_sum = np.zeros((R, C)), np.zeros((R, C))
    children = np.full((R, C, Cmax), -1)
    num_children = np.zeros((R, C), np.int64)
    budget = np.zeros(R)
    for r, (v, s, acts, bud) in enumerate(rows):
        k = len(v)
        children[r, 0, :k] = np.arange(1, k + 1)
        num_children[r, 0] = k
        parent[r, 1:k + 1] = 0
        action_in[r, 1:k + 1] = acts
        visits[r, 1:k + 1], value_sum[r, 1:k + 1] = v, s
        visits[r, 0] = sum(v) + 1
        budget[r] = bud
    return dict(parent=parent, action_in=action_in, visits=visits, value_sum=value_sum,
                children=children, num_children=num_children), budget


def test_uct_select_matches_jax(small_cfg):
    jp, pp = planners(small_cfg, CONFIGS["w1"])
    arrays, budget = uct_trees(Cmax=pp.max_children)
    R, C = arrays["visits"].shape
    pos = np.tile([[2.0, 2.0, 14.0]], (R, 1))
    jtree = jmc.CTree(wc_in=jnp.zeros((R, C, 1, 1)), budget=jnp.zeros((R, C)),
                      next_free=jnp.zeros((R,), jnp.int32),
                      **{k: jnp.asarray(v) for k, v in arrays.items()})
    ptree = mc.CTree(wc_in=torch.zeros((R, C, 1, 1), dtype=F64),
                     budget=torch.zeros((R, C), dtype=F64),
                     next_free=torch.zeros((R,), dtype=torch.long),
                     **{k: torch.as_tensor(v) for k, v in arrays.items()})
    node = torch.zeros((R,), dtype=torch.long)
    select = jax.jit(jax.vmap(lambda t, p, b, k: jp._uct_select(t, 0, p, b, k)))
    empty_slots = 0
    for seed in range(6):
        keys = jax.random.split(jax.random.key(seed), R)
        want = np.asarray(select(jtree, jnp.asarray(pos), jnp.asarray(budget), keys))
        noise = torch.from_numpy(np.array(gumbel(keys, pp.max_children)))
        got = pp._uct_select(ptree, node, pp._costs(torch.as_tensor(pos)),
                             torch.as_tensor(budget), noise)
        np.testing.assert_array_equal(got.numpy(), want)
        empty_slots += int(want[-1] >= arrays["num_children"][-1, 0])
    assert empty_slots > 0  # the all −inf row did pick an empty slot


def test_run_matches_jax(small_cfg):
    """Three replan steps through ``Planner.run`` with JAX's draws and
    measurement noise injected, from the searches' state."""
    jp, pp = planners(small_cfg, CONFIGS["w1"])
    state = search_state(jp.world, (60.0, 30.0, 12.0))
    T, key = 3, jax.random.key(11)
    want = jp.run(key, B, max_steps=T, init_state=state)
    _, k_run = jax.random.split(key)
    k_plan, k_meas = jax.vmap(jax.random.split, out_axes=1)(jax.random.split(k_run, T))
    draws = [jax_classic_draws(jp, k, B) for k in k_plan]
    noise = step_noise(jp.world, k_meas, jp.world.H.shape[1])
    got = pp.run(B, max_steps=T, init_state=belief_state_from_arrays(state, device="cpu", dtype=F64),
                 noise=draws_from_arrays(noise, (T, B, None), "cpu", F64), draws=draws)
    np.testing.assert_array_equal(got.waypoints, np.asarray(want.waypoints))
    np.testing.assert_array_equal(got.num_steps, np.asarray(want.num_steps))
    np.testing.assert_allclose(got.budgets, np.asarray(want.budgets), rtol=1e-12)
    for k in want.metrics:
        np.testing.assert_allclose(got.metrics[k], want.metrics[k], rtol=1e-9, atol=1e-12)
    assert np.all(got.metrics["uncertainty"][:, -1] < got.metrics["uncertainty"][:, 0])


def test_generator_search_is_reproducible(small_cfg):
    """Without injected draws the search draws from its generator, step by
    step: repeatable from a seed, and every root gets its S visits."""
    _, pp = planners(small_cfg, dict(num_simulations=6, num_mcts_workers=2))
    world = pp.world
    state = world.init_state(2, torch.Generator().manual_seed(0))
    t1, r1 = pp.search(state, torch.Generator().manual_seed(5))
    t2, r2 = pp.search(state, torch.Generator().manual_seed(5))
    for name in TREE_INTS + TREE_FLOATS:
        assert torch.equal(getattr(t1, name), getattr(t2, name)), name
    assert t1.visits[:, 0].tolist() == [3.0] * 4
    assert torch.equal(r1.visits, r2.visits)
    a = pp.plan(state, torch.Generator().manual_seed(5), 0)
    assert a.shape == (2,) and bool((r1.visits.view(2, 2, -1).sum(1).gather(1, a[:, None]) > 0).all())
