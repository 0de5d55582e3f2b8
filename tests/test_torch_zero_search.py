"""The port's batched PUCT search and deploy planner
(ipp_rl_tpu_torch/planners/zero/{mcts,mission}.py) against the JAX
package's, in float64 on small_cfg with tests/test_zero.py's
hyper-parameters (12 simulations), driven by the uniform predict of
tests/test_zero.py (exactly tied priors) and by a narrow 10-block network.

Both packages draw every tie-break and the Dirichlet root noise from
random keys; the port takes them injected.  The draws here are the JAX
package's own, reproduced by following its key chain: fold_in(key, i) →
split → split(k_sel, B) → split(c.key) per descent step, each draw the
Gumbel noise of ``jax.random.categorical`` (mcts.py:129-133, 620-629,
657-658, 291; mission.py:89, 98, 110, 129, 142, 171; world.py:305).

Tolerances: visit counts, children, valid masks, node counts and actions
identical; Q values, priors and node visit totals within 1e-9 (the
network's priors within 1e-6: both packages take a float32 exp, whose two
implementations differ by an ulp); metric curves rtol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.planners.zero import train as jtrain
from ipp_rl_tpu.planners.zero.features import init_history as j_init_history
from ipp_rl_tpu.planners.zero.mcts import ZeroMCTS as JaxMCTS
from ipp_rl_tpu_torch.config import MCTSZeroHyperParams
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, network_state_dict
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners.zero import features, train
from ipp_rl_tpu_torch.planners.zero.mcts import SearchDraws, ZeroMCTS

from test_torch_world import port_cfg

B, HORIZON = 3, 3
HC = HORIZON + 1
HP = dict(num_mcts_simulations=12, num_channels=16, num_encoder_res_blocks=2,
          num_global_pooling_channels=4, input_history_length=3, max_valid_action_distance=11.5)
NARROW = dict(HP, num_channels=8, num_encoder_res_blocks=10)
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ JAX's draws

def gumbel(keys, A):
    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (A,), jnp.float64))(keys))


def jax_search_draws(key, sims, A, alpha=1.0, root_noise=True):
    """The tie-break noise of every descent step and the root noise that
    ``ZeroMCTS.search(..., key)`` draws."""
    select = np.zeros((sims, HC, B, A))
    for i in range(sims):
        k_sel, _ = jax.random.split(jax.random.fold_in(key, i))
        keys = jax.random.split(k_sel, B)
        for j in range(HC):
            pairs = jax.vmap(jax.random.split)(keys)
            select[i, j] = gumbel(pairs[:, 0], A)
            keys = pairs[:, 1]
    noise = None
    if root_noise:
        _, k0_noise = jax.random.split(jax.random.fold_in(key, 0))
        noise = torch.from_numpy(np.array(jax.vmap(lambda kk: jax.random.dirichlet(
            kk, jnp.full((A,), alpha, jnp.float64), dtype=jnp.float64))(
                jax.random.split(k0_noise, B))))
    return SearchDraws(select=torch.from_numpy(select), root_noise=noise)


# ----------------------------------------------------------- predict fns

def uniform_predict_jax(variables, planes, masks):
    p = masks / jnp.maximum(jnp.sum(masks, axis=-1, keepdims=True), 1e-30)
    return p, 0.5 * jnp.ones((planes.shape[0],), planes.dtype)


def uniform_predict(variables, planes, masks):
    p = masks / torch.clamp(torch.sum(masks, dim=-1, keepdim=True), min=1e-30)
    return p, 0.5 * torch.ones((planes.shape[0],), dtype=planes.dtype)


def narrow_nets(cfg, pcfg):
    """The JAX net with float64 variables (flax computes BatchNorm in the
    variables' dtype) and the port's net holding the same values."""
    jhp = JaxHP(**NARROW)
    jnet, st = jtrain.init_train_state(cfg, jhp, jax.random.key(5))
    jvars = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), st.variables())
    net = train.init_network(pcfg, MCTSZeroHyperParams(**NARROW), torch.Generator().manual_seed(0),
                             device="cpu", dtype=F64)
    net.load_state_dict(network_state_dict(jax.tree_util.tree_map(np.asarray, jvars)))
    jpredict = jtrain.predict_fn(jnet)

    def jpredict64(variables, planes, masks):
        # predict_fn returns float32; the JAX search's backup loop carries
        # the leaf value in the tree's dtype, so a float64 search needs it
        # widened (the port widens the same float32 values as it adds them)
        return tuple(x.astype(jnp.float64) for x in jpredict(variables, planes, masks))

    jpredict64.infer_dtype = None
    return (jpredict64, jvars), (train.predict_fn(net), net.state_dict())


@pytest.fixture(scope="module")
def env(small_cfg):
    jworld = JaxWorld(small_cfg, dtype=jnp.float64)
    pcfg = port_cfg(small_cfg)
    world = IPPWorld(pcfg, dtype=F64, device="cpu")
    state = jworld.init_state(jax.random.key(0), B)
    state = state.replace(budget=jnp.asarray([60.0, 30.0, 9.0]))  # the last runs dry
    return jworld, world, state, narrow_nets(small_cfg, pcfg)


def port_history(world, hp):
    return features.init_history(world.cfg, hp, B, F64, device="cpu")


def run_searches(env, use_net, clean, key=7):
    jworld, world, state, nets = env
    kw = NARROW if use_net else HP
    jhp, hp = JaxHP(**kw), MCTSZeroHyperParams(**kw)
    (jpred, jvars), (pred, pvars) = nets if use_net else ((uniform_predict_jax, None),
                                                          (uniform_predict, None))
    jmcts = JaxMCTS(jworld, jhp, HORIZON, jpred)
    jhist = jax.vmap(lambda _: j_init_history(jworld.cfg, jhp, jnp.float64))(jnp.arange(B))
    jkey = jax.random.key(key)
    jtree, jmask = jmcts.search(state.cov, state.mean, state.pos, state.budget, jhist, jkey,
                                net_variables=jvars, forced_playouts=not clean,
                                root_noise=not clean)
    mcts = ZeroMCTS(world, hp, HORIZON, pred)
    pstate = belief_state_from_arrays(state, device="cpu", dtype=F64)
    draws = jax_search_draws(jkey, hp.num_mcts_simulations, world.num_actions,
                             root_noise=not clean)
    tree, mask = mcts.search(pstate.cov, pstate.mean, pstate.pos, pstate.budget,
                             port_history(world, hp), net_variables=pvars,
                             forced_playouts=not clean, root_noise=not clean, draws=draws)
    return (jmcts, jtree, jmask), (mcts, tree, mask)


@pytest.mark.parametrize("use_net", [False, True], ids=["uniform", "narrow_net"])
def test_clean_search_matches_jax(env, use_net):
    (_, jtree, jmask), (_, tree, mask) = run_searches(env, use_net, clean=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    for name in ("Nsa", "children", "valid", "next_free", "parent", "action_in", "expanded",
                 "depth"):
        np.testing.assert_array_equal(getattr(tree, name).numpy(),
                                      np.asarray(getattr(jtree, name)), err_msg=name)
    for name in ("Qsa", "prior", "Ns", "reward_in", "budget"):
        # the network's probabilities are float32 exp() of its log-policy in
        # both packages, and XLA's and torch's float32 exp differ by an ulp
        rtol = 1e-6 if use_net and name == "prior" else 1e-9
        np.testing.assert_allclose(getattr(tree, name).numpy(), np.asarray(getattr(jtree, name)),
                                   rtol=rtol, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(tree.wc_in.numpy(), np.asarray(jtree.wc_in), rtol=1e-9,
                               atol=1e-12)
    assert tree.Ns[:, 0].tolist() == [HP["num_mcts_simulations"] - 1] * B
    # the tree went deeper than the root's children, and allocated nodes
    assert tree.depth.max().item() >= 2 and (tree.next_free > 2).all()


@pytest.mark.parametrize("use_net", [False, True], ids=["uniform", "narrow_net"])
def test_reference_search_root_visits_match_jax(env, use_net):
    """Dirichlet root noise and forced playouts on: forced playouts put inf
    on several root actions at once, so the tie-break decides."""
    (_, jtree, _), (_, tree, _) = run_searches(env, use_net, clean=False, key=11)
    np.testing.assert_array_equal(tree.Nsa[:, 0].numpy(), np.asarray(jtree.Nsa[:, 0]))
    np.testing.assert_allclose(tree.prior[:, 0].numpy(), np.asarray(jtree.prior[:, 0]),
                               rtol=1e-6 if use_net else 1e-9, atol=1e-15)


@pytest.fixture(scope="module")
def searched(env):
    return run_searches(env, use_net=False, clean=False, key=13)


def root_policy_draws(key, A):
    keys = jax.random.split(key, B)
    k2 = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    return torch.from_numpy(np.stack([gumbel(keys, A), gumbel(k2, A)]))


@pytest.mark.parametrize("temperature", [1.0, 0.0])
@pytest.mark.parametrize("deploy_time", [True, False])
def test_root_policy_matches_jax(searched, deploy_time, temperature):
    (jmcts, jtree, _), (mcts, tree, _) = searched
    key = jax.random.key(17)
    want = np.asarray(jmcts.root_policy(jtree, key, jnp.asarray(temperature),
                                        deploy_time=deploy_time))
    got = mcts.root_policy(tree, temperature, deploy_time=deploy_time,
                           draws=root_policy_draws(key, mcts.A)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-12)


def test_prune_forced_visits_matches_jax(searched):
    (jmcts, jtree, _), (mcts, tree, _) = searched
    key = jax.random.key(19)
    keys = jax.random.split(key, B)
    p_init = jnp.asarray(jmcts.hp.puct_init, jnp.float64)
    want = np.asarray(jax.vmap(lambda tr, k: jmcts.prune_forced_visits(tr, tr.Nsa[0], k, p_init))(
        jtree, keys))
    got = mcts.prune_forced_visits(tree, tree.Nsa[:, 0], torch.from_numpy(gumbel(keys, mcts.A)),
                                   mcts.hp.puct_init).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < tree.Nsa[:, 0].numpy()).any()  # forced playouts were pruned


def test_bf16_inference_and_edges_agree_with_f32(env, small_cfg):
    """bf16 inference and bf16 edge factors, float32 world: the predict
    outputs come back float32 near the float32 ones, and searches through
    them return valid root policies (tests/test_zero_extras.py holds the
    JAX package to the same)."""
    world = IPPWorld(port_cfg(small_cfg), dtype=torch.float32, device="cpu")
    hp = MCTSZeroHyperParams(**NARROW)
    net = train.init_network(world.cfg, hp, torch.Generator().manual_seed(3), device="cpu")
    state = world.init_state(B, torch.Generator().manual_seed(4))
    hist = features.push_history(features.init_history(world.cfg, hp, B, device="cpu"),
                                 state.cov, state.pos, state.budget / 60.0)
    planes = features.feature_planes(world, hp, hist, state.mean)
    mask = torch.ones((B, world.num_actions))
    p32, v32 = train.predict_fn(net)(net.state_dict(), planes, mask)
    p16, v16 = train.predict_fn(net, dtype=torch.bfloat16)(net.state_dict(), planes, mask)
    assert p16.dtype == p32.dtype == torch.float32
    np.testing.assert_allclose(p16.numpy(), p32.numpy(), atol=0.03)
    np.testing.assert_allclose(v16.numpy(), v32.numpy(), rtol=0.08, atol=0.05)

    empty = features.init_history(world.cfg, hp, B, device="cpu")
    for pred, edge_dtype in ((train.predict_fn(net, dtype=torch.bfloat16), None),
                             (train.predict_fn(net), torch.bfloat16)):
        mcts = ZeroMCTS(world, hp, 2, pred, edge_dtype=edge_dtype)
        tree, root_mask = mcts.search(state.cov, state.mean, state.pos, state.budget, empty,
                                      net_variables=net.state_dict(),
                                      generator=torch.Generator().manual_seed(5))
        assert tree.Ns[:, 0].tolist() == [hp.num_mcts_simulations - 1] * B
        assert tree.wc_in.dtype == (edge_dtype or torch.float32)
        pol = mcts.root_policy(tree, 1.0, generator=torch.Generator().manual_seed(6)).numpy()
        assert np.all(np.isfinite(pol)) and np.all(pol >= 0)
        np.testing.assert_allclose(pol.sum(axis=-1), 1.0, atol=1e-5)
        assert np.all(pol[~root_mask.numpy()] < 1e-6)


def test_eval_chunk_pads_and_matches_unchunked(env):
    """A batch that is no multiple of the chunk is padded with leading rows
    and gives the unchunked search's tree."""
    _, world, state, (_, (pred, pvars)) = env
    hp = MCTSZeroHyperParams(**NARROW)
    pstate = belief_state_from_arrays(state, device="cpu", dtype=F64)
    out = []
    for chunk in (0, 2):
        mcts = ZeroMCTS(world, hp, HORIZON, pred, eval_chunk=chunk)
        tree, _ = mcts.search(pstate.cov, pstate.mean, pstate.pos, pstate.budget,
                              port_history(world, hp), net_variables=pvars,
                              generator=torch.Generator().manual_seed(8))
        out.append(tree)
    np.testing.assert_array_equal(out[0].Nsa.numpy(), out[1].Nsa.numpy())
    np.testing.assert_allclose(out[0].prior.numpy(), out[1].prior.numpy(), rtol=1e-6)
