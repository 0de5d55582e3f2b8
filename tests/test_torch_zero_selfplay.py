"""The port's self-play, replay and arena (ipp_rl_tpu_torch/planners/zero/
{selfplay,replay,arena}.py) against the JAX package's, in float64 on
small_cfg with a 16-channel, 2-block network holding the same weights in
both packages.

The JAX package draws its randomness from keys; the port takes the same
draws injected, found by following the JAX key chain: split(key) → the
episode setup and one key per step; per step split(k, 4) → the search
(tests/test_torch_zero_search.py's chain), the root policy's tie-breaks
(split per env), the Gumbel noise of ``jax.random.categorical`` and the
measurement noise (split per env).

Tolerances: actions, indices, masks and the trajectories' bool fields
identical; float64 values rtol 1e-9 (atol 1e-12); the host gather builds
float32 planes in both packages, rtol 1e-6 there; the float32 PER weights
rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.planners.zero import replay as jreplay
from ipp_rl_tpu.planners.zero import train as jtrain
from ipp_rl_tpu.planners.zero.arena import Arena as JaxArena
from ipp_rl_tpu.planners.zero.mcts import ZeroMCTS as JaxMCTS
from ipp_rl_tpu.planners.zero.selfplay import SelfPlay as JaxSelfPlay
from ipp_rl_tpu.planners.zero.selfplay import Trajectory as JaxTrajectory
from ipp_rl_tpu_torch.config import MCTSZeroHyperParams
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, network_state_dict
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners.zero import replay, train
from ipp_rl_tpu_torch.planners.zero.arena import Arena, ArenaDraws
from ipp_rl_tpu_torch.planners.zero.mcts import SearchDraws, ZeroMCTS
from ipp_rl_tpu_torch.planners.zero.selfplay import SelfPlay, SelfPlayDraws, Trajectory

from test_torch_world import port_cfg
from test_torch_zero_search import gumbel, one_thread  # noqa: F401 (an autouse fixture)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)
E, HORIZON, G = 3, 2, 2
HP = dict(num_mcts_simulations=6, max_episode_steps=4, num_channels=16, num_encoder_res_blocks=2,
          num_global_pooling_channels=4, input_history_length=3, temperature_threshold=2,
          shuffle_prior_cov=True, num_augmented_samples=2, batch_size=12)


# ------------------------------------------------------------ JAX's draws

def search_draws(key, sims, A, B, alpha=1.0):
    """The tie-break noise of every descent step and the Dirichlet root
    noise of ``ZeroMCTS.search(..., key)`` over B missions."""
    select = np.zeros((sims, HORIZON + 1, B, A))
    for i in range(sims):
        k_sel, _ = jax.random.split(jax.random.fold_in(key, i))
        keys = jax.random.split(k_sel, B)
        for j in range(HORIZON + 1):
            pairs = jax.vmap(jax.random.split)(keys)
            select[i, j] = gumbel(pairs[:, 0], A)
            keys = pairs[:, 1]
    _, k0_noise = jax.random.split(jax.random.fold_in(key, 0))
    noise = np.array(jax.vmap(lambda kk: jax.random.dirichlet(
        kk, jnp.full((A,), alpha, jnp.float64), dtype=jnp.float64))(jax.random.split(k0_noise, B)))
    return SearchDraws(select=torch.from_numpy(select), root_noise=torch.from_numpy(noise))


def root_policy_draws(key, A, B):
    keys = jax.random.split(key, B)
    k2 = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    return torch.from_numpy(np.stack([gumbel(keys, A), gumbel(k2, A)]))


def measurement_noise(key, B, M):
    return torch.from_numpy(np.asarray(jax.vmap(
        lambda kb: jax.random.normal(kb, (M,), jnp.float64))(jax.random.split(key, B))))


def selfplay_draws(jworld, jsp, key, sims):
    """The setup state and per-step draws of ``SelfPlay.run(key, E)``."""
    k_setup, k_run = jax.random.split(key)
    state0 = jsp.sample_episode_setup(k_setup, E)
    A, M = jworld.num_actions, jworld.H.shape[1]
    draws = []
    for k in jax.random.split(k_run, jsp.hp.max_episode_steps):
        k_search, k_pol, k_sample, k_meas = jax.random.split(k, 4)
        draws.append(SelfPlayDraws(
            search=search_draws(k_search, sims, A, E),
            policy=root_policy_draws(k_pol, A, E),
            sample=torch.from_numpy(np.array(jax.random.gumbel(k_sample, (E, A), jnp.float64))),
            noise=measurement_noise(k_meas, E, M),
        ))
    return belief_state_from_arrays(state0, device="cpu", dtype=F64), draws


def arena_draws(jworld, key, sims, steps):
    """The draws of ``Arena.play_games(..., key)`` for both networks."""
    out = []
    for k in jax.random.split(key):
        k_init, k_run = jax.random.split(k)
        state = belief_state_from_arrays(jworld.init_state(k_init, G), device="cpu", dtype=F64)
        search, policy = [], []
        for ks in jax.random.split(k_run, steps):
            k_search, k_pol = jax.random.split(ks)
            search.append(search_draws(k_search, sims, jworld.num_actions, G))
            policy.append(root_policy_draws(k_pol, jworld.num_actions, G))
        out.append(ArenaDraws(init_state=state, search=search, policy=policy))
    return tuple(out)


# ------------------------------------------------------------- fixtures

def net_pair(jhp, hp, pcfg, key):
    """A JAX network with float64 variables and the port's holding them."""
    jnet = jtrain.PolicyValueNetwork(hp=jhp, num_actions=pcfg.num_actions)
    n = pcfg.environment.num_cells
    jvars = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jax.jit(jnet.init)(
        jax.random.key(key), jnp.zeros((1, n, n, 16)), jnp.ones((1, pcfg.num_actions))))
    net = train.init_network(pcfg, hp, torch.Generator().manual_seed(0), device="cpu", dtype=F64)
    net.load_state_dict(network_state_dict(jax.tree_util.tree_map(np.asarray, jvars)))
    return jnet, jvars, net


@pytest.fixture(scope="module")
def env(small_cfg):
    jhp, hp = JaxHP(**HP), MCTSZeroHyperParams(**HP)
    jworld = JaxWorld(small_cfg, dtype=jnp.float64)
    pcfg = port_cfg(small_cfg)
    world = IPPWorld(pcfg, dtype=F64, device="cpu")
    jnet, jvars, net = net_pair(jhp, hp, pcfg, 5)
    jpredict = jtrain.predict_fn(jnet)

    def jpredict64(variables, planes, masks):
        # predict_fn returns float32; the float64 search carries its values
        # in float64 (the port widens the same float32 values)
        return tuple(x.astype(jnp.float64) for x in jpredict(variables, planes, masks))

    jpredict64.infer_dtype = None
    return dict(jhp=jhp, hp=hp, jworld=jworld, world=world, jvars=jvars, net=net,
                jpredict=jpredict64, predict=train.predict_fn(net))


@pytest.fixture(scope="module")
def played(env):
    """One self-play batch in both packages, the port fed JAX's draws."""
    jhp, hp = env["jhp"], env["hp"]
    jmcts = JaxMCTS(env["jworld"], jhp, HORIZON, env["jpredict"])
    jsp = JaxSelfPlay(env["jworld"], jhp, HORIZON, jmcts)
    key = jax.random.key(3)
    jtraj, jvalues = jax.jit(jsp.run, static_argnames=("num_envs",))(
        key, E, net_variables=env["jvars"])
    state0, draws = selfplay_draws(env["jworld"], jsp, key, hp.num_mcts_simulations)
    sp = SelfPlay(env["world"], hp, HORIZON, ZeroMCTS(env["world"], hp, HORIZON, env["predict"]))
    traj, values = sp.run(E, net_variables=env["net"].state_dict(), init_state=state0,
                          draws=draws)
    return jax.tree_util.tree_map(np.asarray, jtraj), np.asarray(jvalues), traj, values


# ------------------------------------------------------------- self-play

def test_selfplay_run_matches_jax(played):
    jtraj, jvalues, traj, values = played
    for name in Trajectory._fields:
        got, want = getattr(traj, name).numpy(), getattr(jtraj, name)
        assert got.shape == want.shape, name
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    np.testing.assert_allclose(values.numpy(), jvalues, **TOL)
    ok = jtraj.sample_ok
    assert ok.any() and np.all(jtraj.reward[ok] > 0)
    np.testing.assert_allclose(traj.policy.numpy()[ok].sum(-1), 1.0, rtol=1e-12)


def test_value_targets_match_reference_window(played):
    _, _, traj, _ = played
    T, gamma = HP["max_episode_steps"], MCTSZeroHyperParams().gamma
    r = traj.reward.numpy()
    for e in range(E):
        for i in range(T):
            want = sum(gamma ** (j - i) * r[e, j] for j in range(i, min(i + HORIZON, T)))
            np.testing.assert_allclose(traj.value[e, i].item(), np.sqrt(want + 1) - 1, **TOL)


# ---------------------------------------------------------------- replay

@pytest.fixture(scope="module")
def buffers(env, played):
    jtraj, _, traj, _ = played
    jbuf = jreplay.ReplayBuffer(env["jworld"], env["jhp"], window_size=2)
    buf = replay.ReplayBuffer(env["world"], env["hp"], window_size=2)
    for it in range(2):
        jbuf.add_iteration(it, JaxTrajectory(*jtraj))
        buf.add_iteration(it, traj.map(lambda x: x.numpy()))
    np.testing.assert_array_equal(buf._index, jbuf._index)
    return jbuf, buf


def assert_batches_close(batch, jbatch, **tol):
    for name in jtrain.TrainBatch._fields:
        np.testing.assert_allclose(getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                   err_msg=name, **(tol or TOL))


def test_host_gather_matches_jax(buffers):
    jbuf, buf = buffers
    rows = buf._index[np.random.default_rng(3).integers(0, len(buf), size=10)]
    assert_batches_close(buf._gather(rows), jbuf._gather(rows), rtol=1e-6, atol=1e-7)


def test_device_gather_and_augment_match_jax(buffers):
    jbuf, buf = buffers
    rng = np.random.default_rng(5)
    jwin, jslots = jbuf.device_window(max_slots=3)
    win, slots = buf.device_window(max_slots=3)
    assert slots == jslots
    rows = buf.epoch_rows(2, HP["batch_size"], rng, slots)
    np.testing.assert_array_equal(rows, jbuf.epoch_rows(2, HP["batch_size"],
                                                        np.random.default_rng(5), jslots))
    assert rows.shape == (2, HP["batch_size"] // 3, 3)
    jgather = jax.jit(jbuf._gather_device)
    jaugment = jax.jit(jbuf._augment)
    for s, key in enumerate(jax.random.split(jax.random.key(6), 2)):
        jbatch = jgather(jwin, jnp.asarray(rows[s]))
        batch = buf._gather_device(win, torch.from_numpy(rows[s]))
        assert_batches_close(batch, jbatch)
        shifts = np.asarray(jax.random.randint(key, (2, rows.shape[1], 2), 0, 9))
        assert_batches_close(buf._augment(batch, shifts=torch.from_numpy(shifts)),
                             jaugment(jbatch, key))


def test_host_per_matches_jax(env, played):
    """The same numpy seed draws the same rows with the same weights, before
    and after a priority update."""
    jtraj, _, traj, _ = played
    jbuf = jreplay.PrioritizedReplayBuffer(env["jworld"], env["jhp"], window_size=1)
    buf = replay.PrioritizedReplayBuffer(env["world"], env["hp"], window_size=1)
    jbuf.add_iteration(0, JaxTrajectory(*jtraj))
    buf.add_iteration(0, traj.map(lambda x: x.numpy()))
    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    for b in (jbuf, buf):
        b.begin_training(batch_size=HP["batch_size"], num_epochs=2)
    for _ in range(2):
        jbatch, jidx = jbuf.sample(HP["batch_size"], jrng, jax.random.key(1))
        batch, idx = buf.sample(HP["batch_size"], rng, torch.Generator().manual_seed(1))
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_allclose(batch.weight.numpy(), np.asarray(jbatch.weight), rtol=1e-6)
        assert batch.planes.shape[0] == batch.weight.shape[0] == 3 * len(idx)
        new = np.linspace(0.5, 2.0, len(idx))
        for b in (jbuf, buf):
            b.step()
            b.update(idx, new)
    np.testing.assert_array_equal(buf._priorities, jbuf._priorities)
    assert buf.beta == jbuf.beta


def test_fused_per_scatter_keeps_the_last_duplicate():
    """scatter_last with repeated indices equals JAX's .at[].set on the CPU
    (serial, last wins) and numpy's fancy assignment."""
    rng = np.random.default_rng(8)
    pri = rng.random(40).astype(np.float32)
    idx = rng.integers(0, 12, size=30)  # many repeats
    vals = rng.random(30).astype(np.float32)
    want = np.asarray(jnp.asarray(pri).at[jnp.asarray(idx)].set(jnp.asarray(vals)))
    got = replay.scatter_last(torch.from_numpy(pri), torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    host = pri.copy()
    host[idx] = vals
    np.testing.assert_array_equal(got.numpy(), host)


def test_per_sample_rows_matches_jax_and_host_distribution():
    """With JAX's Gumbel noise injected per_sample_rows picks JAX's rows; its
    own draws follow the host rng.choice(p^α/Σp^α) distribution over the
    valid slots, with the host's importance weights."""
    rng = np.random.default_rng(7)
    K, E_, T = 2, 3, 5
    alpha, beta = 0.6, 0.5
    valid = rng.random((K, E_, T)) < 0.7
    valid.flat[0] = True
    pri = np.where(valid, rng.random((K, E_, T)) + 0.05, 0.0).astype(np.float32)
    n_valid = valid.sum()
    args = (torch.from_numpy(pri), torch.from_numpy(valid.reshape(-1)), alpha, np.float32(beta),
            torch.tensor(float(n_valid), dtype=torch.float32))

    key = jax.random.key(3)
    want = jreplay.per_sample_rows(jnp.asarray(pri), jnp.asarray(valid.reshape(-1)), alpha,
                                   jnp.float32(beta), jnp.float32(n_valid), key, 50)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (50, K * E_ * T), jnp.float32)))
    got = replay.per_sample_rows(*args, 50, noise=noise)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)

    host_probs = np.where(valid, pri ** alpha, 0.0).reshape(-1)
    host_probs = host_probs / host_probs.sum()
    draw = 20000
    flat_idx, rows, w = replay.per_sample_rows(*args, draw, torch.Generator().manual_seed(3))
    flat_idx, w = flat_idx.numpy(), w.numpy()
    assert valid.reshape(-1)[flat_idx].all()
    freq = np.bincount(flat_idx, minlength=K * E_ * T) / draw
    assert np.abs(freq - host_probs).max() < 0.01
    host_w = (host_probs[flat_idx] * n_valid) ** (-beta)
    np.testing.assert_allclose(w, host_w / host_w.max(), rtol=1e-4)
    dec = rows[:, 0] * E_ * T + rows[:, 1] * T + rows[:, 2]
    np.testing.assert_array_equal(dec.numpy(), flat_idx)


# ----------------------------------------------------------------- arena

def test_arena_totals_match_jax(env, small_cfg):
    jhp, hp, steps = env["jhp"], env["hp"], 3
    _, jvars2, net2 = net_pair(jhp, hp, port_cfg(small_cfg), 9)
    key = jax.random.key(11)
    jarena = JaxArena(env["jworld"], jhp, HORIZON, max_game_steps=steps)
    want = jax.jit(jarena.play_games, static_argnums=(0, 3))(
        env["jpredict"], env["jvars"], jvars2, G, key)
    arena = Arena(env["world"], hp, HORIZON, max_game_steps=steps)
    got = arena.play_games(env["predict"], env["net"].state_dict(), net2.state_dict(), G,
                           draws=arena_draws(env["jworld"], key, hp.num_mcts_simulations, steps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), **TOL)
        assert g.item() > 0
