"""The port's learner (ipp_rl_tpu_torch/planners/zero/learn.py) and its
checkpoints.

* The slice as a whole: one ``train_iteration`` on the fused uniform path,
  from the same JAX-made trajectory, the same initial weights and the same
  numpy seed for the replay rows, gives the JAX package's ``ZeroLearner``
  parameters, batch statistics and metrics in float64 (dropout 0, no
  augmentation): rtol 1e-9.
* ``learn`` smoke runs on the CPU with the assertions of
  tests/test_zero_selfplay.py and tests/test_zero_extras.py: uniform, fused
  and host PER, split networks, arena gating (accepted and rolled back), a
  resume from the JAX package's npz files and checkpoint, best-snapshot
  selection, the deploy-gate rollback.
* Checkpoints the port writes load in flax and in the JAX package's
  ``load_checkpoint`` bit for bit; the JAX package's load in the port."""

import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.config.schema import MissionConfig as JaxMC
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.planners.zero import learn as jlearn
from ipp_rl_tpu.planners.zero import train as jtrain
from ipp_rl_tpu.planners.zero.mcts import ZeroMCTS as JaxMCTS
from ipp_rl_tpu.planners.zero.selfplay import Trajectory as JaxTrajectory
from ipp_rl_tpu_torch.config import MCTSZeroHyperParams, MissionConfig
from ipp_rl_tpu_torch.convert import flax_variables, network_state_dict
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners.zero import learn
from ipp_rl_tpu_torch.planners.zero.selfplay import Trajectory

from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)
TINY = dict(num_mcts_simulations=6, max_episode_steps=5, num_channels=16,
            num_encoder_res_blocks=2, num_global_pooling_channels=4, input_history_length=3,
            batch_size=8, num_epochs=1, temperature_threshold=3, shuffle_prior_cov=True)
TINY_HP = MCTSZeroHyperParams(**TINY)


def mission(**changes):
    hp = MCTSZeroHyperParams(**{**TINY, **changes.pop("hp", {})})
    return MissionConfig(type="mcts_zero", episode_horizon=2, hyper_params=hp, **changes)


def learner(world, tmp_path, mc=None, **kw):
    dirs = dict(checkpoints_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                train_data_dir=str(tmp_path / "data"))
    return learn.ZeroLearner(world, mc or mission(), num_envs=2, **{**dirs, **kw})


def metric_rows(tmp_path):
    with open(tmp_path / "logs" / "train_metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def same_weights(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def world(small_cfg):
    return IPPWorld(port_cfg(small_cfg), device="cpu")


def jax_trajectory(jworld, jhp, key, E, T):
    """A trajectory made by the JAX package's world: E missions take T
    random valid actions (step_index commits), each step recorded with a
    random target policy over the valid actions, random rewards and their
    √-scaled 2-step values; the last step of mission 0 is not a sample."""
    rng = np.random.default_rng(1)
    k_init, k_run = jax.random.split(key)
    state = jax.jit(jworld.init_state, static_argnums=1)(k_init, E)
    mcts = JaxMCTS(jworld, jhp, 2, None)
    valid_fn = jax.jit(jax.vmap(mcts.valid_actions))
    rec = {k: [] for k in ("cov", "mean", "prev_pos", "budget", "policy", "valid_mask")}
    for k in jax.random.split(k_run, T):
        mask = np.asarray(valid_fn(state.pos, state.budget))
        pol = rng.random(mask.shape) * mask
        for name, v in (("cov", state.cov), ("mean", state.mean), ("prev_pos", state.pos),
                        ("budget", state.budget), ("policy", pol / pol.sum(-1, keepdims=True)),
                        ("valid_mask", mask)):
            rec[name].append(np.asarray(v))
        action = jnp.asarray(np.argmax(rng.random(mask.shape) * mask, axis=-1), jnp.int32)
        state = jworld.step_index(state, action, k)
    arrays = {name: np.stack(v, axis=1) for name, v in rec.items()}
    dt = arrays["cov"].dtype
    arrays["policy"] = arrays["policy"].astype(dt)
    reward = rng.uniform(0.5, 3.0, (E, T)).astype(dt)
    ret = reward + np.concatenate([reward[:, 1:], np.zeros((E, 1), dt)], axis=1)
    ok = np.ones((E, T), bool)
    ok[0, -1] = False
    return JaxTrajectory(**arrays, reward=reward, value=np.sqrt(ret + 1) - 1, sample_ok=ok,
                         init_budget=arrays["budget"][:, 0])


# ------------------------------------------------------ the slice as a whole

def test_train_iteration_matches_jax_learner(small_cfg, tmp_path):
    kw = dict(TINY, batch_size=4, num_epochs=2, max_episode_steps=4)
    jworld = JaxWorld(small_cfg, dtype=jnp.float64)
    jl = jlearn.ZeroLearner(jworld, JaxMC(type="mcts_zero", episode_horizon=2,
                                          hyper_params=JaxHP(**kw)),
                            checkpoints_dir=str(tmp_path / "j"), log_dir=str(tmp_path / "jl"),
                            num_envs=3)
    f64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jl.state.variables())
    jl.state = jl.state.replace(params=f64["params"], batch_stats=f64["batch_stats"])
    world = IPPWorld(port_cfg(small_cfg), dtype=F64, device="cpu")
    pl = learn.ZeroLearner(world, MissionConfig(type="mcts_zero", episode_horizon=2,
                                                hyper_params=MCTSZeroHyperParams(**kw)),
                           checkpoints_dir=str(tmp_path / "p"), log_dir=str(tmp_path / "pl"),
                           num_envs=3)
    pl.net.load_state_dict(network_state_dict(jax.tree_util.tree_map(np.asarray, f64)))
    # the JAX epoch runner donates the state's arrays: keep a host copy
    kernel0 = np.array(f64["params"]["value_head"]["head"]["kernel"])
    traj = jax_trajectory(jworld, jl.hp, jax.random.key(4), E=3, T=4)
    jl.replay.add_iteration(0, traj)
    pl.replay.add_iteration(0, Trajectory(*traj))
    assert len(pl.replay) == len(jl.replay) == 11
    want = jl.train_iteration()
    got = pl.train_iteration()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    port = flax_variables(pl.state.variables())
    for coll in ("params", "batch_stats"):
        g = jax.tree_util.tree_leaves_with_path(port[coll])
        w = jax.tree_util.tree_leaves_with_path(getattr(jl.state, coll))
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=jax.tree_util.keystr(path), **TOL)
    # four steps (11 samples: 2 batches of 4, 2 epochs), and the weights moved
    assert pl.state.step == int(jl.state.step) == 4
    assert not np.allclose(port["params"]["value_head"]["head"]["kernel"], kernel0)


# ------------------------------------------------------------ smoke runs

def test_learner_smoke(world, tmp_path):
    lrn = learner(world, tmp_path)
    lrn.learn(num_iterations=1, num_train_batches=2)
    assert os.path.exists(lrn.deployment_path())
    rec = metric_rows(tmp_path)[-1]
    assert np.isfinite(rec["total_loss"]) and np.isfinite(rec["grad_norm"])
    assert rec["iteration"] == 0 and rec["accepted"] is True
    assert {"num_samples", "window", "puct_init", "dirichlet_alpha", "mean_episode_value",
            "selfplay_s", "train_s", "policy_loss", "value_loss", "entropy", "lr"} <= set(rec)
    # schedules decay on iteration > 0 only
    assert lrn.puct_init == TINY_HP.puct_init
    lrn.schedule_exploration(1)
    assert lrn.puct_init == TINY_HP.puct_init * TINY_HP.puct_init_decay
    # checkpoint round trip, and the snapshot and rollback files
    state2 = learn.load_checkpoint(lrn.deployment_path(), lrn.state)
    assert same_weights(state2.variables(), lrn.state.variables())
    assert state2.net is not lrn.state.net
    for name in ("shared_net.temp", "shared_net.snapshot_0"):
        assert os.path.exists(tmp_path / "ckpt" / name)
    assert os.path.exists(tmp_path / "data" / "iter_0.npz")



@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
def test_learner_per_smoke(world, tmp_path, fused):
    """One PER learner iteration trains end to end, fused on the device or
    through the host loop."""
    lrn = learner(world, tmp_path, mission(hp=dict(use_per=True, num_augmented_samples=1)))
    lrn.fused_per = fused
    before = {k: v.clone() for k, v in lrn.state.variables().items()}
    lrn.learn(num_iterations=1, num_train_batches=2)
    assert os.path.exists(lrn.deployment_path())
    assert np.isfinite(metric_rows(tmp_path)[-1]["total_loss"])
    assert not same_weights(before, lrn.state.variables())
    if not fused:  # the host loop updated the priorities it drew
        assert not np.allclose(lrn.replay._priorities, 1.0 / len(lrn.replay))


def test_split_network_learner(world, tmp_path):
    lrn = learner(world, tmp_path, mission(hp=dict(shared_network=False)))
    lrn.learn(num_iterations=1, num_train_batches=2)
    state2 = learn.load_checkpoint(lrn.deployment_path(), lrn.state)
    for part in ("policy", "value"):
        assert same_weights(getattr(state2, part).variables(),
                            getattr(lrn.state, part).variables())
    assert np.isfinite(metric_rows(tmp_path)[-1]["total_loss"])


@pytest.mark.parametrize("threshold", [0.0, 1.0], ids=["accepted", "rolled_back"])
def test_learner_arena_gating(world, tmp_path, threshold):
    """continuous_network_update=False: the arena accepts (threshold 0) or
    rejects (threshold 1: the candidate never wins everything) the trained
    network; a rejection restores shared_net.temp."""
    lrn = learner(world, tmp_path, mission(hp=dict(continuous_network_update=False,
                                                   num_arena_games=3,
                                                   network_update_threshold=threshold)))
    lrn.arena.max_game_steps = 3
    lrn.learn(num_iterations=1, num_train_batches=1, arena_games=2)
    temp = tmp_path / "ckpt" / "shared_net.temp"
    assert os.path.exists(temp)
    accepted = metric_rows(tmp_path)[-1]["accepted"]
    assert accepted is (threshold == 0.0)
    assert os.path.exists(lrn.deployment_path()) is accepted
    rolled = learn.load_checkpoint(str(temp), lrn.state)
    assert same_weights(rolled.variables(), lrn.state.variables()) is not accepted
    assert lrn.prev_network_wins == int(not accepted)


def test_resume_from_jax_files(small_cfg, tmp_path):
    """A run the JAX package started (its npz train data and deployment
    checkpoint) resumes in the port: the same replay window, the JAX
    weights, the first self-play skipped; then it runs on."""
    jworld = JaxWorld(small_cfg, dtype=jnp.float32)
    jmc = JaxMC(type="mcts_zero", episode_horizon=2, hyper_params=JaxHP(**TINY))
    dirs = dict(checkpoints_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                train_data_dir=str(tmp_path / "data"))
    jl = jlearn.ZeroLearner(jworld, jmc, num_envs=2, **dirs)
    for it in range(2):
        jl.save_train_examples(it, jax_trajectory(jworld, jl.hp, jax.random.key(it), 2, 5))
    jlearn.save_checkpoint(jl.deployment_path(), jl.state)

    resume = dict(restart_training=True, train_examples_iter=1)
    jl2 = jlearn.ZeroLearner(jworld, JaxMC(**{**jmc.__dict__, **resume}), num_envs=2, **dirs)
    world = IPPWorld(port_cfg(small_cfg), device="cpu")
    lrn = learn.ZeroLearner(world, mission(**resume), num_envs=2, **dirs)
    assert lrn._resume() == jl2._resume() == (1, True)
    np.testing.assert_array_equal(lrn.replay._index, jl2.replay._index)
    assert same_weights(lrn.state.variables(), network_state_dict(
        jax.tree_util.tree_map(np.asarray, jl.state.variables())))
    # a resumed learn() runs the remaining iterations
    lrn3 = learn.ZeroLearner(world, mission(**resume), num_envs=2, **dirs)
    lrn3.learn(num_iterations=3, num_train_batches=1)
    assert os.path.exists(tmp_path / "data" / "iter_2.npz")
    assert [r["iteration"] for r in metric_rows(tmp_path)] == [1, 2]
    # missing data: a cold start (reference :528)
    lrn4 = learn.ZeroLearner(world, mission(restart_training=True, train_examples_iter=99),
                             num_envs=2, **dirs)
    assert lrn4._resume() == (0, False)


def test_learner_best_snapshot_selection(world, tmp_path):
    lrn = learner(world, tmp_path, deploy_eval_every=1, deploy_eval_envs=2, deploy_eval_steps=2)
    lrn.learn(num_iterations=2, num_train_batches=2)
    assert os.path.exists(lrn.best_path()) and os.path.exists(lrn.best_policy_path())
    assert lrn.best_iteration in (0, 1)
    rows = metric_rows(tmp_path)
    evals = [r["deploy_eval"] for r in rows if "deploy_eval" in r]
    pevals = [r["policy_eval"] for r in rows if "policy_eval" in r]
    assert len(evals) == len(pevals) == 2 and all(e > 0 for e in evals + pevals)
    assert lrn.best_deploy_eval == min(evals) and lrn.best_policy_eval == min(pevals)
    # best tracking is persisted and restored on resume
    lrn2 = learner(world, tmp_path)
    lrn2._load_best_meta()
    assert (lrn2.best_deploy_eval, lrn2.best_iteration, lrn2.best_policy_eval) == (
        lrn.best_deploy_eval, lrn.best_iteration, lrn.best_policy_eval)


def test_deploy_gate_rolls_back(world, tmp_path):
    lrn = learner(world, tmp_path, deploy_eval_every=1, deploy_eval_envs=2, deploy_eval_steps=2,
                  deploy_gate=1.1)
    learn.save_checkpoint(lrn.best_path(), lrn.state)
    best = {k: v.clone() for k, v in lrn.state.variables().items()}
    lrn.best_deploy_eval, lrn.best_iteration = 1.0, 0
    lrn.deploy_eval = lambda: 100.0  # far past 1.1 × best
    lrn.policy_eval = lambda: 50.0
    lrn.learn(num_iterations=1, num_train_batches=1)
    assert metric_rows(tmp_path)[-1]["deploy_rolled_back"] is True
    assert same_weights(best, lrn.state.variables())
    dep = learn.load_checkpoint(lrn.deployment_path(), lrn.state)
    assert same_weights(best, dep.variables())


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("shared", [True, False], ids=["shared", "split"])
def test_port_checkpoint_loads_in_flax_bitwise(small_cfg, tmp_path, shared):
    """A checkpoint the port writes restores into the JAX package's template
    through flax's from_bytes and JAX's load_checkpoint, every array bit
    for bit; the JAX package's own checkpoint loads in the port the same
    way."""
    hp = dict(TINY, shared_network=shared)
    cfg = port_cfg(small_cfg)
    gen = torch.Generator().manual_seed(3)
    if shared:
        _, st = learn.init_train_state(cfg, MCTSZeroHyperParams(**hp), gen, device="cpu")
        _, jst = jtrain.init_train_state(small_cfg, JaxHP(**hp), jax.random.key(0))
    else:
        _, st = learn.init_split_train_state(cfg, MCTSZeroHyperParams(**hp), gen, device="cpu")
        _, jst = jtrain.init_split_train_state(small_cfg, JaxHP(**hp), jax.random.key(0))
    with torch.no_grad():  # non-trivial statistics, so that no leaf is a default
        for name, buf in (st.policy if not shared else st).net.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
    path = str(tmp_path / "port.ckpt")
    learn.save_checkpoint(path, st)
    want = learn.checkpoint_variables(st)
    with open(path, "rb") as f:
        restored = flax.serialization.from_bytes(jst.variables(), f.read())
    jloaded = jlearn.load_checkpoint(path, jst).variables()
    for tree in (restored, jloaded):
        got = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, tree))
        ref = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got] == [p for p, _ in ref] and len(got) > 20
        for (_, g), (_, w) in zip(got, ref):
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()

    jpath = str(tmp_path / "jax.ckpt")
    jlearn.save_checkpoint(jpath, jst)
    loaded = learn.load_checkpoint(jpath, st)
    jvars = jax.tree_util.tree_map(np.asarray, jst.variables())
    parts = [("", loaded, jvars)] if shared else [
        (p, getattr(loaded, p), jvars[p]) for p in ("policy", "value")]
    for _, state, variables in parts:
        assert same_weights(state.variables(), network_state_dict(variables))


def test_msgpack_writer_is_flax_bytes():
    """The port's writer gives the bytes flax's serializer gives for the
    same tree with its keys sorted, for every msgpack type and length class
    a checkpoint can hold (maps, str, non-negative ints, tuples, bytes,
    ndarrays), its reader reads them back, and it refuses any other type."""
    from ipp_rl_tpu_torch import serialization

    tree = {"ints": (0, 127, 128, 255, 256, 70000, 2 ** 40), "s": "x" * 40,
            "long": "y" * 300, "b": b"yy", "bb": b"z" * 70000, "empty": {},
            "a0": np.zeros(()), "arr": np.arange(6, dtype=np.int16).reshape(2, 3),
            "big": np.ones((100, 70), np.float32), "m": {str(i): i for i in range(20)},
            "t": tuple(range(20))}
    # flax packs tuples only inside its ndarray extension; a list is the
    # same msgpack array
    want = flax.serialization.msgpack_serialize(
        {k: list(v) if isinstance(v, tuple) else v for k, v in tree.items()})
    got = serialization.packb(tree)
    assert got == want
    back = serialization.msgpack_restore(got)
    np.testing.assert_array_equal(back.pop("big"), tree["big"])
    assert tuple(back["ints"]) == tree["ints"] and back["long"] == tree["long"]
    for other in (1.5, None, True, [1], -1, np.float32(2.5), complex(1.0, -2.0)):
        with pytest.raises((TypeError, ValueError)):
            serialization.packb({"x": other})
