"""Self-play training orchestration (reference
planning/mcts_zero/mcts_zero_mission.py:254-415 ``learn``).

Port of ``ipp_rl_tpu/planners/zero/learn.py``.  Per self-play iteration:
  1. decay the exploration parameters with floors (puct_init ×0.8 ≥ 4,
     dirichlet_alpha ×0.8 ≥ 0.3 — reference :231-243),
  2. grow the replay window (start + iter/step, capped — reference
     :245-252),
  3. generate E episodes on the card (``SelfPlay.run``),
  4. snapshot the current network (the rollback point), train num_epochs
     over the window (reference :370-387),
  5. continuous update, or arena gating with rollback (reference :389-398).

Checkpoints are flax msgpack files in the JAX package's format and names
(``shared_net.temp``, ``shared_net.snapshot_<k>``, the deployment file,
``shared_net.best``, ``shared_net.best_policy``, ``shared_net.best.json``),
so either package reads the other's; self-play data persists as
``train_data/iter_<k>.npz`` with the same fields; metrics stream to
``train_metrics.jsonl`` with the same keys.  Randomness: a numpy generator
for the replay rows (as the JAX package) and a ``torch.Generator`` on the
world's device for everything else, both from ``seed``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config, MCTSZeroHyperParams, MissionConfig
from ipp_rl_tpu_torch.convert import flax_variables, network_state_dict
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.models.networks import PolicyNetwork, PolicyValueNetwork, ValueNetwork
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.planners.zero.arena import Arena
from ipp_rl_tpu_torch.planners.zero.features import feature_planes, init_history, push_history
from ipp_rl_tpu_torch.planners.zero.mcts import ZeroMCTS, rand_argmax
from ipp_rl_tpu_torch.planners.zero.replay import PrioritizedReplayBuffer, ReplayBuffer
from ipp_rl_tpu_torch.planners.zero.selfplay import SelfPlay, Trajectory
from ipp_rl_tpu_torch.planners.zero.train import (
    SplitTrainState,
    TrainState,
    ZeroTrainState,
    cudnn_deterministic,
    inference_dtype,
    init_split_train_state,
    init_train_state,
    make_split_train_step,
    make_train_step,
    onecycle_lr,
    predict_fn,
    reset_optimizer,
    split_predict_fn,
)
from ipp_rl_tpu_torch.serialization import read_checkpoint, write_checkpoint

logger = logging.getLogger(__name__)

Networks = Union[PolicyValueNetwork, Tuple[PolicyNetwork, ValueNetwork]]


def checkpoint_variables(state: TrainState):
    """The flax variable tree a checkpoint of ``state`` holds (shared, or
    ``{"policy": ..., "value": ...}`` for the split pair)."""
    if isinstance(state, SplitTrainState):
        return {"policy": flax_variables(state.policy.variables()),
                "value": flax_variables(state.value.variables())}
    return flax_variables(state.variables())


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the network variables (shared or split state) as the JAX
    package's ``save_checkpoint`` does: flax's ``to_bytes`` format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_checkpoint(path, checkpoint_variables(state))


def _restored(state: ZeroTrainState, variables) -> ZeroTrainState:
    """A copy of ``state`` whose network holds ``variables``; the optimiser
    state (momentum, step) is carried over, as the JAX package replaces
    only params and batch_stats."""
    net = copy.deepcopy(state.net)
    net.load_state_dict(network_state_dict(variables))
    opt = type(state.optimizer)(net.parameters(), **state.optimizer.defaults)
    opt.load_state_dict(state.optimizer.state_dict())
    return ZeroTrainState(net, opt, state.step)


def load_checkpoint(path: str, target: Union[TrainState, Networks]):
    """Load a checkpoint strictly: every weight comes from the file and
    every leaf of the file lands in the network.  A train state (shared or
    split) gives a new state, the template untouched; a network (or the
    split pair) is loaded in place and returned."""
    variables = read_checkpoint(path)
    if isinstance(target, SplitTrainState):
        return SplitTrainState(_restored(target.policy, variables["policy"]),
                               _restored(target.value, variables["value"]))
    if isinstance(target, ZeroTrainState):
        return _restored(target, variables)
    if isinstance(target, tuple):
        p_net, v_net = target
        p_net.load_state_dict(network_state_dict(variables["policy"]))
        v_net.load_state_dict(network_state_dict(variables["value"]))
        return target
    target.load_state_dict(network_state_dict(variables))
    return target


def _scalar(v):
    if isinstance(v, (np.generic, torch.Tensor)):
        return float(v)
    return v


class ZeroLearner:
    """Owns the network state, the self-play generator, replay and arena."""

    def __init__(
        self,
        world: IPPWorld,
        mission_cfg: MissionConfig,
        checkpoints_dir: str = "checkpoints",
        log_dir: str = "logs",
        num_envs: Optional[int] = None,
        seed: int = 42,
        use_tensorboard: bool = False,
        train_data_dir: Optional[str] = None,
        deploy_eval_every: int = 0,
        deploy_eval_envs: int = 16,
        deploy_eval_steps: int = 16,
        deploy_eval_world: Optional[IPPWorld] = None,
        deploy_gate: float = 0.0,
    ):
        """Runs on the world's device.  Every train step runs under cuDNN's
        deterministic algorithms (``train.cudnn_deterministic``), so that,
        as the JAX learner, a run repeats from its seed.  ``deploy_eval_every`` > 0 runs a
        small held-out deploy eval (fixed worlds, temperature-0 visit
        argmax) every k iterations and keeps the best snapshot at
        ``shared_net.best``; ``deploy_gate`` > 0 rolls the network back to
        that snapshot when the current eval exceeds ``deploy_gate × best``
        (lower is better), as the JAX package's learner does."""
        self.world = world
        self.cfg: Config = world.cfg
        self.mc = mission_cfg
        self.hp: MCTSZeroHyperParams = mission_cfg.hyper_params
        self.checkpoints_dir = checkpoints_dir
        self.log_dir = log_dir
        # persisted self-play data for kill-and-resume (reference
        # mcts_zero_mission.py:309-311,364-368); one npz per iteration
        self.train_data_dir = train_data_dir or os.environ.get(
            "TRAIN_DATA_DIR", os.path.join(checkpoints_dir, "train_data"))
        for d in (checkpoints_dir, log_dir, self.train_data_dir):
            os.makedirs(d, exist_ok=True)
        self._metrics_file = os.path.join(log_dir, "train_metrics.jsonl")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
            except ImportError as e:
                logger.warning("tensorboard unavailable: %s", e)

        hp = self.hp
        # reference: num_workers × num_episodes sequential episodes → one batch
        self.num_envs = num_envs or hp.num_workers * hp.num_episodes
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=world.device).manual_seed(seed)

        # legacy global-OneCycle horizon (hp.per_iteration_lr_schedule=False)
        self._global_step = 0
        self._global_total = hp.num_self_play_iterations * hp.num_epochs * 64
        if hp.shared_network:
            self.net, self.state = init_train_state(self.cfg, hp, self.generator, world.device,
                                                    world.dtype)
            step = make_train_step(hp)
            self.predict = predict_fn(self.net, dtype=inference_dtype(hp))
        else:
            self.net, self.state = init_split_train_state(self.cfg, hp, self.generator,
                                                          world.device, world.dtype)
            step = make_split_train_step(hp)
            self.predict = split_predict_fn(self.net, dtype=inference_dtype(hp))
        self.train_step = cudnn_deterministic(step)
        self.mcts = ZeroMCTS(world, hp, mission_cfg.episode_horizon, self.predict)
        self.selfplay = SelfPlay(world, hp, mission_cfg.episode_horizon, self.mcts)
        buffer_cls = PrioritizedReplayBuffer if hp.use_per else ReplayBuffer
        self.replay = buffer_cls(world, hp, hp.start_train_examples_history)
        self._epoch_runner = None  # built at first use (fused uniform path)
        self._per_epoch_runner = None  # (fused PER path)
        self.fused_per = True  # False: the host-loop PER (tests compare both)
        self._CHUNK_STEPS = 32
        self.arena = Arena(world, hp, mission_cfg.episode_horizon)

        # mutable exploration schedule (reference :231-243)
        self.puct_init = hp.puct_init
        self.dirichlet_alpha = hp.dirichlet_alpha
        self.prev_network_wins = 0

        # best-snapshot selection by held-out deploy eval
        self.deploy_eval_every = deploy_eval_every
        self.deploy_eval_envs = deploy_eval_envs
        self.deploy_eval_steps = deploy_eval_steps
        self.best_deploy_eval = float("inf")
        self.best_iteration = -1
        self.deploy_gate = float(deploy_gate)
        self._deploy_eval_state: Optional[BeliefState] = None  # fixed eval worlds
        self.best_policy_eval = float("inf")
        self.best_policy_iteration = -1
        # selection happens in the exact world even when self-play runs
        # with inflated noise
        self._deploy_eval_world = deploy_eval_world or world

        # per-iteration notification stream (reference mission :398-415)
        self.notifier = None
        if mission_cfg.telegram_notifications:
            from ipp_rl_tpu_torch.utils.notifications import Notifier

            self.notifier = Notifier("mcts_zero.learn", out_dir=log_dir)

    # --------------------------------------- best-snapshot deploy eval

    def _eval_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self._deploy_eval_world.device).manual_seed(seed)

    def _eval_state(self) -> BeliefState:
        """The fixed held-out eval worlds, drawn once."""
        if self._deploy_eval_state is None:
            self._deploy_eval_state = self._deploy_eval_world.init_state(
                self.deploy_eval_envs, self._eval_generator(777))
        return self._deploy_eval_state

    def _eval_rollout(self, choose, generator: torch.Generator) -> float:
        """Mean final uncertainty of the eval worlds rolled out for
        ``deploy_eval_steps`` steps, ``choose(state, hist)`` giving the
        actions."""
        world, cfg, hp = self._deploy_eval_world, self.cfg, self.hp
        state = self._eval_state()
        hist = init_history(cfg, hp, state.batch_size, world.dtype, world.device)
        for _ in range(self.deploy_eval_steps):
            hist = push_history(hist, state.cov, state.pos,
                                state.budget / float(cfg.constraints.budget))
            action = choose(state, hist)
            cost = travel_costs(world.actions_xyz[action], state.pos, cfg.uav.max_v,
                                cfg.uav.max_a)
            can = (state.active & (state.budget >= cfg.environment.resolution)
                   & (cost <= state.budget) & (cost > 0))
            state = world.step_index(state.replace(active=can), action, generator=generator)
        return float(torch.mean(world.evaluate(state)["uncertainty"]))

    def deploy_eval(self) -> float:
        """Held-out deploy quality (mean final masked tr(P)) of the current
        network on the fixed eval worlds: a clean deploy search (no root
        noise or forced playouts) at the floor exploration constants,
        temperature-0 visit argmax with random tie-breaks."""
        hp = dataclasses.replace(self.hp, puct_init=self.hp.puct_init_min,
                                 dirichlet_alpha=self.hp.dirichlet_alpha_min)
        mcts = ZeroMCTS(self._deploy_eval_world, hp, self.mc.episode_horizon, self.predict)
        variables = self.state.variables()
        gen = self._eval_generator(778)

        def choose(state, hist):
            tree, _ = mcts.search(state.cov, state.mean, state.pos, state.budget, hist,
                                  net_variables=variables, forced_playouts=False,
                                  root_noise=False, generator=gen)
            visits = tree.Nsa[:, 0]
            return rand_argmax(visits, torch.rand(visits.shape, generator=gen,
                                                  dtype=visits.dtype, device=visits.device))

        return self._eval_rollout(choose, gen)

    def policy_eval(self) -> float:
        """Held-out RAW-POLICY quality (mean final masked tr(P)) of the
        current network: the same eval worlds rolled out with the bare
        policy network's argmax (the sims = 0 deployment, reference
        mcts_zero_mission.py:478-502)."""
        world, hp = self._deploy_eval_world, self.hp
        mcts = ZeroMCTS(world, hp, self.mc.episode_horizon, self.predict)
        variables = self.state.variables()

        def choose(state, hist):
            planes = feature_planes(world, hp, hist, state.mean)
            masks = mcts.valid_actions(state.pos, state.budget)
            policy, _ = self.predict(variables, planes, masks.to(world.dtype))
            return torch.argmax(policy * masks, dim=-1)

        return self._eval_rollout(choose, self._eval_generator(779))

    def best_policy_path(self) -> str:
        return os.path.join(self.checkpoints_dir, "shared_net.best_policy")

    def best_path(self) -> str:
        return os.path.join(self.checkpoints_dir, "shared_net.best")

    def _best_meta_path(self) -> str:
        return self.best_path() + ".json"

    def _save_best_meta(self):
        """Persist best-snapshot tracking, so a resumed run cannot overwrite
        shared_net.best with a worse snapshot."""
        tmp = self._best_meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"best_deploy_eval": self.best_deploy_eval,
                       "best_iteration": self.best_iteration,
                       "best_policy_eval": self.best_policy_eval,
                       "best_policy_iteration": self.best_policy_iteration}, f)
        os.replace(tmp, self._best_meta_path())

    def _load_best_meta(self):
        """Restore best-snapshot tracking (no-op if never saved)."""
        if not os.path.exists(self._best_meta_path()):
            return
        try:
            with open(self._best_meta_path()) as f:
                meta = json.load(f)
            self.best_deploy_eval = float(meta["best_deploy_eval"])
            self.best_iteration = int(meta["best_iteration"])
            self.best_policy_eval = float(meta.get("best_policy_eval", float("inf")))
            self.best_policy_iteration = int(meta.get("best_policy_iteration", -1))
            logger.info("restored best-snapshot tracking: %.3f @ iter %d",
                        self.best_deploy_eval, self.best_iteration)
        except (ValueError, KeyError) as e:  # json.JSONDecodeError is a ValueError
            logger.warning("could not restore best-snapshot meta: %s", e)

    def deployment_path(self) -> str:
        return os.path.join(self.checkpoints_dir,
                            f"shared_net.{self.mc.model_deployment_filename}")

    def _log(self, record: Dict):
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps({k: _scalar(v) for k, v in record.items()}) + "\n")
        if self._tb is not None:
            step = int(record.get("iteration", 0))
            for k, v in record.items():
                val = _scalar(v)
                if isinstance(val, (int, float)) and k != "iteration":
                    self._tb.add_scalar(f"train/{k}", val, step)
            self._tb.flush()

    def schedule_exploration(self, iteration: int):
        if iteration > 0:
            self.puct_init = max(self.hp.puct_init_min, self.puct_init * self.hp.puct_init_decay)
            self.dirichlet_alpha = max(self.hp.dirichlet_alpha_min,
                                       self.dirichlet_alpha * self.hp.dirichlet_alpha_decay)

    def window_size(self, iteration: int) -> int:
        hp = self.hp
        return min(int(hp.start_train_examples_history + iteration / hp.train_examples_history_step),
                   hp.max_train_examples_history)

    # --------------------------------------------- train-data persistence

    def _iter_path(self, iteration: int) -> str:
        return os.path.join(self.train_data_dir, f"iter_{iteration}.npz")

    def save_train_examples(self, iteration: int, traj: Trajectory):
        """Persist one self-play iteration as a compressed npz of the
        trajectory's host arrays (reference mission :309-311,346-352)."""
        arrays = {f: np.asarray(getattr(traj, f)) for f in Trajectory._fields}
        tmp = self._iter_path(iteration) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, self._iter_path(iteration))

    def load_train_examples(self, iteration: int) -> Optional[Trajectory]:
        path = self._iter_path(iteration)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return Trajectory(**{f: z[f] for f in Trajectory._fields})

    def prune_train_examples(self, window_start: int):
        """Sliding-window deletion of outdated iteration files (reference
        mission :364-368)."""
        for name in os.listdir(self.train_data_dir):
            if name.startswith("iter_") and name.endswith(".npz"):
                try:
                    it = int(name[len("iter_"):-len(".npz")])
                except ValueError:
                    continue
                if it < window_start:
                    os.remove(os.path.join(self.train_data_dir, name))

    def check_for_train_examples(self) -> bool:
        """True if persisted data exists for mc.train_examples_iter
        (reference :525-531)."""
        found = os.path.exists(self._iter_path(self.mc.train_examples_iter))
        if found:
            logger.info("found train examples for iteration %d", self.mc.train_examples_iter)
        else:
            logger.error("train examples '%s' not found!",
                         self._iter_path(self.mc.train_examples_iter))
        return found

    def _resume(self) -> Tuple[int, bool]:
        """Resume an interrupted run (reference execute :545-562, learn
        :304): load the deployment checkpoint if present and, when
        persisted self-play data exists for train_examples_iter, start there
        with the first self-play skipped.  Returns (start_iteration,
        skip_first_self_play)."""
        dp = self.deployment_path()
        if os.path.exists(dp):
            self.state = load_checkpoint(dp, self.state)
            logger.info("restart: loaded deployment checkpoint %s", dp)
        self._load_best_meta()
        if not self.check_for_train_examples():
            return 0, False
        start = self.mc.train_examples_iter
        # fast-forward the exploration decay to where iteration `start`
        # finds it (the JAX package's documented deviation)
        for it in range(1, start):
            self.schedule_exploration(it)
        window = self.window_size(start)
        for it in range(max(0, start - window + 1), start + 1):
            traj = self.load_train_examples(it)
            if traj is not None:
                self.replay.add_iteration(it, traj)
        logger.info("resuming at iteration %d with %d replay samples", start, len(self.replay))
        return start, True

    # ---------------------------------------------------------------- learn

    def learn(self, num_iterations: Optional[int] = None,
              num_train_batches: Optional[int] = None, arena_games: Optional[int] = None):
        """The full training loop; the optional caps shrink the canonical
        workload for tests and smoke runs."""
        hp = self.hp
        iters = num_iterations or hp.num_self_play_iterations
        start_iteration, skip_first_self_play = 0, False
        if self.mc.restart_training:
            start_iteration, skip_first_self_play = self._resume()
        for iteration in range(start_iteration, iters):
            t0 = time.time()
            self.schedule_exploration(iteration)
            window = self.window_size(iteration)
            self.replay.set_window(iteration, window)
            self.prune_train_examples(max(0, iteration - window + 1))

            if skip_first_self_play and iteration == start_iteration:
                episode_values = np.zeros((1,), np.float32)  # reuse the persisted examples
            else:
                traj_dev, ep_dev = self.selfplay.run(
                    self.num_envs, net_variables=self.state.variables(),
                    puct_init=self.puct_init, dirichlet_alpha=self.dirichlet_alpha,
                    generator=self.generator)
                traj = traj_dev.map(lambda x: x.cpu().numpy())
                episode_values = ep_dev.cpu().numpy()
                # the device copy stays for the fused epoch runner
                self.replay.add_iteration(iteration, traj, device_traj=traj_dev)
                self.save_train_examples(iteration, traj)
            sp_time = time.time() - t0

            # rollback snapshot (reference :370-372)
            temp_path = os.path.join(self.checkpoints_dir, "shared_net.temp")
            save_checkpoint(temp_path, self.state)

            t1 = time.time()
            metrics = self.train_iteration(num_train_batches)
            train_time = time.time() - t1

            save_checkpoint(os.path.join(self.checkpoints_dir, f"shared_net.snapshot_{iteration}"),
                            self.state)
            accepted = True
            if not hp.continuous_network_update:
                # the rollback state is re-read from the temp checkpoint
                prev_state = load_checkpoint(temp_path, self.state)
                accepted = self.arena_gate(prev_state, arena_games)
            if accepted:
                save_checkpoint(self.deployment_path(), self.state)

            # deploy eval AFTER the gate, so a rejected (rolled-back)
            # iteration is never recorded as the best snapshot
            deploy_metric = policy_metric = None
            deploy_rolled_back = False
            if self.deploy_eval_every and accepted and (
                iteration % self.deploy_eval_every == 0 or iteration == iters - 1
            ):
                # the raw-policy eval first, so it scores this iteration's weights
                policy_metric = self.policy_eval()
                if policy_metric < self.best_policy_eval:
                    self.best_policy_eval = policy_metric
                    self.best_policy_iteration = iteration
                    save_checkpoint(self.best_policy_path(), self.state)
                    self._save_best_meta()
                deploy_metric = self.deploy_eval()
                if deploy_metric < self.best_deploy_eval:
                    self.best_deploy_eval = deploy_metric
                    self.best_iteration = iteration
                    save_checkpoint(self.best_path(), self.state)
                    self._save_best_meta()
                elif (self.deploy_gate > 0 and self.best_iteration >= 0
                      and deploy_metric > self.deploy_gate * self.best_deploy_eval
                      and os.path.exists(self.best_path())):
                    # the network degraded past tolerance on the held-out
                    # worlds: roll back to the best snapshot and go on from there
                    self.state = load_checkpoint(self.best_path(), self.state)
                    save_checkpoint(self.deployment_path(), self.state)
                    deploy_rolled_back = True
                    logger.info("iter %d: deploy eval %.2f > %.2f×best %.2f — ROLLED BACK to "
                                "best snapshot (iter %d)", iteration, deploy_metric,
                                self.deploy_gate, self.best_deploy_eval, self.best_iteration)
                logger.info("iter %d: deploy eval %.2f (best %.2f @ iter %d)", iteration,
                            deploy_metric, self.best_deploy_eval, self.best_iteration)

            self._log(dict(
                iteration=iteration,
                num_samples=len(self.replay),
                window=window,
                puct_init=self.puct_init,
                dirichlet_alpha=self.dirichlet_alpha,
                mean_episode_value=float(np.mean(episode_values)),
                selfplay_s=sp_time,
                train_s=train_time,
                accepted=accepted,
                **({"deploy_eval": deploy_metric, "deploy_rolled_back": deploy_rolled_back,
                    "policy_eval": policy_metric} if deploy_metric is not None else {}),
                **(metrics or {}),
            ))
            logger.info("iter %d: %d samples, episode value %.3f, accepted=%s", iteration,
                        len(self.replay), float(np.mean(episode_values)), accepted)
            if self.notifier is not None:
                self.notifier.finished_iteration(str(iteration), {
                    "num_samples": len(self.replay),
                    "accepted": accepted,
                    "mean_episode_value": float(np.mean(episode_values)),
                    "collected_new_episodes": not (skip_first_self_play
                                                   and iteration == start_iteration),
                })
        if self.notifier is not None:
            self.notifier.finished({"iterations": iters})

    def _lrs(self, start: int, count: int, executed: int) -> np.ndarray:
        """The chunk's LRs, float32 as the JAX package passes them: the
        per-iteration OneCycle over ``executed`` steps, or the global one."""
        hp = self.hp
        if hp.per_iteration_lr_schedule:
            lrs = [onecycle_lr(hp, start + s, executed) for s in range(count)]
        else:
            lrs = [onecycle_lr(hp, self._global_step + s, self._global_total)
                   for s in range(count)]
        return np.asarray(lrs, np.float32)

    def train_iteration(self, num_batches_cap: Optional[int] = None) -> Dict:
        """Train num_epochs over the replay window with the reference
        recipe: a fresh SGD and a three-phase OneCycle sized to this
        iteration's steps (reference wrappers :51-69); with
        hp.per_iteration_lr_schedule=False the global schedule and
        persistent momentum instead.  Uniform replay takes the fused path;
        PER the fused PER path, or the host loop when ``fused_per`` is
        False."""
        hp = self.hp
        num_batches = self.replay.num_batches(hp.batch_size)
        if num_batches_cap is not None:
            num_batches = min(num_batches, num_batches_cap)
        per = isinstance(self.replay, PrioritizedReplayBuffer)
        if per:
            self.replay.begin_training(hp.batch_size, hp.num_epochs)
        total_steps = max(1, num_batches * hp.num_epochs)
        if hp.per_iteration_lr_schedule:
            self.state = reset_optimizer(hp, self.state)
        if not per:
            return self._train_iteration_fused(total_steps)
        if self.fused_per:
            return self._train_iteration_fused_per(total_steps)
        last = {}
        step_in_iter = 0
        for _ in range(hp.num_epochs):
            for _ in range(num_batches):
                if hp.per_iteration_lr_schedule:
                    lr = onecycle_lr(hp, step_in_iter, total_steps)
                else:
                    lr = onecycle_lr(hp, self._global_step, self._global_total)
                batch, idx = self.replay.sample(hp.batch_size, self.rng, self.generator)
                self.state, metrics, value_l = self.train_step(self.state, batch,
                                                               self.generator, lr)
                step_in_iter += 1
                self._global_step += 1
                self.replay.step()
                self.replay.update(idx, value_l[: len(idx)].cpu().numpy() + 1e-8)
                last = {k: float(v) for k, v in metrics.items()}
                last["lr"] = lr
        return last

    def _chunks(self, total_steps: int) -> Tuple[int, int, int]:
        """(chunk, n_chunks, executed): ``total_steps`` rounded DOWN to
        whole chunks of ``_CHUNK_STEPS``; the OneCycle horizon is the
        executed count, so the schedule still sweeps its three phases."""
        chunk = min(self._CHUNK_STEPS, max(1, total_steps))
        n_chunks = max(1, total_steps // chunk)
        return chunk, n_chunks, n_chunks * chunk

    def _train_iteration_fused(self, total_steps: int) -> Dict:
        """The uniform epochs on the card: the window stays resident, each
        chunk ships its rows and LRs and reads its metrics back once."""
        hp = self.hp
        if self._epoch_runner is None:
            self._epoch_runner = self.replay.make_epoch_runner(self.train_step)
        win, slot_map = self.replay.device_window(hp.max_train_examples_history)
        chunk, n_chunks, executed = self._chunks(total_steps)
        last = {}
        for c in range(n_chunks):
            lrs = self._lrs(c * chunk, chunk, executed)
            rows = self.replay.epoch_rows(chunk, hp.batch_size, self.rng, slot_map)
            self.state, metrics = self._epoch_runner(self.state, win, rows, lrs, self.generator)
            self._global_step += chunk
            last = {k: float(v[-1]) for k, v in metrics.items()}
            last["lr"] = float(lrs[-1])
        return last

    def _train_iteration_fused_per(self, total_steps: int) -> Dict:
        """The PER epochs on the card: priorities live there and are sampled
        from and updated inside each chunk; β anneals β0 → 1 over the
        executed steps as the host loop's begin_training/step does
        (reference replay_buffers.py:117-128)."""
        hp = self.hp
        if self._per_epoch_runner is None:
            self._per_epoch_runner = self.replay.make_per_epoch_runner(
                self.train_step, self.replay.draw(hp.batch_size))
        win, _ = self.replay.device_window(hp.max_train_examples_history)
        valid = self.replay.device_valid(hp.max_train_examples_history)
        pri = self.replay.init_device_priorities(valid)
        chunk, n_chunks, executed = self._chunks(total_steps)
        beta0 = self.replay.beta0
        last = {}
        for c in range(n_chunks):
            lrs = self._lrs(c * chunk, chunk, executed)
            betas = np.asarray([min(beta0 + (c * chunk + s) * (1.0 - beta0) / executed, 1.0)
                                for s in range(chunk)], np.float32)
            self.state, pri, metrics = self._per_epoch_runner(self.state, pri, win, valid, lrs,
                                                              betas, self.generator)
            self._global_step += chunk
            last = {k: float(v[-1]) for k, v in metrics.items()}
            last["lr"] = float(lrs[-1])
        return last

    def arena_gate(self, prev_state: TrainState, arena_games: Optional[int] = None) -> bool:
        """Accept or roll back via the arena (reference :417-455); a
        rejection re-reads ``shared_net.temp``."""
        hp = self.hp
        r_prev, r_curr = self.arena.play_games(
            self.predict, prev_state.variables(), self.state.variables(),
            arena_games or hp.num_arena_games, self.generator)
        r_prev, r_curr = float(r_prev), float(r_curr)
        rel = r_curr / max(r_prev + r_curr, 1e-12)
        if rel < hp.network_update_threshold:
            logger.info("REJECTED new network (rel=%.3f)", rel)
            self.prev_network_wins += 1
            self.state = load_checkpoint(os.path.join(self.checkpoints_dir, "shared_net.temp"),
                                         self.state)
            return False
        logger.info("ACCEPTED new network (rel=%.3f)", rel)
        return True
