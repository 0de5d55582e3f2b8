"""Self-play episode generation on the card.

Port of ``ipp_rl_tpu/planners/zero/selfplay.py``.  E environments play in
lockstep, one Python loop over T steps on (E,)-batched tensors (the JAX
package scans them): fresh ground truth and shuffled priors per episode,
random start actions, optional random budgets, a full batched search per
step, the visit policy, an action sampled from it, the simulated one-step
reward, the real measurement and commit (reference
planning/mcts_zero/episode_generators.py:19-192); then n-step discounted
√-scaled value targets (reference :157-184).

The output is a ``Trajectory`` of per-step belief snapshots rather than
feature planes: replay rebuilds the planes from the (cov, position,
budget, mean) history at training time.

Randomness comes from a ``torch.Generator`` or is injected per step
(``SelfPlayDraws``): the search's tie-breaks and root noise, the root
policy's tie-breaks, the Gumbel noise of the action sample (the JAX
package samples with ``jax.random.categorical``, the argmax of logits plus
Gumbel noise) and the measurement noise.  A test that feeds the JAX
package's draws gets its trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ipp_rl_tpu_torch.config.schema import MCTSZeroHyperParams
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask, scale_value_target
from ipp_rl_tpu_torch.planners.zero.features import (
    EpisodeHistory,
    feature_planes,
    init_history,
    push_history,
)
from ipp_rl_tpu_torch.planners.zero.mcts import SearchDraws, ZeroMCTS


class Trajectory(NamedTuple):
    """Self-play records; axes (E envs, T steps, ...)."""

    cov: torch.Tensor  # (E, T, N, N) — belief cov when the decision was made
    mean: torch.Tensor  # (E, T, N) — belief mean (adaptive-mask snapshot)
    prev_pos: torch.Tensor  # (E, T, 3) — position the decision was made from
    budget: torch.Tensor  # (E, T) — remaining budget at the decision
    policy: torch.Tensor  # (E, T, A) — MCTS visit policy target
    valid_mask: torch.Tensor  # (E, T, A) bool
    reward: torch.Tensor  # (E, T) — simulated 1-step reward
    value: torch.Tensor  # (E, T) — √-scaled n-step discounted target
    sample_ok: torch.Tensor  # (E, T) bool
    init_budget: torch.Tensor  # (E,)

    def map(self, fn) -> "Trajectory":
        """``fn`` applied to every field (e.g. ``lambda x: x.cpu().numpy()``)."""
        return Trajectory(*(fn(x) for x in self))


@dataclasses.dataclass
class SelfPlayDraws:
    """Injected random draws of one self-play step over E environments."""

    search: SearchDraws
    policy: torch.Tensor  # (2, E, A) — root_policy's tie-break noise
    sample: torch.Tensor  # (E, A) — Gumbel noise of the action sample
    noise: torch.Tensor  # (E, M) — measurement noise


def planes_from_sample(
    world: IPPWorld,
    hp: MCTSZeroHyperParams,
    covs: torch.Tensor,  # (B, L, N, N) — history states, most recent first
    positions: torch.Tensor,  # (B, L, 3)
    budget_fracs: torch.Tensor,  # (B, L)
    hist_len: torch.Tensor,  # (B,)
    mean: torch.Tensor,  # (B, N)
) -> torch.Tensor:
    """The network input planes (B, N, N, C) of B replay samples."""
    h = EpisodeHistory(covs=covs, positions=positions, budgets=budget_fracs,
                       length=hist_len.to(torch.int32))
    return feature_planes(world, hp, h, mean=mean)


def gumbel(shape, generator: Optional[torch.Generator], dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """Standard Gumbel draws −log(−log U), U uniform on [tiny, 1), as
    ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


def value_targets(rewards: torch.Tensor, horizon: int, gamma: float) -> torch.Tensor:
    """n-step discounted returns value_i = Σ_{j=i}^{min(i+H, T)−1} γ^{j−i} r_j
    of (E, T) rewards — truncated, no bootstrap (reference :162-164, with
    the window-relative discount of the JAX package; γ = 1 canonically)."""
    T = rewards.shape[1]
    out = torch.zeros_like(rewards)
    for k in range(T):
        window = min(horizon, T - k)
        disc = gamma ** torch.arange(window, dtype=rewards.dtype, device=rewards.device)
        out[:, k] = torch.sum(rewards[:, k:k + window] * disc, dim=-1)
    return out


class SelfPlay:
    """Batched self-play generator bound to (world, hp, search)."""

    def __init__(self, world: IPPWorld, hp: MCTSZeroHyperParams, episode_horizon: int,
                 mcts: ZeroMCTS):
        self.world = world
        self.hp = hp
        self.horizon = episode_horizon
        self.mcts = mcts

    def sample_episode_setup(self, num_envs: int,
                             generator: Optional[torch.Generator] = None) -> BeliefState:
        """Fresh worlds, shuffled priors, random start actions, optional
        random budgets (reference episode_generators.py:51-68)."""
        world, hp = self.world, self.hp
        cfg = world.cfg
        budget = None
        if hp.shuffle_budget:
            u = torch.rand((num_envs,), generator=generator, dtype=world.dtype,
                           device=world.device)
            budget = torch.floor(10.0 + (cfg.constraints.budget - 10.0) * u)
        state = world.init_state(num_envs, generator, shuffle_prior=hp.shuffle_prior_cov,
                                 budget=budget)
        init_action = torch.randint(0, world.num_actions, (num_envs,), generator=generator,
                                    device=world.device)
        return state.replace(pos=world.actions_xyz[init_action])

    def run(
        self,
        num_envs: int,
        net_variables=None,
        puct_init: Optional[float] = None,
        dirichlet_alpha: Optional[float] = None,
        num_simulations: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        init_state: Optional[BeliefState] = None,
        draws: Optional[Sequence[SelfPlayDraws]] = None,
    ) -> Tuple[Trajectory, torch.Tensor]:
        """Play one batch of episodes; returns (trajectory, episode values
        Σ γ^j r_j (E,)), both on the world's device (reference
        episode_generators.py:158).

        Draws come from ``generator`` unless ``init_state`` (the episode
        setup) or ``draws`` (one ``SelfPlayDraws`` per step) are given."""
        world, hp = self.world, self.hp
        cfg = world.cfg
        E, T = num_envs, hp.max_episode_steps
        dt, dev = world.dtype, world.device
        state = init_state if init_state is not None else self.sample_episode_setup(E, generator)
        init_budget = state.budget
        hist = init_history(cfg, hp, E, dt, dev)
        scen = cfg.scenario
        records = []
        for t in range(T):
            d = None if draws is None else draws[t]
            # running-episode mask (reference :112: budget >= resolution)
            running = state.active & (state.budget >= cfg.environment.resolution)
            # budget fraction of the CONFIG budget, even under shuffled
            # episode budgets (reference episode_generators.py:113)
            hist = push_history(hist, state.cov, state.pos,
                                state.budget / float(cfg.constraints.budget))
            tree, root_mask = self.mcts.search(
                state.cov, state.mean, state.pos, state.budget, hist,
                net_variables=net_variables, puct_init=puct_init,
                dirichlet_alpha=dirichlet_alpha, num_simulations=num_simulations,
                generator=generator, draws=None if d is None else d.search,
            )
            # an env with NO valid action terminates (reference mcts.py:200-201)
            has_valid = torch.sum(root_mask, dim=-1) > 0
            running = running & has_valid
            temperature = hp.temperature_scale * float(t < hp.temperature_threshold)
            # prune with the SAME (decayed) exploration constant the search used
            policy = self.mcts.root_policy(tree, temperature, puct_init=puct_init,
                                           generator=generator,
                                           draws=None if d is None else d.policy)
            # sample an action per env (reference :135): Gumbel-max
            logits = torch.log(torch.clamp(policy, min=1e-30))
            g = d.sample.to(dt) if d is not None else gumbel(logits.shape, generator, dt, dev)
            action = torch.argmax(logits + g, dim=-1)

            # the stored TARGET may be entropy-smoothed (schema
            # policy_target_smoothing); the sample above uses the plain policy
            policy_target = policy
            if hp.policy_target_smoothing > 0.0:
                eps = hp.policy_target_smoothing
                valid = root_mask.to(dt)
                uniform = valid / torch.clamp(valid.sum(dim=-1, keepdim=True), min=1.0)
                policy_target = (1.0 - eps) * policy + eps * uniform

            # simulated 1-step reward BEFORE committing (reference :137-144)
            dmask = None
            if scen.adaptive:
                dmask = adaptive_mask(state.mean, torch.diagonal(state.cov, dim1=-2, dim2=-1),
                                      scen.value_threshold, scen.interval_factor)
            _, gains = self.mcts.edge_update(state.cov, action, dmask)
            costs = travel_costs(world.actions_xyz[action], state.pos, cfg.uav.max_v,
                                 cfg.uav.max_a)
            reward = gains / (costs + 1.0)
            records.append(dict(
                cov=state.cov, mean=state.mean, prev_pos=state.pos, budget=state.budget,
                policy=policy_target, valid_mask=root_mask,
                reward=torch.where(running, reward, 0.0),
                sample_ok=running & has_valid,
            ))
            # real measurement + commit (reference :145-148)
            state = state.replace(active=running)
            state = world.step_index(state, action, None if d is None else d.noise.to(dt),
                                     generator)

        stacked = {k: torch.stack([r[k] for r in records], dim=1) for k in records[0]}
        rewards = stacked["reward"]
        values = scale_value_target(value_targets(rewards, self.horizon, hp.gamma))
        traj = Trajectory(value=values, init_budget=init_budget, **stacked)
        disc = hp.gamma ** torch.arange(T, dtype=dt, device=dev)
        return traj, torch.sum(rewards * disc, dim=-1)
