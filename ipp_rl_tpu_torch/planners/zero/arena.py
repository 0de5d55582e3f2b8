"""Arena gating: previous against candidate network (reference
planning/mcts_zero/arenas.py:14-56, mcts_zero_mission.py:417-455).

Port of ``ipp_rl_tpu/planners/zero/arena.py``.  Each network plays G
simulated games at once: cov-only dynamics from the GP prior (no
measurements), the greedy temperature-0 search policy each step, the
cumulative discounted reward.  The candidate is accepted iff
curr / (prev + curr) ≥ network_update_threshold (the learner decides).

The edge factor is the transposed (M, N) one of the search's edge update,
so a step's covariance is P − Wcᵀ·Wc.  Draws come from a
``torch.Generator`` or are injected (``ArenaDraws``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ipp_rl_tpu_torch.config.schema import MCTSZeroHyperParams
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask
from ipp_rl_tpu_torch.planners.zero.features import init_history, push_history
from ipp_rl_tpu_torch.planners.zero.mcts import SearchDraws, ZeroMCTS


@dataclasses.dataclass
class ArenaDraws:
    """Injected draws of one network's games: the initial state, and per
    game step the search's draws and root_policy's tie-break noise (2, G, A)."""

    init_state: BeliefState
    search: Sequence[SearchDraws]
    policy: Sequence[torch.Tensor]


class Arena:
    def __init__(self, world: IPPWorld, hp: MCTSZeroHyperParams, episode_horizon: int,
                 max_game_steps: int = 64):
        self.world = world
        self.hp = hp
        self.horizon = episode_horizon
        self.max_game_steps = max_game_steps

    def play_games(
        self,
        predict,
        prev_variables,
        curr_variables,
        num_games: int,
        generator: Optional[torch.Generator] = None,
        num_simulations: Optional[int] = None,
        draws: Optional[Tuple[ArenaDraws, ArenaDraws]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total reward of prev, total reward of curr), each summed over
        its ``num_games`` games; both networks play the same program."""
        d_prev, d_curr = draws if draws is not None else (None, None)
        r_prev = self._play_batch(predict, prev_variables, num_games, generator,
                                  num_simulations, d_prev)
        r_curr = self._play_batch(predict, curr_variables, num_games, generator,
                                  num_simulations, d_curr)
        return torch.sum(r_prev), torch.sum(r_curr)

    def _play_batch(self, predict, net_variables, num_games: int,
                    generator: Optional[torch.Generator] = None, num_simulations=None,
                    draws: Optional[ArenaDraws] = None) -> torch.Tensor:
        """G games with greedy search actions; the belief evolves cov-only
        (reference arenas.py:25-44).  Returns each game's discounted total."""
        world, hp = self.world, self.hp
        cfg = world.cfg
        G, dt, dev = num_games, world.dtype, world.device
        mcts = ZeroMCTS(world, hp, self.horizon, predict)
        state = draws.init_state if draws is not None else world.init_state(G, generator)
        cov, mean, budget = state.cov, state.mean, state.budget
        # reference arena start position [0, 0, 10]
        pos = torch.tensor([0.0, 0.0, 10.0], dtype=dt, device=dev).expand(G, 3)
        hist = init_history(cfg, hp, G, dt, dev)
        total = torch.zeros((G,), dtype=dt, device=dev)
        scen = cfg.scenario
        for depth in range(self.max_game_steps):
            running = budget > 0
            hist = push_history(hist, cov, pos, budget / float(cfg.constraints.budget))
            tree, _ = mcts.search(cov, mean, pos, budget, hist, net_variables=net_variables,
                                  num_simulations=num_simulations, generator=generator,
                                  draws=None if draws is None else draws.search[depth])
            policy = mcts.root_policy(tree, 0.0, deploy_time=False, generator=generator,
                                      draws=None if draws is None else draws.policy[depth])
            action = torch.argmax(policy, dim=-1)
            dmask = None
            if scen.adaptive:
                dmask = adaptive_mask(mean, torch.diagonal(cov, dim1=-2, dim2=-1),
                                      scen.value_threshold, scen.interval_factor)
            WcT, gain = mcts.edge_update(cov, action, dmask)
            cost = travel_costs(world.actions_xyz[action], pos, cfg.uav.max_v, cfg.uav.max_a)
            reward = (gain / (cost + 1.0)).to(dt)
            disc = hp.gamma ** depth
            total = total + torch.where(running, disc * reward, 0.0)
            # WcT is the transposed (M, N) edge factor: P' = P − Wcᵀ·Wc
            cov = torch.where(running[:, None, None], cov - WcT.mT @ WcT, cov)
            pos = torch.where(running[:, None], world.actions_xyz[action], pos)
            budget = torch.where(running, budget - cost, budget)
        return total
