"""Deploy-time MCTS-zero planner (reference
planning/mcts_zero/mcts_zero_mission.py:469-666 ``replan``/``execute``).

Port of ``ipp_rl_tpu/planners/zero/mission.py``.  Per replan step: push
the episode history, run the batched search, take the most-visited
action (ties broken at random), measure, commit, repeat.  Root-parallel
workers (``num_root_parallel`` W > 1) are W independent searches whose
root visit counts are summed; here they run as one search over W·B
missions.  ``num_mcts_simulations ≤ 0`` bypasses the search and acts on
the raw policy network's argmax (reference :478-502).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ipp_rl_tpu_torch.config.schema import MissionConfig
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.planners.base import (
    MissionHistory,
    MissionResult,
    Planner,
    charge_think_time,
)
from ipp_rl_tpu_torch.planners.zero.features import (
    EpisodeHistory,
    feature_planes,
    init_history,
    push_history,
)
from ipp_rl_tpu_torch.planners.zero.mcts import SearchDraws, ZeroMCTS, rand_argmax
from ipp_rl_tpu_torch.utils.tracing import span


@dataclasses.dataclass
class ReplanDraws:
    """Injected random draws of one replan step over B missions."""

    search: Sequence[SearchDraws]  # one per root-parallel worker
    tie: torch.Tensor  # (B, A) — the final tie-break among the most-visited actions


class ZeroPlanner(Planner):
    """Batched deployment of a trained policy-value net."""

    name = "mcts_zero"

    def __init__(
        self,
        world: IPPWorld,
        mission_cfg: MissionConfig,
        predict,  # (variables, planes, masks) -> (policy, value)
        variables,
        num_root_parallel: int = 1,
        deploy_mode: str = "reference",
    ):
        """``deploy_mode="reference"`` keeps the reference's deploy-time
        search verbatim: root Dirichlet noise and forced playouts stay on
        (reference mcts.py:221-222, 236 apply both unconditionally).
        ``"clean"`` switches both off, as KataGo does at deployment (the
        JAX package's documented deviation)."""
        super().__init__(world, mission_cfg)
        if deploy_mode not in ("reference", "clean"):
            raise ValueError(f"deploy_mode must be 'reference' or 'clean', got {deploy_mode!r}")
        self.hp = mission_cfg.hyper_params
        self.predict = predict
        self.variables = variables
        self.num_root_parallel = num_root_parallel
        self.deploy_mode = deploy_mode
        self.mcts = ZeroMCTS(world, self.hp, mission_cfg.episode_horizon, predict)

    def _replan(
        self,
        state: BeliefState,
        hist: EpisodeHistory,
        generator: Optional[torch.Generator],
        draws: Optional[ReplanDraws],
    ) -> torch.Tensor:
        """One planning decision for the whole batch: (B,) actions."""
        with span("zero.replan"):
            hp = self.hp
            dt = self.world.dtype
            B = state.batch_size
            if hp.num_mcts_simulations <= 0:
                # raw policy-net argmax (reference :478-502)
                planes = feature_planes(self.world, hp, hist, state.mean)
                masks = self.mcts.valid_actions(state.pos, state.budget)
                policy, _ = self.predict(self.variables, planes, masks.to(dt))
                return torch.argmax(policy * masks, dim=-1)

            W = self.num_root_parallel
            clean = self.deploy_mode == "clean"
            search_draws = None
            if draws is not None:
                search_draws = SearchDraws(
                    select=torch.cat([d.select for d in draws.search], dim=2),
                    root_noise=None if clean else torch.cat([d.root_noise for d in draws.search]),
                )

            def tile(x):  # W copies of the batch, worker-major
                return x.repeat((W,) + (1,) * (x.ndim - 1)) if W > 1 else x

            tree, _ = self.mcts.search(
                tile(state.cov), tile(state.mean), tile(state.pos), tile(state.budget),
                hist.map(tile),
                net_variables=self.variables,
                forced_playouts=not clean,
                root_noise=not clean,
                generator=generator,
                draws=search_draws,
            )
            visits = tree.Nsa[:, 0].reshape(W, B, -1).sum(dim=0)  # (B, A)
            # random tie-break among the most-visited actions: a plain argmax
            # is biased to the first index, which matters at few simulations
            if draws is not None:
                tie = draws.tie
            else:
                tie = torch.rand(visits.shape, generator=generator, dtype=dt, device=visits.device)
            return rand_argmax(visits, tie)

    def run(
        self,
        batch_size: int,
        max_steps: Optional[int] = None,
        init_state: Optional[BeliefState] = None,
        think_time_per_step: float = 0.0,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        draws: Optional[Sequence[ReplanDraws]] = None,
    ) -> MissionResult:
        """The deploy mission loop.  Unlike ``Planner.run`` it pushes the
        history before each replan (budget as a fraction of the config's),
        keeps a mission moving only while its budget is at least one cell's
        resolution, and charges ``think_time_per_step`` against the budget
        when the config counts effective mission time.

        Draws come from ``generator``, except the measurement noise when
        ``noise`` (T, B, M) is given and the search draws when ``draws``
        (one ``ReplanDraws`` per step) are."""
        world, cfg, hp = self.world, self.cfg, self.hp
        T = max_steps if max_steps is not None else self.max_steps()
        think = think_time_per_step if cfg.evaluation.use_effective_mission_time else 0.0
        with span("plan.run"):
            state = (init_state if init_state is not None
                     else world.init_state(batch_size, generator))
            hist = init_history(cfg, hp, state.batch_size, world.dtype, world.device)
            history = MissionHistory(world, state)
            for t in range(T):
                hist = push_history(hist, state.cov, state.pos,
                                    state.budget / float(cfg.constraints.budget))
                action = self._replan(state, hist, generator, None if draws is None else draws[t])
                cost = travel_costs(
                    world.actions_xyz[action], state.pos, cfg.uav.max_v, cfg.uav.max_a
                )
                # the replan loop runs while budget >= resolution (reference :613)
                can_move = (
                    state.active
                    & (state.budget >= cfg.environment.resolution)
                    & (cost <= state.budget)
                    & (cost > 0)
                )
                state = state.replace(active=can_move)
                state = world.step_index(state, action, None if noise is None else noise[t],
                                         generator)
                state = charge_think_time(state, can_move, think)
                history.add(state, world.actions_xyz[action], can_move, cost)
            return history.result(state)
