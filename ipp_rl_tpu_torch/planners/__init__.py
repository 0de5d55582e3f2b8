from ipp_rl_tpu_torch.planners.base import MissionResult, Planner, sweep_rewards  # noqa: F401
from ipp_rl_tpu_torch.planners.greedy import GreedyPlanner, greedy_search_horizon  # noqa: F401
from ipp_rl_tpu_torch.planners.static_paths import (  # noqa: F401
    LawnmowerPlanner,
    RandomContinuousPlanner,
    RandomDiscretePlanner,
    SpiralPlanner,
)
from ipp_rl_tpu_torch.planners.cmaes import CMAESPlanner  # noqa: F401
