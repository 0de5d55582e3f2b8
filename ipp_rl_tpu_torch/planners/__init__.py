from ipp_rl_tpu_torch.planners.base import MissionResult, Planner, sweep_rewards  # noqa: F401
from ipp_rl_tpu_torch.planners.greedy import GreedyPlanner, greedy_search_horizon  # noqa: F401
