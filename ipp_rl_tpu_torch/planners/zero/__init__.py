"""MCTS-zero (port of ``ipp_rl_tpu/planners/zero``): the policy-value
network's training and inference, its feature planes, the batched PUCT
search, the deploy planner, self-play, replay, the arena and the learner."""

from ipp_rl_tpu_torch.planners.zero.mission import ReplanDraws, ZeroPlanner  # noqa: F401
from ipp_rl_tpu_torch.planners.zero.mcts import SearchDraws, ZeroMCTS  # noqa: F401
