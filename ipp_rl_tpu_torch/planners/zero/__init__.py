"""The MCTS-zero deploy path: the policy-value network's inference, its
feature planes, the batched PUCT search and the deploy planner (port of
``ipp_rl_tpu/planners/zero``; training, replay, self-play and the arena
belong to the training slice)."""

from ipp_rl_tpu_torch.planners.zero.mission import ReplanDraws, ZeroPlanner  # noqa: F401
from ipp_rl_tpu_torch.planners.zero.mcts import SearchDraws, ZeroMCTS  # noqa: F401
