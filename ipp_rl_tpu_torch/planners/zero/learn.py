"""Checkpoint loading for the MCTS-zero planner.

Port of ``load_checkpoint`` (``ipp_rl_tpu/planners/zero/learn.py:62-81``).
The JAX package's checkpoints are flax msgpack files
(``shared_net.<model_deployment_filename>``); the port reads them with its
own reader (``ipp_rl_tpu_torch/serialization.py``) and maps the variables
onto its modules (``convert.network_state_dict``).  Self-play, replay,
arena and the learner belong to the training slice.
"""

from __future__ import annotations

from typing import Tuple, Union

from ipp_rl_tpu_torch.convert import network_state_dict
from ipp_rl_tpu_torch.models.networks import PolicyNetwork, PolicyValueNetwork, ValueNetwork
from ipp_rl_tpu_torch.serialization import read_checkpoint

Networks = Union[PolicyValueNetwork, Tuple[PolicyNetwork, ValueNetwork]]


def load_checkpoint(path: str, net: Networks) -> Networks:
    """Load a checkpoint into ``net`` (shared, or the split pair), in place
    and strictly: every weight of the network comes from the file and
    every leaf of the file lands in the network.  Returns ``net``."""
    variables = read_checkpoint(path)
    if isinstance(net, tuple):
        p_net, v_net = net
        p_net.load_state_dict(network_state_dict(variables["policy"]))
        v_net.load_state_dict(network_state_dict(variables["value"]))
    else:
        net.load_state_dict(network_state_dict(variables))
    return net
