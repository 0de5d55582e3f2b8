from ipp_rl_tpu_torch.ros.mission_node import IPPMissionNode, WaypointsTrajectory  # noqa: F401
