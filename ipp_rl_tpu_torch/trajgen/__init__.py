from ipp_rl_tpu_torch.trajgen.planner import MavTrajectoryGenerator, build_library  # noqa: F401
