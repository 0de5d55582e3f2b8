"""Experiment orchestration of the port (``ipp_rl_tpu/experiments``)."""

from ipp_rl_tpu_torch.experiments.experiment import (  # noqa: F401
    Experiment,
    create_planner,
    measure_replan_latency,
)
