"""Robot deployment node (reference planning/ipp_mission_node.py:22-73).

Port of ``ipp_rl_tpu/ros/mission_node.py``.  The reference runs a rospy
node that builds the planning stack, creates waypoints, and publishes a
latched ``WaypointsTrajectory`` message (max_v / max_a / sampling_time +
Points) on ``plan/waypoints`` for the downstream C++ trajectory sampler
and MPC controller.  Two transports:

  * with rospy installed, ``IPPMissionNode.run_ros()`` publishes the
    same latched topic;
  * without it, ``run()`` returns the message and optionally writes it as
    JSON; the min-snap sampling the reference delegated to an external
    catkin node is done natively (trajgen.MavTrajectoryGenerator), so the
    plan → smooth → sample pipeline works standalone.

The world and the planner are the port's, on the card unless the caller
asks for the CPU.  Run it as ``python -m ipp_rl_tpu_torch.ros.mission_node``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from dataclasses import asdict, dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config
from ipp_rl_tpu_torch.config.schema import Config, MissionConfig
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.experiments.experiment import create_planner
from ipp_rl_tpu_torch.trajgen import MavTrajectoryGenerator
from ipp_rl_tpu_torch.utils import setup_logger

logger = logging.getLogger(__name__)


@dataclass
class WaypointsTrajectory:
    """Message parity with the reference's WaypointsTrajectory
    (reference planning/ipp_mission_node.py:53-69)."""

    max_v: float
    max_a: float
    sampling_time: float
    points: List[List[float]] = field(default_factory=list)
    sampled_trajectory: Optional[List[List[float]]] = None

    def to_json(self) -> str:
        return json.dumps(asdict(self))


class IPPMissionNode:
    """Builds the full stack and produces the waypoint trajectory for
    the robot (reference ipp_mission_node.py:32-69)."""

    def __init__(
        self,
        cfg: Config,
        mission_cfg: Optional[MissionConfig] = None,
        seed: int = 0,
        smooth: bool = True,
        checkpoints_dir: str = "checkpoints",
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.mission_cfg = mission_cfg or cfg.missions[0]
        self.world = IPPWorld(cfg, device=device)
        self.planner = create_planner(self.world, self.mission_cfg, checkpoints_dir)
        self.seed = seed
        self.smooth = smooth

    def create_waypoints(
        self,
        max_steps: Optional[int] = None,
        init_state: Optional[BeliefState] = None,
        noise: Optional[torch.Tensor] = None,
        draws: Optional[Sequence[Any]] = None,
    ) -> np.ndarray:
        """One mission's waypoints (K, 3), planned with a generator seeded
        from ``seed``; ``init_state``, ``noise`` and ``draws`` replace its
        draws as in ``Planner.run``."""
        gen = torch.Generator(device=self.world.device).manual_seed(self.seed)
        res = self.planner.run(1, max_steps=max_steps, init_state=init_state,
                               generator=gen, noise=noise, draws=draws)
        wp = res.waypoints[0]
        return wp[~np.isnan(wp[:, 0])]

    def build_message(self, max_steps: Optional[int] = None, **draws) -> WaypointsTrajectory:
        """The planned waypoints as a message, with the sampled min-snap
        trajectory through them when ``smooth``; ``draws`` go to
        :meth:`create_waypoints`."""
        uav = self.cfg.uav
        wps = self.create_waypoints(max_steps, **draws)
        msg = WaypointsTrajectory(
            max_v=uav.max_v,
            max_a=uav.max_a,
            sampling_time=uav.sampling_time,
            points=wps.tolist(),
        )
        if self.smooth and len(wps) >= 2:
            gen = MavTrajectoryGenerator(uav.max_v, uav.max_a)
            traj = gen.plan_uav_trajectory(wps, sampling_time=uav.sampling_time)
            msg.sampled_trajectory = traj.tolist()
        return msg

    def run(
        self, output_path: Optional[str] = None, max_steps: Optional[int] = None
    ) -> WaypointsTrajectory:
        msg = self.build_message(max_steps)
        if output_path:
            with open(output_path, "w") as f:
                f.write(msg.to_json())
            logger.info("wrote waypoint trajectory to %s", output_path)
        return msg

    def run_ros(self, topic: str = "plan/waypoints", max_steps: Optional[int] = None):
        """Publish on a latched ROS topic (requires rospy; reference
        ipp_mission_node.py:29, 69)."""
        try:
            import rospy
            from std_msgs.msg import String
        except ImportError as e:
            raise RuntimeError(
                "rospy not available — use run() for the standalone transport"
            ) from e
        rospy.init_node("ipp_mission")  # pragma: no cover
        pub = rospy.Publisher(topic, String, queue_size=1, latch=True)  # pragma: no cover
        msg = self.build_message(max_steps)  # pragma: no cover
        pub.publish(String(data=msg.to_json()))  # pragma: no cover
        rospy.spin()  # pragma: no cover


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry (the reference's roslaunch ipp_planning mission.launch,
    reference planning/launch/mission.launch:1-8): build the stack from
    $CONFIG_FILE_PATH (default: the port's example.yaml), plan, and
    publish — over ROS when rospy is importable, else to the $PLAN_OUTPUT
    JSON file.  $CHECKPOINTS_DIR locates an mcts_zero checkpoint.  It runs
    on the card; ``--device cpu`` asks for the CPU."""
    ap = argparse.ArgumentParser(prog="python -m ipp_rl_tpu_torch.ros.mission_node")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"ipp_rl_tpu_torch.ros.mission_node: {e}", file=sys.stderr)
        return 1
    setup_logger(os.environ.get("LOG_DIR", "logs"))
    cfg = load_config(os.environ.get("CONFIG_FILE_PATH", str(CONFIG_DIR / "example.yaml")))
    node = IPPMissionNode(cfg, checkpoints_dir=os.environ.get("CHECKPOINTS_DIR", "checkpoints"),
                          device=device)
    try:
        import rospy  # noqa: F401
    except ImportError:
        node.run(output_path=os.environ.get("PLAN_OUTPUT", "waypoints.json"))
    else:  # pragma: no cover
        node.run_ros()
    return 0


if __name__ == "__main__":
    sys.exit(main())
