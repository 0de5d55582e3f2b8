"""Closed-loop robot deployment with a simulated UAV.

Port of ``ipp_rl_tpu/ros/sim_robot.py``.  The reference closes its
planning loop through third-party catkin stacks: the latched
``WaypointsTrajectory`` goes to a C++ trajectory sampler and an MPC
controller flying a Gazebo UAV whose camera images feed the mapper
(reference docker-compose.yaml:3-123; planning/ipp_mission_node.py:22-73
publishes the plan).  This module runs that loop standalone:

  plan (one replan step from the current belief, on the port's device)
    → publish the segment as a ``WaypointsTrajectory`` message
    → FLY it on the host: min-snap polynomial through the segment
      (trajgen.MavTrajectoryGenerator), sampled at the UAV
      ``sampling_time``, the arrival pose perturbed by the tracking noise
    → MEASURE at the arrival pose with the mission's sensor model and
      commit the Kalman update, then replan from the new belief.

``ClosedLoopMission.run()`` executes that cycle until the budget is
exhausted and returns the flight log (per-cycle waypoints, sampled
trajectories, budgets, masked tr(P) / RMSE curves).  Its draws come from
a ``torch.Generator`` seeded from ``seed`` (the initial state, each
replan's draws, the measurement noise) or are injected (``LoopDraws``);
the UAV's tracking noise comes from ``np.random.default_rng(seed)``, as
in the JAX package, so both packages fly the same noise.  Run it as
``python -m ipp_rl_tpu_torch.ros.sim_robot``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config
from ipp_rl_tpu_torch.config.schema import Config, MissionConfig
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.experiments.experiment import create_planner
from ipp_rl_tpu_torch.ros.mission_node import WaypointsTrajectory
from ipp_rl_tpu_torch.trajgen import MavTrajectoryGenerator
from ipp_rl_tpu_torch.utils import setup_logger

logger = logging.getLogger(__name__)


@dataclass
class FlightLog:
    """Per-cycle record of the closed loop."""

    waypoints: List[List[float]] = field(default_factory=list)
    poses: List[List[float]] = field(default_factory=list)  # actual arrival
    trajectories: List[List[List[float]]] = field(default_factory=list)
    budgets: List[float] = field(default_factory=list)
    uncertainty: List[float] = field(default_factory=list)
    rmse: List[float] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


@dataclass
class LoopDraws:
    """A closed loop's random draws made elsewhere (the parity tests pass
    the JAX package's): the initial state (batch 1), each cycle's replan
    draws as ``Planner.run`` takes them for one step (``plan_noise[c]``
    (1, 1, M); ``plan_draws[c]`` the planner's own, or None), and each
    cycle's ε (1, m_max_cont) of the commit at the actual pose, which the
    loop takes only under tracking noise."""

    init_state: BeliefState
    plan_noise: Sequence[torch.Tensor]
    measure_noise: Sequence[torch.Tensor] = ()
    plan_draws: Optional[Sequence[Any]] = None


class SimulatedUAV:
    """Kinematic UAV that flies a waypoint segment on a min-snap
    trajectory (the role of the reference's sampler + MPC + Gazebo
    dynamics), on the host.

    ``tracking_noise_std`` > 0 models the MPC/dynamics tracking error
    the reference's Gazebo loop exhibits (reference
    docker-compose.yaml:88-123): the arrival pose is the planned
    min-snap endpoint plus Gaussian noise clipped at 2σ and to the
    flight envelope, so the mapper measures at the *actual* pose and the
    adaptive replanner has to absorb the discrepancy."""

    def __init__(
        self,
        uav_cfg,
        start: np.ndarray,
        tracking_noise_std: float = 0.0,
        bounds=None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.gen = MavTrajectoryGenerator(uav_cfg.max_v, uav_cfg.max_a)
        self.sampling_time = uav_cfg.sampling_time
        self.position = np.asarray(start, float)
        self.tracking_noise_std = float(tracking_noise_std)
        self.bounds = bounds  # (lo (3,), hi (3,)) position clamp
        self.rng = rng or np.random.default_rng(0)

    def fly(self, waypoint: np.ndarray) -> np.ndarray:
        """Fly from the current position to ``waypoint``; returns the
        sampled trajectory (T, 3) and updates the position to the
        (possibly noise-perturbed) arrival pose."""
        wps = np.stack([self.position, np.asarray(waypoint, float)])
        traj = self.gen.plan_uav_trajectory(wps, sampling_time=self.sampling_time)
        traj = np.asarray(traj, float).reshape(-1, traj.shape[-1])[:, :3]
        pose = np.asarray(waypoint, float)
        if self.tracking_noise_std > 0:
            s = self.tracking_noise_std
            noise = np.clip(self.rng.normal(0.0, s, 3), -2.0 * s, 2.0 * s)
            pose = pose + noise
            if self.bounds is not None:
                pose = np.clip(pose, self.bounds[0], self.bounds[1])
        self.position = pose
        return traj


class ClosedLoopMission:
    """Adaptive replanning against a simulated robot: each cycle plans
    ONE step from the current belief, flies it, measures at the arrival
    pose with the mission's sensor model, and commits the update."""

    def __init__(
        self,
        cfg: Config,
        mission_cfg: Optional[MissionConfig] = None,
        seed: int = 0,
        tracking_noise_std: float = 0.0,
        checkpoints_dir: str = "checkpoints",
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.mission_cfg = mission_cfg or cfg.missions[0]
        self.world = IPPWorld(cfg, device=device)
        self.planner = create_planner(self.world, self.mission_cfg, checkpoints_dir)
        self.seed = seed
        self.tracking_noise_std = float(tracking_noise_std)

    def run(self, max_cycles: int = 64, draws: Optional[LoopDraws] = None) -> FlightLog:
        world, cfg = self.world, self.cfg
        gen = torch.Generator(device=world.device).manual_seed(self.seed)
        state = world.init_state(1, gen) if draws is None else draws.init_state
        env, con = cfg.environment, cfg.constraints
        bounds = (
            np.array([0.0, 0.0, con.min_altitude]),
            np.array([env.extent_x, env.extent_y, con.max_altitude]),
        )
        uav = SimulatedUAV(
            cfg.uav,
            state.pos[0].cpu().numpy(),
            tracking_noise_std=self.tracking_noise_std,
            bounds=bounds,
            rng=np.random.default_rng(self.seed),
        )
        log = FlightLog()

        def record(state):
            m = world.evaluate(state)
            # one copy to the host for the three logged floats
            budget, unc, rmse = torch.stack(
                [state.budget[0], m["uncertainty"][0], m["rmse"][0]]).tolist()
            log.budgets.append(budget)
            log.uncertainty.append(unc)
            log.rmse.append(rmse)

        record(state)
        for cycle in range(max_cycles):
            if log.budgets[-1] < cfg.environment.resolution:
                break
            # one replan step from the current belief; the planner commits
            # the measurement at its chosen waypoint (the pose the simulated
            # UAV arrives at below when it tracks without error)
            res = self.planner.run(
                1, max_steps=1, init_state=state, generator=gen,
                noise=None if draws is None else draws.plan_noise[cycle],
                draws=None if draws is None or draws.plan_draws is None
                else draws.plan_draws[cycle],
            )
            wp = res.waypoints[0, 0]
            if np.any(np.isnan(wp)):
                break
            # publish and fly the segment (the reference's latched
            # WaypointsTrajectory: the full planned segment, start first)
            start = uav.position.copy()
            traj = uav.fly(wp)
            msg = WaypointsTrajectory(
                max_v=cfg.uav.max_v,
                max_a=cfg.uav.max_a,
                sampling_time=cfg.uav.sampling_time,
                points=[start.tolist(), [float(x) for x in wp]],
                sampled_trajectory=traj.tolist(),
            )
            logger.debug("cycle %d: %s", cycle, msg.to_json()[:120])
            if uav.tracking_noise_std > 0:
                # the UAV did NOT arrive exactly at the planned waypoint:
                # discard the planner's hypothetical commit and measure at
                # the ACTUAL pose with the continuous camera model, so the
                # next replan starts from the belief the robot really has
                pose = torch.as_tensor(uav.position, device=world.device).to(world.dtype)[None]
                state = world.step_position(
                    state, pose, None if draws is None else draws.measure_noise[cycle], gen)
            else:
                state = res.final_state
            log.waypoints.append([float(x) for x in wp])
            log.poses.append([float(x) for x in uav.position])
            log.trajectories.append(traj.tolist())
            record(state)
        return log


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the closed loop standalone and write the flight log (the
    native replacement for the reference's rotors_simulation +
    mav_control_rw services, reference docker-compose.yaml:88-123).
    Reads $CONFIG_FILE_PATH (default: the port's example.yaml),
    $TRACKING_NOISE_STD, $MAX_CYCLES, $FLIGHT_LOG_OUTPUT, $LOG_DIR and
    $CHECKPOINTS_DIR.  It runs on the card; ``--device cpu`` asks for the
    CPU."""
    ap = argparse.ArgumentParser(prog="python -m ipp_rl_tpu_torch.ros.sim_robot")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"ipp_rl_tpu_torch.ros.sim_robot: {e}", file=sys.stderr)
        return 1
    setup_logger(os.environ.get("LOG_DIR", "logs"))
    cfg = load_config(os.environ.get("CONFIG_FILE_PATH", str(CONFIG_DIR / "example.yaml")))
    mission = ClosedLoopMission(
        cfg,
        tracking_noise_std=float(os.environ.get("TRACKING_NOISE_STD", "0")),
        checkpoints_dir=os.environ.get("CHECKPOINTS_DIR", "checkpoints"),
        device=device,
    )
    log = mission.run(max_cycles=int(os.environ.get("MAX_CYCLES", "64")))
    out = os.environ.get("FLIGHT_LOG_OUTPUT", "flight_log.json")
    with open(out, "w") as f:
        f.write(log.to_json())
    logger.info(
        "closed loop done: %d cycles, final masked tr(P) %.2f -> %s",
        len(log.waypoints), log.uncertainty[-1], out,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
