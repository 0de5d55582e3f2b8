"""The deployment slice against the JAX package in float64: the mission
node's message (points, sampled trajectory, JSON) and the closed loop's
flight log with and without tracking noise, with the JAX runs' draws
injected by walking their key chains (ipp_rl_tpu/ros/mission_node.py:70-74,
ros/sim_robot.py:132-192, planners/base.py:173-204, env/world.py:305,333).
Both sides build their world and planner in float64 from the test side,
as tests/test_sharded.py passes worlds with dtype=jnp.float64.

Waypoints, poses and trajectories must be bitwise equal (the trajectories
come from the same C++ source on the same host); budgets, uncertainty and
RMSE agree to rtol 1e-10, which covers summation order only (the two
packages reduce the same float64 products in different orders)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ipp_rl_tpu.config.schema import MissionConfig as JaxMissionConfig
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.experiments.experiment import create_planner as jax_create_planner
from ipp_rl_tpu.ros import IPPMissionNode as JaxNode
from ipp_rl_tpu.ros.sim_robot import ClosedLoopMission as JaxLoop
from ipp_rl_tpu_torch.config import MissionConfig
from ipp_rl_tpu_torch.convert import belief_state_from_arrays, noise_from_arrays
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.experiments.experiment import create_planner
from ipp_rl_tpu_torch.ros import IPPMissionNode, WaypointsTrajectory
from ipp_rl_tpu_torch.ros import mission_node, sim_robot
from ipp_rl_tpu_torch.ros.sim_robot import ClosedLoopMission, LoopDraws

from test_torch_experiment import root_logger_restored  # noqa: F401 (an autouse fixture)
from test_torch_greedy import jax_run_draws
from test_torch_world import _as_raw, port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

F64 = torch.float64
RTOL = 1e-10  # summation order only (see the module docstring)


def node_cfg():
    """tests/test_mission_node.py's config, as a raw dict."""
    return {
        "environment": {"x_dim": 6, "y_dim": 6, "resolution": 4},
        "experiment": {
            "title": "node",
            "constraints": {"min_altitude": 8, "max_altitude": 14, "altitude_spacing": 6,
                            "budget": 40},
            "scenario": {"adaptive": True, "value_threshold": 0.4, "interval_factor": 0},
            "uav": {"max_v": 2, "max_a": 2, "sampling_time": 2},
            "missions": [{"type": "greedy"}],
        },
    }


def to_float64(jax_obj, port_obj, jcfg, pcfg, mission):
    """Both sides' world and planner rebuilt in float64 (the JAX package
    builds them in float32)."""
    jax_obj.world = JaxWorld(jcfg, dtype=jnp.float64)
    jax_obj.planner = jax_create_planner(jax_obj.world, JaxMissionConfig(type=mission))
    port_obj.world = IPPWorld(pcfg, dtype=F64, device="cpu")
    port_obj.planner = create_planner(port_obj.world, MissionConfig(type=mission))


# ------------------------------------------------------------ mission node

@pytest.fixture(scope="module")
def node_messages():
    from ipp_rl_tpu.config.schema import config_from_dict as jax_config_from_dict

    jcfg = jax_config_from_dict(node_cfg())
    pcfg = port_cfg(jcfg)
    jnode, node = JaxNode(jcfg), IPPMissionNode(pcfg, device="cpu")
    to_float64(jnode, node, jcfg, pcfg, "greedy")
    steps = 5
    want = jnode.build_message(max_steps=steps)
    state0, noise = jax_run_draws(jnode.world, jax.random.key(jnode.seed), 1, steps)
    got = node.build_message(
        max_steps=steps,
        init_state=belief_state_from_arrays(state0, device="cpu", dtype=F64),
        noise=noise_from_arrays(noise, device="cpu", dtype=F64),
    )
    return want, got, node


def test_mission_node_message_equals_jax(node_messages):
    want, got, _ = node_messages
    assert len(got.points) >= 2
    assert got.points == want.points
    assert got.sampled_trajectory is not None
    assert got.sampled_trajectory == want.sampled_trajectory
    assert (got.max_v, got.max_a, got.sampling_time) == (want.max_v, want.max_a,
                                                         want.sampling_time)
    assert got.to_json() == want.to_json()
    np.testing.assert_allclose(got.sampled_trajectory[0], got.points[0], atol=1e-5)


def test_mission_node_json_round_trips(node_messages, tmp_path):
    _, _, node = node_messages
    out = tmp_path / "waypoints.json"
    msg = node.run(output_path=str(out), max_steps=5)
    assert msg.max_v == 2 and msg.max_a == 2 and msg.sampling_time == 2
    assert len(msg.points) >= 2 and msg.sampled_trajectory is not None
    payload = json.loads(out.read_text())
    assert payload["points"] == msg.points
    assert payload["sampled_trajectory"] == msg.sampled_trajectory
    assert WaypointsTrajectory(**payload) == msg


def test_run_ros_without_rospy_raises(node_messages, monkeypatch):
    _, _, node = node_messages
    monkeypatch.setitem(__import__("sys").modules, "rospy", None)
    with pytest.raises(RuntimeError, match="rospy not available"):
        node.run_ros()


# ------------------------------------------------------------ closed loop

def jax_loop_draws(jworld, seed, cycles, tracking):
    """The initial state and each cycle's draws of the JAX package's
    ``ClosedLoopMission.run``: its key chain walked for ``cycles`` cycles
    (draws of cycles the loop never reaches go unused)."""
    key = jax.random.key(seed)
    k_init, key = jax.random.split(key)
    state0 = jworld.init_state(k_init, 1)
    M, M_cont = jworld.H.shape[1], jworld.m_max_cont
    plan_noise, measure_noise = [], []
    for _ in range(cycles):
        key, k_plan = jax.random.split(key)
        _, k_run = jax.random.split(k_plan)  # Planner.run(k_plan, 1, max_steps=1)
        (k_step,) = jax.random.split(k_run, 1)
        _, k_meas = jax.random.split(k_step)
        (kb,) = jax.random.split(k_meas, 1)  # step_index: one key per mission
        plan_noise.append(np.asarray(jax.random.normal(kb, (M,), jworld.dtype))[None, None])
        if tracking:
            key, k_meas = jax.random.split(key)
            (kb,) = jax.random.split(k_meas, 1)  # step_position
            measure_noise.append(np.asarray(jax.random.normal(kb, (M_cont,), jworld.dtype))[None])
    return LoopDraws(
        init_state=belief_state_from_arrays(state0, device="cpu", dtype=F64),
        plan_noise=[torch.tensor(n) for n in plan_noise],
        measure_noise=[torch.tensor(n) for n in measure_noise],
    )


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["exact_tracking", "tracking_noise"])
def loops(request, small_cfg):
    std, cycles = request.param, 5
    pcfg = port_cfg(small_cfg)
    jloop = JaxLoop(small_cfg, JaxMissionConfig(type="greedy"), seed=3, tracking_noise_std=std)
    loop = ClosedLoopMission(pcfg, MissionConfig(type="greedy"), seed=3,
                             tracking_noise_std=std, device="cpu")
    to_float64(jloop, loop, small_cfg, pcfg, "greedy")
    want = jloop.run(max_cycles=cycles)
    got = loop.run(max_cycles=cycles, draws=jax_loop_draws(jloop.world, 3, cycles, std > 0))
    return std, want, got


def test_closed_loop_flight_log_equals_jax(loops):
    _, want, got = loops
    assert len(got.waypoints) == len(want.waypoints) >= 3
    assert got.waypoints == want.waypoints
    assert got.poses == want.poses
    assert got.trajectories == want.trajectories
    for name in ("budgets", "uncertainty", "rmse"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=RTOL, atol=0)


def test_closed_loop_properties(loops):
    """tests/test_mission_node.py's own properties, on the port's log."""
    std, _, log = loops
    assert len(log.waypoints) >= 3
    assert log.uncertainty[-1] < log.uncertainty[0]
    assert log.budgets[-1] < log.budgets[0]
    if std == 0:
        for wp, traj in zip(log.waypoints, log.trajectories):
            traj = np.asarray(traj)
            assert traj.shape[0] >= 2 and traj.shape[1] == 3
            np.testing.assert_allclose(traj[-1], wp, atol=0.3)
        assert log.poses == log.waypoints
    else:
        errs = [float(np.linalg.norm(np.asarray(p) - np.asarray(w)))
                for p, w in zip(log.poses, log.waypoints)]
        assert max(errs) > 0.05
        assert log.uncertainty[-1] < 0.7 * log.uncertainty[0]
    assert "uncertainty" in log.to_json()
    assert json.loads(log.to_json())["poses"] == log.poses


def test_closed_loop_generator_runs_repeat(small_cfg):
    """Without injected draws the loop draws from its seed: two runs of one
    seed give the same log."""
    pcfg = port_cfg(small_cfg)
    logs = [ClosedLoopMission(pcfg, MissionConfig(type="greedy"), seed=5, tracking_noise_std=0.5,
                              device="cpu").run(max_cycles=3) for _ in range(2)]
    assert logs[0].to_json() == logs[1].to_json()
    assert len(logs[0].waypoints) == 3


# ------------------------------------------------------------ the two CLIs

@pytest.mark.parametrize("cli", ["mission_node", "sim_robot"])
def test_cli_main_on_the_cpu_writes_json(cli, small_cfg, tmp_path, monkeypatch):
    config = tmp_path / "small.yaml"
    config.write_text(yaml.safe_dump(_as_raw(small_cfg)))
    out = tmp_path / f"{cli}.json"
    monkeypatch.setenv("CONFIG_FILE_PATH", str(config))
    monkeypatch.setenv("LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("PLAN_OUTPUT", str(out))
    monkeypatch.setenv("FLIGHT_LOG_OUTPUT", str(out))
    monkeypatch.setenv("MAX_CYCLES", "2")
    monkeypatch.setenv("TRACKING_NOISE_STD", "0.5")
    module = mission_node if cli == "mission_node" else sim_robot
    assert module.main(["--device", "cpu"]) == 0
    payload = json.loads(out.read_text())
    if cli == "mission_node":
        assert len(payload["points"]) >= 2 and payload["sampled_trajectory"]
    else:
        assert len(payload["waypoints"]) == 2 and len(payload["uncertainty"]) == 3


@pytest.mark.parametrize("cli", ["mission_node", "sim_robot"])
def test_cli_main_without_a_card_exits_nonzero(cli, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    module = mission_node if cli == "mission_node" else sim_robot
    assert module.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
