"""The port's experiment runner and entry points
(ipp_rl_tpu_torch/experiments/experiment.py, ipp_rl_tpu_torch/main.py,
ipp_rl_tpu_torch/tools/train_zero.py, ipp_rl_tpu_torch/utils) on the CPU:
``create_planner`` over all eight mission types (the mcts_zero branch
loading a checkpoint the port wrote, or refusing to train), the KPI table
and the interpolated curves on the JAX package's own mission results
(exactly equal to JAX's), tests/test_experiment.py's three cases through
the port, ``main`` with all eight missions, and ``train_zero`` at a tiny
size."""

import dataclasses
import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from ipp_rl_tpu.experiments import Experiment as JaxExperiment
from ipp_rl_tpu_torch import main as port_main
from ipp_rl_tpu_torch.config import MCTSZeroHyperParams, MissionConfig, config_from_dict
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.experiments import Experiment, create_planner
from ipp_rl_tpu_torch.experiments import experiment as expmod
from ipp_rl_tpu_torch.planners import MissionResult
from ipp_rl_tpu_torch.planners.zero.learn import save_checkpoint
from ipp_rl_tpu_torch.planners.zero.mission import ZeroPlanner
from ipp_rl_tpu_torch.planners.zero.train import init_train_state
from ipp_rl_tpu_torch.tools import train_zero
from ipp_rl_tpu_torch.utils import AverageMeter, dotdict, setup_logger

from test_experiment import experiment_cfg  # noqa: F401 (a fixture)
from test_torch_world import _as_raw, port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

# a small network for the mcts_zero mission (6x6 planes)
ZERO_HP = dict(num_mcts_simulations=4, num_channels=8, num_encoder_res_blocks=1,
               num_global_pooling_channels=4, input_history_length=2,
               max_valid_action_distance=11.5)
EIGHT = [  # the eight mission types, each with small knobs
    {"type": "mcts_zero", "color": "green", "episode_horizon": 3, "hyper_params": ZERO_HP},
    {"type": "greedy", "color": "blue"},
    {"type": "random_discrete", "color": "red"},
    {"type": "lawnmower", "color": "orange", "step_size": 6},
    {"type": "spiral", "color": "black", "num_waypoints": 20},
    {"type": "random_continuous", "color": "gray"},
    {"type": "mcts", "color": "cyan", "num_simulations": 6, "episode_horizon": 3,
     "c": 2.0, "k": 4.0, "alpha": 0.75, "max_greedy_radius": 10.0},
    {"type": "cmaes", "color": "purple", "episode_horizon": 2, "cma_popsize": 4,
     "cma_maxiter": 2},
]
CLASSES = {"mcts_zero": "ZeroPlanner", "greedy": "GreedyPlanner",
           "random_discrete": "RandomDiscretePlanner", "lawnmower": "LawnmowerPlanner",
           "spiral": "SpiralPlanner", "random_continuous": "RandomContinuousPlanner",
           "mcts": "ClassicMCTSPlanner", "cmaes": "CMAESPlanner"}


@pytest.fixture(autouse=True)
def root_logger_restored():
    """``setup_logger`` (main, train_zero) replaces the root logger's
    handlers; put the test runner's back and close the new ones."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)


def eight_mission_raw(jcfg):
    """The raw (YAML) form of ``jcfg`` with the eight missions."""
    raw = json.loads(json.dumps(_as_raw(jcfg)))  # tuples to lists, for YAML
    raw["experiment"]["missions"] = EIGHT
    return raw


def write_checkpoint(cfg, directory, hp=ZERO_HP):
    """A checkpoint of a seeded small network, as the port writes it; returns
    its variables."""
    _, state = init_train_state(cfg, MCTSZeroHyperParams(**hp), torch.Generator().manual_seed(4),
                                device="cpu")
    save_checkpoint(os.path.join(directory, "shared_net.trained_model.ckpt"), state)
    return state.variables()


def test_create_planner_covers_every_mission_type(experiment_cfg, tmp_path):  # noqa: F811
    cfg = config_from_dict(eight_mission_raw(experiment_cfg))
    world = IPPWorld(cfg, device="cpu")
    saved = write_checkpoint(cfg, str(tmp_path))
    for mc in cfg.missions:
        planner = create_planner(world, mc, str(tmp_path))
        assert type(planner).__name__ == CLASSES[mc.type]
        assert type(planner).__module__.startswith("ipp_rl_tpu_torch.")
    zero = create_planner(world, cfg.missions[0], str(tmp_path))
    assert isinstance(zero, ZeroPlanner) and set(zero.variables) == set(saved)
    assert all(torch.equal(zero.variables[k], saved[k]) for k in saved)
    with pytest.raises(ValueError, match="Unknown mission type"):
        create_planner(world, MissionConfig(type="nope"))


def test_mcts_zero_refuses_implicit_training(experiment_cfg, tmp_path, monkeypatch):  # noqa: F811
    cfg = config_from_dict(eight_mission_raw(experiment_cfg))
    world = IPPWorld(cfg, device="cpu")
    monkeypatch.setenv("IPP_ALLOW_IMPLICIT_TRAINING", "0")
    with pytest.raises(FileNotFoundError, match="implicit training disabled"):
        create_planner(world, cfg.missions[0], str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def jax_experiment(experiment_cfg, tmp_path_factory):  # noqa: F811
    exp = JaxExperiment(experiment_cfg, results_dir=str(tmp_path_factory.mktemp("jax")), seed=1)
    exp.run(max_steps=6)
    return exp


def port_experiment_holding(jexp, tmp_path):
    """A port Experiment whose results are the JAX run's own arrays."""
    exp = Experiment(port_cfg(jexp.cfg), results_dir=str(tmp_path), seed=1, device="cpu")
    for name, res in jexp.results.items():
        exp.results[name] = MissionResult(
            waypoints=np.asarray(res.waypoints), budgets=np.asarray(res.budgets),
            metrics={k: np.asarray(v) for k, v in res.metrics.items()},
            num_steps=np.asarray(res.num_steps), flight_times=np.asarray(res.flight_times))
    exp.run_times = dict(jexp.run_times)
    return exp


def test_kpis_and_curves_equal_jax(jax_experiment, tmp_path):
    exp = port_experiment_holding(jax_experiment, tmp_path)
    assert exp.kpi_table() == jax_experiment.kpi_table()
    for metric in ("uncertainty", "rmse"):
        want = jax_experiment.interpolated_curves(metric)
        got = exp.interpolated_curves(metric)
        assert set(got) == set(want)
        for name in want:
            for k in ("axis", "mean", "sd"):
                np.testing.assert_array_equal(got[name][k], want[name][k])


def test_experiment_run_eval_save(experiment_cfg, tmp_path):  # noqa: F811
    exp = Experiment(port_cfg(experiment_cfg), results_dir=str(tmp_path), seed=1, device="cpu")
    results = exp.run(max_steps=6)
    assert set(results) == {"greedy_standard", "random_discrete_standard", "lawnmower_standard"}
    # identical starting worlds: step-0 metrics equal across planners
    m0 = [r.metrics["rmse"][:, 0] for r in results.values()]
    np.testing.assert_array_equal(m0[0], m0[1])
    np.testing.assert_array_equal(m0[0], m0[2])
    kpis = exp.evaluate(make_plots=True)
    assert "rmse@50" in kpis["greedy_standard"]
    assert (kpis["greedy_standard"]["final_uncertainty"]
            <= kpis["random_discrete_standard"]["final_uncertainty"])
    out = exp.save()
    for f in ("experiment.pkl", "kpis.json", "plots/rmse.png", "plots/paths_3d.png",
              "plots/run_stats.png"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "experiment.pkl"), "rb") as f:
        payload = pickle.load(f)
    np.testing.assert_array_equal(payload["results"]["greedy_standard"]["waypoints"],
                                  results["greedy_standard"].waypoints)
    # the same seed gives the same run
    again = Experiment(port_cfg(experiment_cfg), results_dir=str(tmp_path), seed=1,
                       device="cpu").run(max_steps=6)
    for name in results:
        np.testing.assert_array_equal(again[name].waypoints, results[name].waypoints)


def test_interpolated_curves(experiment_cfg, tmp_path):  # noqa: F811
    exp = Experiment(port_cfg(experiment_cfg), results_dir=str(tmp_path), seed=2, device="cpu")
    exp.run(max_steps=5)
    curves = exp.interpolated_curves("uncertainty")
    for c in curves.values():
        assert c["axis"].shape == (100,)
        assert np.all(np.diff(c["axis"]) >= 0)
        assert c["mean"][-1] < c["mean"][0]


def test_effective_mission_time_shrinks_budget(experiment_cfg, tmp_path,  # noqa: F811
                                               monkeypatch):
    """With evaluation.use_effective_mission_time, the measured per-replan
    latency is charged against the budget each step (reference
    planning/greedy_mission.py:105-106)."""
    cfg = port_cfg(experiment_cfg)
    cfg = dataclasses.replace(
        cfg, missions=(cfg.missions[0],),
        evaluation=dataclasses.replace(cfg.evaluation, use_effective_mission_time=True))
    monkeypatch.setattr(expmod, "measure_replan_latency", lambda *a, **k: 3.0)
    res = Experiment(cfg, results_dir=str(tmp_path), seed=3,
                     device="cpu").run(max_steps=8)["greedy_standard"]
    cfg_off = dataclasses.replace(
        cfg, evaluation=dataclasses.replace(cfg.evaluation, use_effective_mission_time=False))
    res_off = Experiment(cfg_off, results_dir=str(tmp_path), seed=3,
                         device="cpu").run(max_steps=8)["greedy_standard"]
    assert (res.num_steps.sum() < res_off.num_steps.sum()
            or res.budgets[:, -1].mean() < res_off.budgets[:, -1].mean())
    spent = res.budgets[:, 0] - res.budgets[:, -1]
    np.testing.assert_allclose(spent, res.flight_times.sum(axis=1) + 3.0 * res.num_steps,
                               rtol=1e-5)


def test_measure_replan_latency_times_a_replan(experiment_cfg):  # noqa: F811
    cfg = port_cfg(experiment_cfg)
    world = IPPWorld(cfg, device="cpu")
    planner = create_planner(world, cfg.missions[0])
    state = world.init_state(2, torch.Generator().manual_seed(0))
    seconds = expmod.measure_replan_latency(planner, state, torch.Generator().manual_seed(1))
    assert 0.0 < seconds < 60.0


def test_main_runs_all_eight_missions_on_the_cpu(experiment_cfg, tmp_path,  # noqa: F811
                                                 monkeypatch):
    """The port's entry point with all eight mission types, the mcts_zero
    one from a checkpoint the port wrote, implicit training refused."""
    raw = eight_mission_raw(experiment_cfg)
    config = tmp_path / "eight.yaml"
    config.write_text(yaml.safe_dump(raw))
    write_checkpoint(config_from_dict(raw), str(tmp_path / "ckpt"))
    monkeypatch.setenv("IPP_ALLOW_IMPLICIT_TRAINING", "0")
    rc = port_main.main(["--config", str(config), "--batch", "2", "--max-steps", "3",
                         "--results", str(tmp_path / "results"),
                         "--checkpoints", str(tmp_path / "ckpt"), "--logs", str(tmp_path / "logs"),
                         "--device", "cpu"])
    assert rc == 0
    (out,) = (tmp_path / "results").iterdir()
    kpis = json.loads((out / "kpis.json").read_text())
    assert sorted(kpis) == sorted(f"{m['type']}_standard" for m in EIGHT)
    with open(out / "experiment.pkl", "rb") as f:
        results = pickle.load(f)["results"]
    assert sorted(results) == sorted(kpis)
    for res in results.values():  # every mission measured, and learned
        unc = res["metrics"]["uncertainty"]
        assert (res["num_steps"] > 0).all() and (unc[:, -1] < unc[:, 0]).all()
    assert (out / "plots" / "uncertainty.png").exists()
    kinds = [json.loads(line)["kind"]
             for line in (tmp_path / "logs" / "notifications.jsonl").read_text().splitlines()]
    assert kinds == ["started", "finished"]


def test_train_zero_runs_on_the_cpu(tmp_path):
    out = tmp_path / "run"
    rc = train_zero.main(["--iterations", "1", "--envs", "2", "--sims", "2", "--channels", "8",
                          "--blocks", "1", "--max-episode-steps", "2", "--batch-size", "4",
                          "--epochs", "1", "--eval-batch", "2", "--eval-steps", "2",
                          "--out", str(out), "--device", "cpu"])
    assert rc == 0
    ev = json.loads((out / "eval.json").read_text())
    assert list(ev) == ["mcts_zero", "greedy", "random"]
    for row in ev.values():
        assert np.isfinite(row["final_uncertainty"]) and len(row["uncertainty_curve"]) == 3
    assert (out / "checkpoints" / "shared_net.trained_model.ckpt").exists()
    assert (out / "logs" / "train_metrics.jsonl").exists()


def test_utils(tmp_path):
    root = setup_logger(str(tmp_path / "logs"), level=logging.WARNING)
    (log_file,) = (tmp_path / "logs").iterdir()
    logging.getLogger("ipp_rl_tpu_torch.test").debug("to the file only")
    for h in root.handlers:
        h.flush()
    assert "to the file only" in log_file.read_text()
    assert [type(h).__name__ for h in root.handlers] == ["StreamHandler", "FileHandler"]
    meter = AverageMeter()
    assert meter.avg == 0.0
    meter.update(2.0)
    meter.update(5.0, n=3)
    assert (meter.val, meter.sum, meter.count, meter.avg) == (5.0, 17.0, 4, 4.25)
    assert repr(meter) == "4.2500 (n=4)"
    d = dotdict(a=1)
    d.b = 2
    assert (d.a, d["b"], d.missing) == (1, 2, None)
    del d.a
    assert dict(d) == {"b": 2}
