"""Experiment orchestration & evaluation (reference
experiments/experiments.py:37-567, planning/mission_factories.py:19-130).

Port of ``ipp_rl_tpu/experiments/experiment.py``.  ``Experiment.run()``
executes every configured mission type against the SAME batch of
repetition worlds with the SAME run seed (a fresh generator per mission),
so curves are directly comparable.  ``Experiment.evaluate()`` produces
per-metric curves interpolated onto a common flight-time axis with mean ±
sd bands (reference :194-266), KPI tables at 25/50/75% budget (:398-495),
runtime stats, and saves plots + a JSON/pickle results bundle (:559-567).
The analysis is host numpy on the missions' results, as in the JAX
package; matplotlib is imported where a plot is drawn.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config, MissionConfig
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.planners import (
    ClassicMCTSPlanner,
    CMAESPlanner,
    GreedyPlanner,
    LawnmowerPlanner,
    Planner,
    RandomContinuousPlanner,
    RandomDiscretePlanner,
    SpiralPlanner,
)
from ipp_rl_tpu_torch.planners.base import MissionResult

logger = logging.getLogger(__name__)


def create_planner(
    world: IPPWorld,
    mission_cfg: MissionConfig,
    checkpoints_dir: str = "checkpoints",
) -> Planner:
    """Mission factory (reference planning/mission_factories.py:26-130).
    Config validation happened at schema load; this is a pure type switch."""
    t = mission_cfg.type
    if t == "greedy":
        return GreedyPlanner(world, mission_cfg)
    if t == "lawnmower":
        return LawnmowerPlanner(world, mission_cfg)
    if t == "spiral":
        return SpiralPlanner(world, mission_cfg)
    if t == "random_discrete":
        return RandomDiscretePlanner(world, mission_cfg)
    if t == "random_continuous":
        return RandomContinuousPlanner(world, mission_cfg)
    if t == "mcts":
        return ClassicMCTSPlanner(world, mission_cfg)
    if t == "cmaes":
        return CMAESPlanner(world, mission_cfg)
    if t == "mcts_zero":
        from ipp_rl_tpu_torch.planners.zero.learn import ZeroLearner, load_checkpoint
        from ipp_rl_tpu_torch.planners.zero.mission import ZeroPlanner
        from ipp_rl_tpu_torch.planners.zero.train import (
            inference_dtype,
            init_split_train_state,
            init_train_state,
            predict_fn,
            split_predict_fn,
        )

        hp = mission_cfg.hyper_params
        gen = torch.Generator(device=world.device).manual_seed(0)
        if hp.shared_network:
            net, state = init_train_state(world.cfg, hp, gen, world.device, world.dtype)
            pred = predict_fn(net, dtype=inference_dtype(hp))
        else:
            net, state = init_split_train_state(world.cfg, hp, gen, world.device, world.dtype)
            pred = split_predict_fn(net, dtype=inference_dtype(hp))
        ckpt = os.path.join(
            checkpoints_dir, f"shared_net.{mission_cfg.model_deployment_filename}"
        )
        if os.path.exists(ckpt) and not mission_cfg.restart_training:
            state = load_checkpoint(ckpt, state)
            logger.info("loaded mcts_zero checkpoint %s", ckpt)
        else:
            # Reference semantics: train first if no deployment checkpoint
            # exists (reference mcts_zero_mission.py:541-562).  With the
            # canonical 40-iteration config this is a multi-HOUR run that
            # a plain `python -m ipp_rl_tpu_torch.main` would otherwise
            # start silently, so make it unmistakable and refusable.
            logger.warning(
                "no mcts_zero checkpoint at %s — about to TRAIN FROM "
                "SCRATCH (%d self-play iterations; the canonical config "
                "takes hours).  To benchmark a trained agent instead, "
                "point CHECKPOINTS_DIR at a directory containing "
                "shared_net.%s (e.g. runs/zero_canon/checkpoints), or "
                "set IPP_ALLOW_IMPLICIT_TRAINING=0 to make this an error.",
                ckpt, hp.num_self_play_iterations, mission_cfg.model_deployment_filename,
            )
            if os.environ.get("IPP_ALLOW_IMPLICIT_TRAINING", "1") == "0":
                raise FileNotFoundError(
                    f"mcts_zero checkpoint missing: {ckpt} "
                    "(implicit training disabled by IPP_ALLOW_IMPLICIT_TRAINING=0)"
                )
            learner = ZeroLearner(world, mission_cfg, checkpoints_dir=checkpoints_dir)
            learner.learn()
            state = learner.state
        # the predict function takes its weights as an argument, so the
        # template network serves the loaded or trained ones
        return ZeroPlanner(world, mission_cfg, pred, state.variables())
    raise ValueError(f"Unknown mission type '{t}'")


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_replan_latency(
    planner: Planner, init_state: BeliefState, generator: torch.Generator, repeats: int = 3
) -> float:
    """Per-replan-step wall latency [s]: one warm-up plan and commit, then
    ``repeats`` timed ones, each between two device synchronisations; the
    minimum.

    Feeds ``think_time_per_step`` when evaluation.use_effective_mission_time
    is set: the reference measures each step's planning time with
    time.time() and subtracts it from the budget (reference
    planning/greedy_mission.py:105-106, missions.py:199-201); here it is
    measured once per planner, as in the JAX package."""
    world = planner.world

    def one():
        action = planner.plan(init_state, generator, 0)
        return world.step_index(init_state, action, generator=generator)

    one()
    times = []
    for _ in range(repeats):
        _synchronize(world.device)
        t0 = time.perf_counter()
        one()
        _synchronize(world.device)
        times.append(time.perf_counter() - t0)
    return min(times)


class Experiment:
    def __init__(
        self,
        cfg: Config,
        results_dir: str = "results",
        checkpoints_dir: str = "checkpoints",
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.world = IPPWorld(cfg, dtype=dtype, device=device)
        self.seed = seed
        self.results: Dict[str, MissionResult] = {}
        self.run_times: Dict[str, float] = {}
        self.checkpoints_dir = checkpoints_dir
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.out_dir = os.path.join(results_dir, f"{cfg.title}_{stamp}")

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.world.device).manual_seed(seed)

    def run(self, batch_size: Optional[int] = None, max_steps: Optional[int] = None):
        """Execute every mission type on identical repetition worlds: the
        initial batch is drawn once from the seed, and each mission draws
        from a fresh generator with the same run seed (the JAX package
        passes one ``k_run`` to every planner)."""
        B = batch_size or self.cfg.evaluation.repetitions
        gen = self._generator(self.seed)
        init_state = self.world.init_state(B, gen)
        run_seed = int(torch.randint(0, 2**62, (), generator=gen, device=self.world.device))

        for mission_cfg in self.cfg.missions:
            name = f"{mission_cfg.type}_{mission_cfg.config_name}"
            planner = create_planner(self.world, mission_cfg, self.checkpoints_dir)
            logger.info("running mission %s (B=%d)", name, B)
            think = 0.0
            if self.cfg.evaluation.use_effective_mission_time:
                think = measure_replan_latency(planner, init_state,
                                               self._generator(self.seed + 101))
                logger.info("%s: effective mission time, %.4f s/replan", name, think)
            t0 = time.time()
            res = planner.run(
                B, max_steps=max_steps, init_state=init_state,
                think_time_per_step=think, generator=self._generator(run_seed),
            )
            self.run_times[name] = time.time() - t0
            self.results[name] = res
            logger.info(
                "%s: steps %s, final rmse %.4f, wall %.1fs",
                name,
                res.num_steps.tolist(),
                res.metrics["rmse"][:, -1].mean(),
                self.run_times[name],
            )
        return self.results

    # ------------------------------------------------------------- analysis

    def interpolated_curves(
        self, metric: str, num_points: int = 100
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Metric curves vs cumulative flight time, interpolated onto a
        common axis with mean ± sd over repetitions (reference
        experiments.py:227-247)."""
        out = {}
        for name, res in self.results.items():
            curves = res.metrics[metric]  # (B, T+1)
            B = curves.shape[0]
            xs = np.concatenate(
                [np.zeros((B, 1)), np.cumsum(res.flight_times, axis=1)], axis=1
            )
            t_max = min(xs[b, res.num_steps[b]] for b in range(B))
            axis = np.linspace(0.0, max(t_max, 1e-9), num_points)
            interped = np.stack(
                [
                    np.interp(axis, xs[b, : res.num_steps[b] + 1],
                              curves[b, : res.num_steps[b] + 1])
                    for b in range(B)
                ]
            )
            out[name] = {
                "axis": axis,
                "mean": interped.mean(axis=0),
                "sd": interped.std(axis=0),
            }
        return out

    def kpi_table(self) -> Dict[str, Dict[str, float]]:
        """tr(P) and RMSE at 25/50/75% consumed budget + mean steps
        (reference experiments.py:398-495)."""
        table = {}
        budget0 = self.cfg.constraints.budget
        for name, res in self.results.items():
            row: Dict[str, float] = {
                "mean_steps": float(res.num_steps.mean()),
                "wall_time_s": float(self.run_times.get(name, np.nan)),
            }
            consumed = budget0 - res.budgets  # (B, T+1)
            for frac in (0.25, 0.5, 0.75):
                tr_vals, rmse_vals = [], []
                for b in range(res.budgets.shape[0]):
                    t = int(np.searchsorted(consumed[b], frac * budget0))
                    t = min(t, res.num_steps[b])
                    tr_vals.append(res.metrics["uncertainty"][b, t])
                    rmse_vals.append(res.metrics["rmse"][b, t])
                row[f"trP@{int(frac*100)}"] = float(np.mean(tr_vals))
                row[f"rmse@{int(frac*100)}"] = float(np.mean(rmse_vals))
            row["final_rmse"] = float(res.metrics["rmse"][:, -1].mean())
            row["final_uncertainty"] = float(res.metrics["uncertainty"][:, -1].mean())
            table[name] = row
        return table

    def evaluate(self, make_plots: bool = True) -> Dict:
        os.makedirs(self.out_dir, exist_ok=True)
        kpis = self.kpi_table()
        with open(os.path.join(self.out_dir, "kpis.json"), "w") as f:
            json.dump(kpis, f, indent=2)

        metric_names = [
            m
            for m in self.cfg.evaluation.metrics
            if m in next(iter(self.results.values())).metrics
        ]
        if make_plots:
            self._plot_metrics(metric_names)
            self._plot_paths()
            self._plot_run_stats()
        return kpis

    def _plot_run_stats(self):
        """Waypoint-count boxplots + planner wall-time bars (reference
        experiments.py:268-297, 354-396)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plots_dir = os.path.join(self.out_dir, "plots")
        os.makedirs(plots_dir, exist_ok=True)
        names = list(self.results)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
        ax1.boxplot(
            [self.results[n].num_steps for n in names], tick_labels=names
        )
        ax1.set_ylabel("waypoints per mission")
        ax1.tick_params(axis="x", rotation=30)
        ax2.bar(names, [self.run_times.get(n, 0.0) for n in names])
        ax2.set_ylabel("planner wall time [s] (whole batch)")
        ax2.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        fig.savefig(os.path.join(plots_dir, "run_stats.png"), dpi=120)
        plt.close(fig)

    def _plot_metrics(self, metric_names: List[str]):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plots_dir = os.path.join(self.out_dir, "plots")
        os.makedirs(plots_dir, exist_ok=True)
        colors = {m.type: m.color for m in self.cfg.missions}
        for metric in metric_names:
            curves = self.interpolated_curves(metric)
            fig, ax = plt.subplots(figsize=(7, 4.5))
            for name, c in curves.items():
                mtype = name.rsplit("_", 1)[0]
                color = colors.get(mtype)
                ax.plot(c["axis"], c["mean"], label=name, color=color)
                ax.fill_between(
                    c["axis"], c["mean"] - c["sd"], c["mean"] + c["sd"],
                    alpha=0.2, color=color,
                )
            ax.set_xlabel("flight time [s]")
            ax.set_ylabel(metric)
            ax.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(plots_dir, f"{metric}.png"), dpi=120)
            plt.close(fig)

    def _plot_paths(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plots_dir = os.path.join(self.out_dir, "plots")
        os.makedirs(plots_dir, exist_ok=True)
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        for name, res in self.results.items():
            wp = res.waypoints[0]
            ok = ~np.isnan(wp[:, 0])
            ax.plot(wp[ok, 0], wp[ok, 1], wp[ok, 2], marker="x", label=name)
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_zlabel("z [m]")
        ax.legend()
        fig.savefig(os.path.join(plots_dir, "paths_3d.png"), dpi=120)
        plt.close(fig)

    def save(self):
        """Pickle the full results bundle (reference experiments.py:559-567)."""
        os.makedirs(self.out_dir, exist_ok=True)
        payload = {
            "config": self.cfg,
            "results": {
                name: {
                    "waypoints": res.waypoints,
                    "metrics": res.metrics,
                    "budgets": res.budgets,
                    "num_steps": res.num_steps,
                    "flight_times": res.flight_times,
                }
                for name, res in self.results.items()
            },
            "run_times": self.run_times,
        }
        with open(os.path.join(self.out_dir, "experiment.pkl"), "wb") as f:
            pickle.dump(payload, f)
        return self.out_dir
