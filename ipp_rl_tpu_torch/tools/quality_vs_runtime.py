"""Quality versus runtime of the deployment planners on matched held-out
worlds: the counterpart of the repository's ``scripts/quality_vs_runtime.py``
(the reference paper's result: on-par quality at a fraction of the
runtime, arXiv 2109.13570 Fig. 4/5).

Usage: python -m ipp_rl_tpu_torch.tools.quality_vs_runtime --ckpt PATH
    [--channels 64] [--blocks 6] [--batch 32] [--max-steps 45]
    [--zero-sims 0,16,32,100,32c,100c] [--puct-init 4.0]
    [--unfloored-value-head] [--dirichlet-alpha 0.3] [--out DIR]
    [--device cuda|cpu] [--seed 7] [--rows NAME,...] [--worlds NPZ]

Every planner runs whole budget-200 missions (the canonical example.yaml,
``fast_sweeps=True``, float32, TF32 off) from the same initial beliefs:
greedy; classic MCTS (32 simulations, horizon 5, spacing 14); CMA-ES (λ
12, 20 generations, σ 2, horizon 5); random discrete; and MCTS-zero with
the checkpoint at each ``--zero-sims`` entry (a trailing ``c`` is the
clean deploy mode: no forced playouts, no root noise).  Each row's draws
come from a generator seeded with ``--seed``.  The worlds are the port's
own from seed 12345, or ``--worlds``: an npz of a ``BeliefState``'s arrays
(``mean``, ``cov``, ``pos``, ``budget``, ``ground_truth``, ``active``,
``step``; runs/quality_torch/worlds_s12345_b32.npz holds the JAX
package's), or of ``ground_truth`` alone, whose priors the world builds.

Writes ``<out>/curve.json`` and ``<out>/curve.md``: per planner the mean
final masked tr(P) and RMSE, the mean steps, ms per mission-replan (wall
/ steps / B, host clock around a synchronised run), the wall seconds, and
each mission's final tr(P), RMSE and steps; with the card's name and
power limit.  On the card each planner first runs one step (cuDNN's and
the allocator's warm-up), untimed; nothing is compiled.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, MCTSZeroHyperParams, MissionConfig, load_config
from ipp_rl_tpu_torch.convert import belief_state_from_arrays
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.planners import (
    ClassicMCTSPlanner,
    CMAESPlanner,
    GreedyPlanner,
    Planner,
    RandomDiscretePlanner,
)

WORLD_SEED = 12345
#: the settings of the committed JAX reference (runs/quality_torch/
#: jax_reference.json, written by ``python tests/test_torch_quality.py
#: --write-reference``) and of chip_smoke.py's quality phase, which holds
#: the port to it on the same worlds; classic MCTS cut to 8 simulations
REFERENCE_SETTINGS = {
    "config": "example.yaml", "fast_sweeps": True, "dtype": "float32",
    "batch": 32, "max_steps": 45, "world_seed": WORLD_SEED, "run_seed": 7,
    "ckpt": "runs/zero_canon_r5_best/checkpoints/shared_net.trained_model.ckpt",
    "channels": 64, "blocks": 6, "puct_init": 4.0, "unfloored_value_head": True,
    "dirichlet_alpha": 0.3, "zero_sims": "0,16c", "classic_sims": 8,
    "rows": ["greedy", "random", "cmaes", "zero_0sims", "zero_16sims_clean", "mcts_classic"],
}
#: the row fields of the JAX script's curve.json
JAX_ROW_KEYS = ("planner", "final_uncertainty", "final_rmse", "mean_steps", "ms_per_replan",
                "wall_s", "batch")


@dataclasses.dataclass
class Settings:
    """What a curve is computed with: the command line's flags, and classic
    MCTS's simulations (the JAX script's 32; the reference cuts them)."""

    ckpt: Optional[str] = None
    channels: int = 64
    blocks: int = 6
    batch: int = 32
    max_steps: int = 45
    zero_sims: str = "0,16,32,100,32c,100c"
    puct_init: float = 4.0
    unfloored_value_head: bool = False
    dirichlet_alpha: float = 0.3
    classic_sims: int = 32
    seed: int = 7
    rows: Optional[List[str]] = None  # None: every row

    @classmethod
    def from_reference(cls, ref: dict, root: str = ".") -> "Settings":
        """The settings of a reference's ``settings`` mapping
        (:data:`REFERENCE_SETTINGS`), the checkpoint under ``root``."""
        return cls(ckpt=os.path.join(root, ref["ckpt"]), channels=ref["channels"],
                   blocks=ref["blocks"], batch=ref["batch"], max_steps=ref["max_steps"],
                   zero_sims=ref["zero_sims"], puct_init=ref["puct_init"],
                   unfloored_value_head=ref["unfloored_value_head"],
                   dirichlet_alpha=ref["dirichlet_alpha"], classic_sims=ref["classic_sims"],
                   seed=ref["run_seed"], rows=list(ref["rows"]))


def zero_row(spec: str) -> tuple:
    """(row name, simulations, clean) of a ``--zero-sims`` entry."""
    clean = spec.endswith("c")
    sims = int(spec[:-1] if clean else spec)
    return f"zero_{sims}sims" + ("_clean" if clean else ""), sims, clean


def row_names(settings: Settings) -> List[str]:
    """The rows in the JAX script's order, or those of ``settings.rows``."""
    every = [zero_row(s)[0] for s in settings.zero_sims.split(",")]
    every += ["greedy", "mcts_classic", "cmaes", "random"]
    if settings.rows is None:
        return every
    unknown = [r for r in settings.rows if r not in every]
    if unknown:
        raise ValueError(f"unknown rows {unknown}; this run has {every}")
    return list(settings.rows)


def zero_hyper_params(channels: int, blocks: int, puct_init: float, dirichlet_alpha: float,
                      unfloored_value_head: bool, **changes) -> MCTSZeroHyperParams:
    """The deployed network's hyper-parameters, as the JAX scripts set them."""
    return MCTSZeroHyperParams(
        num_channels=channels,
        num_encoder_res_blocks=blocks,
        num_global_pooling_channels=min(32, channels // 2),
        max_valid_action_distance=11.5,
        puct_init=puct_init,
        dirichlet_alpha=dirichlet_alpha,
        unfloored_value_head=unfloored_value_head,
        **changes,
    )


def load_network(world: IPPWorld, hp: MCTSZeroHyperParams, ckpt: str) -> tuple:
    """(predict, variables) of the checkpoint at ``ckpt`` (flax format, read
    by the port's own reader) for a network of ``hp``."""
    from ipp_rl_tpu_torch.planners.zero.learn import load_checkpoint
    from ipp_rl_tpu_torch.planners.zero.train import init_train_state, predict_fn

    gen = torch.Generator(device=world.device).manual_seed(0)
    net, state = init_train_state(world.cfg, hp, gen, world.device, world.dtype)
    state = load_checkpoint(ckpt, state)
    return predict_fn(net), state.variables()


def build_planners(world: IPPWorld, settings: Settings) -> Dict[str, Planner]:
    """The planners of the run's rows, with the JAX script's settings."""
    from ipp_rl_tpu_torch.planners.zero.mission import ZeroPlanner

    names = row_names(settings)
    hp = zero_hyper_params(settings.channels, settings.blocks, settings.puct_init,
                           settings.dirichlet_alpha, settings.unfloored_value_head)
    zero = {zero_row(s)[0]: zero_row(s) for s in settings.zero_sims.split(",")}
    network = None
    planners: Dict[str, Planner] = {}
    for name in names:
        if name in zero:
            if network is None:
                if not settings.ckpt:
                    raise ValueError("the zero rows need --ckpt")
                network = load_network(world, hp, settings.ckpt)
            _, sims, clean = zero[name]
            mc = MissionConfig(type="mcts_zero", episode_horizon=5,
                               hyper_params=dataclasses.replace(hp, num_mcts_simulations=sims))
            planners[name] = ZeroPlanner(world, mc, *network,
                                         deploy_mode="clean" if clean else "reference")
        elif name == "greedy":
            planners[name] = GreedyPlanner(world, MissionConfig(type="greedy"))
        elif name == "mcts_classic":
            planners[name] = ClassicMCTSPlanner(world, MissionConfig(
                type="mcts", num_simulations=settings.classic_sims, episode_horizon=5,
                horizontal_spacing=14.0))
        elif name == "cmaes":
            planners[name] = CMAESPlanner(world, MissionConfig(
                type="cmaes", episode_horizon=5, cma_popsize=12, cma_maxiter=20,
                cma_sigma=2.0))
        else:
            planners[name] = RandomDiscretePlanner(world, MissionConfig(type="random_discrete"))
    return planners


def load_worlds(path: str, world: IPPWorld, batch: int) -> BeliefState:
    """The first ``batch`` missions of an npz of a ``BeliefState``'s arrays
    (or of ``ground_truth`` alone, with the world's own priors)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    n = arrays["ground_truth"].shape[0]
    if batch > n:
        raise ValueError(f"{path} holds {n} missions, {batch} asked for")
    arrays = {k: v[:batch] for k, v in arrays.items()}
    if set(arrays) == {"ground_truth"}:
        return world.init_state(batch, ground_truth=torch.as_tensor(arrays["ground_truth"]))
    return belief_state_from_arrays(arrays, device=world.device, dtype=world.dtype)


def initial_state(world: IPPWorld, batch: int, worlds: Optional[str],
                  seed: int = WORLD_SEED) -> BeliefState:
    """The worlds file's first ``batch`` missions, or the port's own worlds
    drawn from ``seed``."""
    if worlds:
        return load_worlds(worlds, world, batch)
    return world.init_state(batch, torch.Generator(device=world.device).manual_seed(seed))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_row(name: str, planner: Planner, init_state: BeliefState, max_steps: int, seed: int,
            noise: Optional[torch.Tensor] = None, warmup: bool = False) -> dict:
    """One planner's missions from ``init_state`` with draws from a
    generator seeded ``seed`` (the measurement noise from ``noise`` (T, B,
    M) where given): the JAX script's row fields and each mission's finals
    (and the run's ``result``).  ``warmup`` runs one untimed step first."""
    device = init_state.mean.device
    B = init_state.batch_size

    def generator():
        return torch.Generator(device=device).manual_seed(seed)

    if warmup:
        planner.run(B, max_steps=1, init_state=init_state, generator=generator())
    _sync(device)
    t0 = time.perf_counter()
    res = planner.run(B, max_steps=max_steps, init_state=init_state, generator=generator(),
                      noise=noise)
    _sync(device)
    wall = time.perf_counter() - t0
    unc = np.asarray(res.metrics["uncertainty"][:, -1], dtype=np.float64)
    rmse = np.asarray(res.metrics["rmse"][:, -1], dtype=np.float64)
    steps = float(np.maximum(res.num_steps.mean(), 1.0))
    return {
        "planner": name,
        "final_uncertainty": round(float(unc.mean()), 3),
        "final_rmse": round(float(rmse.mean()), 4),
        "mean_steps": round(steps, 1),
        "ms_per_replan": round(wall / steps / B * 1e3, 3),
        "wall_s": round(wall, 1),
        "batch": B,
        "per_mission": {"final_uncertainty": unc.tolist(), "final_rmse": rmse.tolist(),
                        "steps": res.num_steps.astype(int).tolist()},
        "result": res,
    }


def evaluate(world: IPPWorld, settings: Settings, init_state: BeliefState,
             noise: Optional[torch.Tensor] = None, warmup: Optional[bool] = None,
             log=print) -> List[dict]:
    """Every row of ``settings`` on ``init_state``: :func:`run_row` per
    planner, in order (the warm-up step on the card unless told)."""
    if warmup is None:
        warmup = world.device.type == "cuda"
    rows = []
    for name, planner in build_planners(world, settings).items():
        row = run_row(name, planner, init_state, settings.max_steps, settings.seed, noise,
                      warmup)
        rows.append(row)
        if log is not None:
            log({k: row[k] for k in JAX_ROW_KEYS})
    return rows


def card() -> Optional[dict]:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    name, _, limit = out.rpartition(",")
    return {"nvidia_smi": out, "name": name.strip(), "power_limit": limit.strip()}


def write_curve(out: str, config: dict, rows: Sequence[dict], device: torch.device,
                worlds: Optional[str]) -> None:
    os.makedirs(out, exist_ok=True)
    where = {"device": str(device)}
    if device.type == "cuda":
        where.update(kind=torch.cuda.get_device_name(device), card=card())
    saved = [{k: v for k, v in r.items() if k != "result"} for r in rows]
    with open(os.path.join(out, "curve.json"), "w") as f:
        json.dump({"config": config, "device": where, "rows": saved}, f, indent=2)
    B = rows[0]["batch"] if rows else 0
    origin = worlds or f"the port's own, seed {WORLD_SEED}"
    on = (f"{where['card']['nvidia_smi']}" if where.get("card") else str(device))
    with open(os.path.join(out, "curve.md"), "w") as f:
        f.write(
            "# Quality vs runtime — deployment planners, budget 200 adaptive\n\n"
            f"Matched held-out worlds ({origin}), B={B} missions, canonical 10x10 workload, "
            f"on {on}. ms/replan is per mission at this batch (batched deployment), "
            "host clock around a synchronised run.\n\n"
            "| planner | final masked tr(P) | final RMSE | mean steps | ms/replan |\n"
            "|---|---|---|---|---|\n"
        )
        for r in rows:
            f.write(f"| {r['planner']} | {r['final_uncertainty']} | {r['final_rmse']} | "
                    f"{r['mean_steps']} | {r['ms_per_replan']} |\n")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ipp_rl_tpu_torch.tools.quality_vs_runtime")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max-steps", type=int, default=45)
    ap.add_argument("--zero-sims", default="0,16,32,100,32c,100c",
                    help="comma list; trailing 'c' = clean deploy mode (no forced playouts / "
                         "root noise)")
    ap.add_argument("--puct-init", type=float, default=4.0)
    ap.add_argument("--unfloored-value-head", action="store_true")
    ap.add_argument("--dirichlet-alpha", type=float, default=0.3)
    ap.add_argument("--out", default="runs/quality_vs_runtime_torch")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=7, help="seed of each row's draws")
    ap.add_argument("--rows", default=None, help="comma list of rows (default: all)")
    ap.add_argument("--worlds", default=None,
                    help="npz of the initial beliefs and ground truth (default: the port's "
                         f"own worlds from seed {WORLD_SEED})")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings = Settings(
        ckpt=args.ckpt, channels=args.channels, blocks=args.blocks, batch=args.batch,
        max_steps=args.max_steps, zero_sims=args.zero_sims, puct_init=args.puct_init,
        unfloored_value_head=args.unfloored_value_head, dirichlet_alpha=args.dirichlet_alpha,
        seed=args.seed,
        rows=args.rows.split(",") if args.rows else None,
    )
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), fast_sweeps=True,
                     device=device)
    init_state = initial_state(world, args.batch, args.worlds)
    rows = evaluate(world, settings, init_state)
    write_curve(args.out, vars(args), rows, device, args.worlds)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
