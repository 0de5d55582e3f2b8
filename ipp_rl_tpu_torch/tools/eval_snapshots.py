"""Deploy-evaluate training snapshots to pick the best checkpoint: the
counterpart of the repository's ``scripts/eval_snapshots.py``.

Self-play learning is not monotonic, so the deployment checkpoint should
be the best snapshot by held-out deploy quality, not the last one.  Each
requested snapshot of ``<run>/checkpoints/`` (``shared_net.snapshot_<k>``,
or ``shared_net.trained_model.ckpt`` for ``deploy``; flax format, read by
the port's own reader) deploys as MCTS-zero on held-out worlds, beside
greedy and random anchors, with the draws of a generator seeded 7 (the
evaluation of tools/quality_vs_runtime.py, ``run_row``).

Usage: python -m ipp_rl_tpu_torch.tools.eval_snapshots --run DIR
    [--snapshots 9,19,29,39|deploy] [--channels 128] [--blocks 10] [--sims 100]
    [--batch 32] [--eval-steps 25] [--puct-init 4.0] [--deploy-mode reference|clean]
    [--world-seed 12345] [--unfloored-value-head] [--device cuda|cpu] [--worlds NPZ]

Writes ``<run>/snapshot_eval_<mode>[_s<seed>].json``: per row the final
uncertainty, final RMSE and wall seconds, as the JAX script does.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, MissionConfig, load_config
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners import GreedyPlanner, RandomDiscretePlanner
from ipp_rl_tpu_torch.planners.zero.mission import ZeroPlanner
from ipp_rl_tpu_torch.tools.quality_vs_runtime import (
    WORLD_SEED,
    initial_state,
    load_network,
    run_row,
    zero_hyper_params,
)

RUN_SEED = 7
#: the keys of each row of the JAX script's output
ROW_KEYS = ("final_uncertainty", "final_rmse", "wall_s")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ipp_rl_tpu_torch.tools.eval_snapshots")
    ap.add_argument("--run", required=True)
    ap.add_argument("--snapshots", default="9,19,29,39")
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval-steps", type=int, default=25)
    ap.add_argument("--puct-init", type=float, default=4.0)
    ap.add_argument("--deploy-mode", default="reference")
    ap.add_argument(
        "--world-seed", type=int, default=WORLD_SEED,
        help="held-out world batch seed; use a DIFFERENT seed for the final report than for "
             "snapshot selection (validation/test split); ignored with --worlds",
    )
    ap.add_argument("--unfloored-value-head", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--worlds", default=None,
                    help="npz of the initial beliefs and ground truth (as "
                         "tools/quality_vs_runtime.py reads it)")
    return ap.parse_args(argv)


def evaluate_snapshots(args: argparse.Namespace, log=print) -> Dict[str, dict]:
    """Every requested snapshot that exists, then greedy and random: the
    full rows of ``quality_vs_runtime.run_row``, by name."""
    device = resolve_device(args.device)
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), fast_sweeps=True,
                     device=device)
    init_state = initial_state(world, args.batch, args.worlds, args.world_seed)
    hp = zero_hyper_params(args.channels, args.blocks, args.puct_init, 0.3,
                           args.unfloored_value_head, num_mcts_simulations=args.sims)
    mc = MissionConfig(type="mcts_zero", episode_horizon=5, hyper_params=hp)
    warmup = device.type == "cuda"
    out = {}

    def evaluate(name, planner):
        out[name] = run_row(name, planner, init_state, args.eval_steps, RUN_SEED, warmup=warmup)
        if log is not None:
            log(name, {k: out[name][k] for k in ROW_KEYS})

    for snap in args.snapshots.split(","):
        name = ("shared_net.trained_model.ckpt" if snap == "deploy"
                else f"shared_net.snapshot_{snap}")
        path = os.path.join(args.run, "checkpoints", name)
        if not os.path.exists(path):
            if log is not None:
                log("missing", path)
            continue
        predict, variables = load_network(world, hp, path)
        evaluate(f"snapshot_{snap}",
                 ZeroPlanner(world, mc, predict, variables, deploy_mode=args.deploy_mode))
    evaluate("greedy", GreedyPlanner(world, MissionConfig(type="greedy")))
    evaluate("random", RandomDiscretePlanner(world, MissionConfig(type="random_discrete")))
    return out


def output_path(args: argparse.Namespace) -> str:
    suffix = "" if args.world_seed == WORLD_SEED else f"_s{args.world_seed}"
    return os.path.join(args.run, f"snapshot_eval_{args.deploy_mode}{suffix}.json")


def main(argv=None) -> int:
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = evaluate_snapshots(args)
    with open(output_path(args), "w") as f:
        json.dump({name: {k: row[k] for k in ROW_KEYS} for name, row in rows.items()}, f,
                  indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
