"""Train a (reduced-scale) MCTS-zero agent on the canonical 10x10 world
and evaluate it against greedy / random baselines on held-out worlds: the
counterpart of the repository's ``scripts/train_zero.py``.

Usage: python -m ipp_rl_tpu_torch.tools.train_zero [--iterations N] [--envs E]
    [--sims S] [--out DIR] [--device cuda|cpu] ...

Produces <out>/checkpoints/ (flax-format, readable by either package),
<out>/logs/train_metrics.jsonl and <out>/eval.json: per planner (the
deploy-time search, greedy, random) the final uncertainty and RMSE, the
mean steps, the wall seconds and the mean curves, at matched budget.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time

import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, MCTSZeroHyperParams, MissionConfig, load_config
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners import GreedyPlanner, RandomDiscretePlanner
from ipp_rl_tpu_torch.planners.zero.learn import ZeroLearner, load_checkpoint
from ipp_rl_tpu_torch.planners.zero.mission import ZeroPlanner
from ipp_rl_tpu_torch.planners.zero.train import init_train_state
from ipp_rl_tpu_torch.utils import setup_logger

logger = logging.getLogger("train_zero")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ipp_rl_tpu_torch.tools.train_zero")
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--envs", type=int, default=192)
    # canonical self-play scale (reference config/example.yaml:60-64):
    # 100 simulations, 40-step episodes
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--max-episode-steps", type=int, default=40)
    ap.add_argument(
        "--train-batches", type=int, default=0,
        help="cap on minibatches per epoch (0 = full window sweep, the "
        "reference semantics — wrappers :121-171)",
    )
    ap.add_argument("--batch-size", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--eval-batch", type=int, default=32)
    ap.add_argument("--out", default="runs/zero_small")
    ap.add_argument(
        "--puct-init", type=float, default=15.0,
        help="lower (e.g. 4) concentrates search targets at low sim counts",
    )
    ap.add_argument("--eval-steps", type=int, default=25)
    ap.add_argument(
        "--temperature-threshold", type=int, default=0,
        help="steps before the visit-policy temperature drops to 0 "
        "(0 = max-episode-steps, the reference semantics)",
    )
    ap.add_argument(
        "--deploy-eval-every", type=int, default=0,
        help="run a held-out deploy eval every k iterations and keep "
        "the best snapshot at shared_net.best (0 = off)",
    )
    ap.add_argument(
        "--deploy-gate", type=float, default=0.0,
        help="with --deploy-eval-every: roll the network back to the "
        "best snapshot whenever the current deploy eval exceeds this "
        "factor times the best (e.g. 1.1)",
    )
    ap.add_argument(
        "--train-noise-scale", type=float, default=1.0,
        help="multiply the SELF-PLAY world's injected measurement-noise "
        "std by this factor (the filter's assumed R and the eval world "
        "stay exact)",
    )
    ap.add_argument(
        "--unfloored-value-head", action="store_true",
        help="drop the SiLU between the value head's Dense and Softplus "
        "(schema.unfloored_value_head)",
    )
    ap.add_argument(
        "--policy-smoothing", type=float, default=0.0,
        help="blend the stored policy TARGET with uniform-over-valid "
        "(schema.policy_target_smoothing)",
    )
    ap.add_argument(
        "--eval-untrained", action="store_true",
        help="also evaluate the search with freshly initialized weights",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    setup_logger(os.path.join(args.out, "logs"))
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    hp = MCTSZeroHyperParams(
        num_mcts_simulations=args.sims,
        max_episode_steps=args.max_episode_steps,
        num_self_play_iterations=args.iterations,
        num_channels=args.channels,
        num_encoder_res_blocks=args.blocks,
        num_global_pooling_channels=min(32, args.channels // 2),
        batch_size=args.batch_size,
        num_epochs=args.epochs,
        temperature_threshold=args.temperature_threshold or args.max_episode_steps,
        shuffle_prior_cov=True,
        continuous_network_update=True,
        puct_init=args.puct_init,
        puct_init_min=min(4.0, args.puct_init),
        max_valid_action_distance=11.5,
        unfloored_value_head=args.unfloored_value_head,
        policy_target_smoothing=args.policy_smoothing,
    )
    mc = MissionConfig(type="mcts_zero", episode_horizon=5, hyper_params=hp)
    world = IPPWorld(cfg, fast_sweeps=True, device=device)
    # self-play world with inflated injected noise (the filter's assumed
    # R is untouched); evaluation below always uses the exact world
    world_train = world
    if args.train_noise_scale != 1.0:
        world_train = IPPWorld(cfg, fast_sweeps=True, device=device)
        world_train.noise_std = world_train.noise_std * args.train_noise_scale

    learner = ZeroLearner(
        world_train,
        mc,
        checkpoints_dir=os.path.join(args.out, "checkpoints"),
        log_dir=os.path.join(args.out, "logs"),
        num_envs=args.envs,
        deploy_eval_every=args.deploy_eval_every,
        deploy_eval_world=world,
        deploy_gate=args.deploy_gate,
    )
    t0 = time.time()
    learner.learn(num_iterations=args.iterations, num_train_batches=args.train_batches or None)
    logger.info("training done in %.1f min", (time.time() - t0) / 60)

    if args.deploy_eval_every and os.path.exists(learner.best_path()):
        # evaluate (and deploy) the BEST snapshot by held-out deploy eval
        learner.state = load_checkpoint(learner.best_path(), learner.state)
        logger.info("evaluating best snapshot (iter %d, deploy eval %.2f)",
                    learner.best_iteration, learner.best_deploy_eval)

    # -------- evaluation on held-out worlds at matched budget ----------
    # deploy with the trained weights AND the end-of-training exploration
    # constants (reference mcts_zero_mission.py:231-243,533)
    B = args.eval_batch
    init_state = world.init_state(B, torch.Generator(device=device).manual_seed(12345))
    deploy_mc = MissionConfig(type="mcts_zero", episode_horizon=5,
                              hyper_params=dataclasses.replace(hp, puct_init=learner.puct_init))
    planners = [
        ("mcts_zero", ZeroPlanner(world, deploy_mc, learner.predict, learner.state.variables())),
        ("greedy", GreedyPlanner(world, MissionConfig(type="greedy"))),
        ("random", RandomDiscretePlanner(world, MissionConfig(type="random_discrete"))),
    ]
    if args.eval_untrained:
        _, state0 = init_train_state(cfg, hp, torch.Generator(device=device).manual_seed(999),
                                     device)
        planners.append(("mcts_zero_untrained",
                         ZeroPlanner(world, deploy_mc, learner.predict, state0.variables())))
    results = {}
    for name, planner in planners:
        t0 = time.time()
        res = planner.run(B, max_steps=args.eval_steps, init_state=init_state,
                          generator=torch.Generator(device=device).manual_seed(7))
        results[name] = {
            "final_uncertainty": float(res.metrics["uncertainty"][:, -1].mean()),
            "final_rmse": float(res.metrics["rmse"][:, -1].mean()),
            "mean_steps": float(res.num_steps.mean()),
            "wall_s": round(time.time() - t0, 1),
            "uncertainty_curve": [round(float(u), 3)
                                  for u in res.metrics["uncertainty"].mean(axis=0)],
            "rmse_curve": [round(float(u), 4) for u in res.metrics["rmse"].mean(axis=0)],
        }
        logger.info("%s: %s", name, {k: v for k, v in results[name].items()
                                     if not k.endswith("_curve")})

    with open(os.path.join(args.out, "eval.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: v["final_uncertainty"] for k, v in results.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
