"""Does MCTS-zero training in the PyTorch port repeat from a seed on the card?

Two probes at the canonical width (example.yaml mission 0: 128 channels,
10 encoder blocks, 100 simulations, batch 96), each run twice from the
same weights and generator seed and compared bit for bit:

  1. ``SelfPlay.run`` over ``--envs`` environments × ``--steps`` steps:
     every trajectory field, the episode values and the descent-step count;
  2. ``--train-steps`` SGD steps (``make_train_step``) on one fixed batch
     of that self-play's replay: every parameter and running statistic.

Each pair runs under three settings: torch's defaults; cuDNN's
deterministic algorithms (``torch.backends.cudnn.deterministic = True``,
``benchmark = False``); and ``torch.use_deterministic_algorithms(True)``
besides.  Beside each pair: self-play ms per step (host clock,
synchronised) and train-step ms (CUDA events), so the cost of each
setting shows.

Run from the repository root on a CUDA card:

    python3 -m ipp_rl_tpu_torch.tools.probe_determinism [--envs 128] [--steps 4]

It prints one JSON line and writes it to
``chiprun_out/probe_torch_determinism.json``.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners.zero.learn import ZeroLearner
from ipp_rl_tpu_torch.planners.zero.train import reset_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def setting(name: str):
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    if name != "default":
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    if name == "all":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    mc = cfg.missions[0]
    mc = dataclasses.replace(mc, hyper_params=dataclasses.replace(
        mc.hyper_params, max_episode_steps=args.steps))
    hp = mc.hyper_params
    world = IPPWorld(cfg)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = {"card": card, "envs": args.envs, "steps": args.steps,
              "train_steps": args.train_steps, "settings": {}}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        learner = ZeroLearner(world, mc, checkpoints_dir=os.path.join(tmp, "c"),
                              log_dir=os.path.join(tmp, "l"), num_envs=args.envs, seed=0)
        init = copy.deepcopy(learner.state.variables())
        descents = [0]
        step_fn = learner.mcts._descend_step

        def counted(*a, **kw):
            descents[0] += 1
            return step_fn(*a, **kw)

        learner.mcts._descend_step = counted

        def selfplay():
            learner.net.load_state_dict(init)
            descents[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj, values = learner.selfplay.run(
                args.envs, net_variables=learner.state.variables(),
                generator=torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
            return traj, values, descents[0], (time.perf_counter() - t0) / args.steps * 1e3

        # warm-up and the replay the train probe draws its batch from
        traj, _, _, _ = selfplay()
        learner.replay.set_window(0, 1)
        learner.replay.add_iteration(0, traj.map(lambda x: x.cpu().numpy()), device_traj=traj)
        win, slots = learner.replay.device_window(hp.max_train_examples_history)
        rows = learner.replay.epoch_rows(1, hp.batch_size, np.random.default_rng(0), slots)[0]
        batch = learner.replay._gather_device(win, torch.as_tensor(rows, device="cuda"))

        def train():
            learner.net.load_state_dict(init)
            state = reset_optimizer(hp, learner.state)
            gen = torch.Generator(device="cuda").manual_seed(5)
            state, _, _ = learner.train_step(state, batch, gen, 5e-3)  # warm-up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.train_steps - 1):
                state, m, _ = learner.train_step(state, batch, gen, 5e-3)
            end.record()
            end.synchronize()
            return ({k: v.clone() for k, v in state.variables().items()},
                    start.elapsed_time(end) / (args.train_steps - 1), m["total_loss"].item())

        for name in ("default", "cudnn", "all", "default"):
            with setting(name):
                a, b = selfplay(), selfplay()
                ta, tb = train(), train()
            fields = [f for f, x, y in zip(a[0]._fields, a[0], b[0]) if not torch.equal(x, y)]
            params = [k for k in ta[0] if not torch.equal(ta[0][k], tb[0][k])]
            row = {
                "selfplay_identical": not fields and torch.equal(a[1], b[1]),
                "selfplay_fields_differing": fields,
                "descent_steps": [a[2], b[2]],
                "selfplay_ms_per_step": [a[3], b[3]],
                "train_identical": not params,
                "train_tensors_differing": len(params), "train_tensors": len(ta[0]),
                "first_differing": params[:5],
                "train_step_ms": [ta[1], tb[1]], "loss_last": [ta[2], tb[2]],
            }
            key = name if name not in report["settings"] else name + "_again"
            report["settings"][key] = row
            print(key, json.dumps(row), flush=True)
    line = json.dumps(report)
    (out_dir / "probe_torch_determinism.json").write_text(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
