"""Where the time goes in the PyTorch port's greedy replan step on the card.

One replan step of ``ipp_rl_tpu_torch`` (canonical example.yaml,
``fast_sweeps=True``) split into its phases — sweep (all-action gains),
select (mask + argmax), commit (measurement + Joseph update), evaluate
(six metrics) — timed two ways:

  * CUDA events around each phase run alone (``--iters`` times);
  * ``torch.profiler`` over ``--steps`` whole steps: device time per
    phase (record_function ranges), the kernels by self device time, and
    the device's busy share of the window.

Run from the repository root on a CUDA card:

    python3 scripts/profile_torch_greedy.py [--batch 4096] [--steps 5]

It prints a summary and writes the full tables to
``chiprun_out/profile_torch_greedy.txt``.
"""

import argparse
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from ipp_rl_tpu_torch.config import CONFIG_DIR, MissionConfig, load_config  # noqa: E402
from ipp_rl_tpu_torch.env.world import IPPWorld  # noqa: E402
from ipp_rl_tpu_torch.planners import GreedyPlanner  # noqa: E402
from ipp_rl_tpu_torch.planners.base import feasible_mask, sweep_rewards  # noqa: E402


PHASES = ("sweep", "select", "commit", "evaluate")


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt, self_only):
    name = ("self_" if self_only else "") + "device_time_total"
    if hasattr(evt, name):
        return getattr(evt, name)
    return getattr(evt, name.replace("device", "cuda"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_greedy: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg, fast_sweeps=True)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = world.init_state(args.batch, gen)

    def select(rewards, costs, st):
        ok = feasible_mask(st.budget, costs)
        return torch.argmax(torch.where(ok, rewards, float("-inf")), dim=-1)

    def step(st):
        with record_function("sweep"):
            rewards, costs = sweep_rewards(world, st)
        with record_function("select"):
            action = select(rewards, costs, st)
        with record_function("commit"):
            st = world.step_index(st, action, generator=gen)
        with record_function("evaluate"):
            world.evaluate(st)
        return st

    for _ in range(2):
        state = step(state)
    rewards, costs = sweep_rewards(world, state)
    action = planner.plan(state, gen, 0)
    phases = {
        "sweep": cuda_ms(lambda: sweep_rewards(world, state), args.iters),
        "select": cuda_ms(lambda: select(rewards, costs, state), args.iters),
        "commit": cuda_ms(lambda: world.step_index(state, action, generator=gen), args.iters),
        "evaluate": cuda_ms(lambda: world.evaluate(state), args.iters),
        "step": cuda_ms(lambda: step(state), args.iters),
    }

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state = step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device events, without the phase ranges' own device-side copies
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in PHASES]
    busy_ms = sum(_device_us(e, True) for e in kernels) / 1e3
    ranges = {e.key: _device_us(e, False) / 1e3 / args.steps
              for e in events if e.key in PHASES and e.device_type != torch.autograd.DeviceType.CUDA}

    lines = [f"card: {card} | torch {torch.__version__} | B={args.batch}",
             "phase times from CUDA events (ms, each phase alone):"]
    lines += [f"  {k:9s} {v:9.3f}" for k, v in phases.items()]
    lines.append(f"profiled window: {args.steps} steps, wall {wall_ms:.3f} ms, "
                 f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    lines.append("device time per step by phase (profiler ranges, ms):")
    lines += [f"  {k:9s} {v:9.3f}" for k, v in ranges.items()]
    lines.append("kernels by self device time (ms per step, launches per step):")
    for e in sorted(kernels, key=lambda e: -_device_us(e, True))[:25]:
        lines.append(f"  {_device_us(e, True) / 1e3 / args.steps:9.4f} "
                     f"{e.count / args.steps:6.1f}  {e.key[:110]}")
    text = "\n".join(lines)
    print(text)
    out = ROOT / "chiprun_out"
    os.makedirs(out, exist_ok=True)
    (out / "profile_torch_greedy.txt").write_text(text + "\n\n" + events.table(row_limit=60))


if __name__ == "__main__":
    main()
