"""Experiment entry point of the port (the counterpart of the repository's
``main.py``): load config → run every mission → evaluate → save.

Usage:
  python -m ipp_rl_tpu_torch.main [--config PATH] [--batch B] [--max-steps T]
      [--results DIR] [--checkpoints DIR] [--logs DIR] [--seed S]
      [--device cuda|cpu] [--no-plots]

The config defaults to $CONFIG_FILE_PATH or the port's example.yaml.  It
runs on the card; without one it exits non-zero unless given
``--device cpu``.  ``--no-plots`` writes the KPIs and the results bundle
without the matplotlib figures; without it a missing matplotlib fails the
run.
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import sys

from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config
from ipp_rl_tpu_torch.config.env import load_dotenv, log_env_variables
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.experiments import Experiment
from ipp_rl_tpu_torch.ops import kernels
from ipp_rl_tpu_torch.utils import Notifier, setup_logger

logger = logging.getLogger(__name__)

REPO_DIR = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    # .env tier first: file values fill in unset process env vars
    # (reference constants.py:7-23 + compose env_file semantics)
    load_dotenv(str(REPO_DIR / ".env"))

    ap = argparse.ArgumentParser(prog="python -m ipp_rl_tpu_torch.main")
    ap.add_argument("--config",
                    default=os.environ.get("CONFIG_FILE_PATH", str(CONFIG_DIR / "example.yaml")))
    ap.add_argument("--batch", type=int, default=None, help="mission batch (default: repetitions)")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--results", default=os.environ.get("RESULTS_DIR", "results"))
    ap.add_argument("--checkpoints", default=os.environ.get("CHECKPOINTS_DIR", "checkpoints"))
    ap.add_argument("--logs", default=os.environ.get("LOG_DIR", "logs"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--no-plots", action="store_true",
                    help="skip the matplotlib figures (KPIs and the bundle are still written)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"ipp_rl_tpu_torch.main: {e}", file=sys.stderr)
        return 1

    setup_logger(args.logs)
    log_env_variables(str(REPO_DIR))
    cfg = load_config(args.config)
    notifier = Notifier(cfg.title, out_dir=args.logs)
    notifier.started({"config": args.config, "device": str(device)})
    try:
        exp = Experiment(
            cfg,
            results_dir=args.results,
            checkpoints_dir=args.checkpoints,
            seed=args.seed,
            device=device,
        )
        exp.run(batch_size=args.batch, max_steps=args.max_steps)
        kpis = exp.evaluate(make_plots=not args.no_plots)
        out = exp.save()
        # which hand-written kernels the run went through (0 on the CPU,
        # where the wrappers take the plain versions)
        launches = kernels.launch_counts()
        notifier.finished({"results": out, "kpis": kpis, "kernel_launches": launches})
        logger.info("results written to %s; kernel launches %s", out, launches)
        return 0
    except Exception as e:
        notifier.failed(str(e))
        raise


if __name__ == "__main__":
    sys.exit(main())
