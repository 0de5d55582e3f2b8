"""Root logger setup (reference logger.py:8-34): console INFO +
timestamped DEBUG file.

A copy of ``ipp_rl_tpu/utils/logging_utils.py`` (the port imports nothing
of the JAX package)."""

from __future__ import annotations

import logging
import os
import time
from typing import Optional


def setup_logger(log_dir: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    for h in list(root.handlers):
        root.removeHandler(h)

    console = logging.StreamHandler()
    console.setLevel(level)
    console.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    root.addHandler(console)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"run_{stamp}.log"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(fh)
    return root
