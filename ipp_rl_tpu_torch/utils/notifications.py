"""Progress notifications (reference experiments/notifications.py:9-61).

A copy of ``ipp_rl_tpu/utils/notifications.py`` (the port imports nothing
of the JAX package).

The reference pushes start/iteration/finish/failure messages to a
Telegram bot.  This environment has no network egress, so the notifier
writes the same message stream to a JSONL file (and logs it); a webhook
sender can be plugged in via ``sink``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)


class Notifier:
    def __init__(
        self,
        label: str,
        out_dir: str = "logs",
        sink: Optional[Callable[[Dict], None]] = None,
        verbose: bool = True,
    ):
        self.label = label
        self.verbose = verbose
        self.sink = sink
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "notifications.jsonl")

    def _emit(self, kind: str, info: Optional[Dict] = None):
        record = {
            "ts": time.time(),
            "label": self.label,
            "kind": kind,
            "info": info or {},
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")
        if self.sink:
            try:
                self.sink(record)
            except Exception as e:  # pragma: no cover
                logger.error("notification sink failed: %s", e)
        if self.verbose:
            logger.info("[%s] %s %s", self.label, kind, info or "")

    def started(self, info: Optional[Dict] = None):
        self._emit("started", info)

    def finished_iteration(self, iteration_id: str, additional_info: Optional[Dict] = None):
        self._emit("iteration", {"id": iteration_id, **(additional_info or {})})

    def finished(self, info: Optional[Dict] = None):
        self._emit("finished", info)

    def failed(self, error: str):
        self._emit("failed", {"error": error})
