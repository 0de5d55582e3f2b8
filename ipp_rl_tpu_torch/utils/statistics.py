"""Small stats utilities (reference planning/common/statistics.py:1-22).

A copy of ``ipp_rl_tpu/utils/statistics.py`` (the port imports nothing of
the JAX package)."""

from __future__ import annotations


class AverageMeter:
    """Running average tracker."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def __repr__(self):
        return f"{self.avg:.4f} (n={self.count})"


class dotdict(dict):
    """Attribute access for dict keys."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__
