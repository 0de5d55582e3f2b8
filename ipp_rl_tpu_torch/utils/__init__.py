"""Utilities of the port (copies of the JAX package's framework-free ones)."""

from ipp_rl_tpu_torch.utils.logging_utils import setup_logger  # noqa: F401
from ipp_rl_tpu_torch.utils.notifications import Notifier  # noqa: F401
from ipp_rl_tpu_torch.utils.statistics import AverageMeter, dotdict  # noqa: F401
