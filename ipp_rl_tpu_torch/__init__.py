"""ipp_rl_tpu_torch — the PyTorch/CUDA port of ``ipp_rl_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  It mirrors the
JAX package's layout (``config/``, ``ops/``, ``env/``, ``planners/``) so
each module's counterpart is easy to find, and imports neither ``jax``
nor anything from ``ipp_rl_tpu``.

Plain tensor code is PyTorch; the small-SPD kernels that the JAX package
ran as a Pallas kernel (``spd_inverse``) or as an unrolled XLA program
(``spd_trace_product``) are hand-written CUDA for ``sm_90a``
(``csrc/smallchol.cu``, bound in ``ops/kernels.py``), built from the
repository's sources at first use.

Entry points run on the card (``device="cuda"``) and raise when CUDA is
absent unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from ipp_rl_tpu_torch.config.schema import Config, load_config  # noqa: F401
from ipp_rl_tpu_torch.device import resolve_device  # noqa: F401
