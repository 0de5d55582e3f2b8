"""Command-line tools of the port, run as ``python3 -m
ipp_rl_tpu_torch.tools.<name>`` from the repository root: the training
script ``train_zero`` and the measurement probe ``probe_determinism``."""
