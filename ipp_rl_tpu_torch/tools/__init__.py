"""Measurement tools of the port, run on a CUDA card as
``python3 -m ipp_rl_tpu_torch.tools.<name>`` from the repository root."""
