"""The cells' inputs, made from ``--seed`` on the run's device: the
ground-truth fields, the prior belief, and the measurement noise.  The
program and the reference are handed the same tensors.

The random field is a spectral synthesis (amplitude k^(−r/2) at
integer frequency k, r the configuration's cluster radius) of seeded
white noise, min-max normalised to [0, 1] per field: the frequency law
of the reference's Gaussian random field.  A configuration whose file
holds ``ground_truth`` (a measured field) gives every mission that field.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.world import matern_prior


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of draws of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def fields(config: Dict, batch: int, gen: torch.Generator, device) -> torch.Tensor:
    """(batch, N) float32 ground truths."""
    raw = config["config"]
    env = raw["environment"]
    ny, nx = env["y_dim"], env["x_dim"]
    if "ground_truth" in config:
        gt = torch.tensor(config["ground_truth"], dtype=torch.float32, device=device)
        return gt.reshape(1, ny * nx).expand(batch, -1).contiguous()
    r = float(raw["sensor"]["simulation"]["cluster_radius"])
    ky = np.fft.fftfreq(ny) * ny
    kx = np.fft.fftfreq(nx) * nx
    kk = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    with np.errstate(divide="ignore"):
        amp = np.where(kk == 0.0, 0.0, kk ** (-r / 2.0))
    white = torch.randn((batch, ny, nx), generator=gen, device=device, dtype=torch.float32)
    spec = torch.fft.fft2(white.to(torch.complex64))
    f = torch.fft.ifft2(spec * torch.as_tensor(amp, device=device).to(torch.complex64)).real
    lo = torch.amin(f, dim=(-2, -1), keepdim=True)
    hi = torch.amax(f, dim=(-2, -1), keepdim=True)
    return ((f - lo) / (hi - lo)).reshape(batch, ny * nx).contiguous()


def prior(config: Dict, device):
    """The prior mean (N,) and covariance (N, N), float32."""
    mean, cov = matern_prior(config["config"])
    return mean.to(device, torch.float32), cov.to(device, torch.float32)


def start_pos(config: Dict, device) -> torch.Tensor:
    """(3,) the first cell's centre at the highest altitude."""
    raw = config["config"]
    res = float(raw["environment"]["resolution"])
    z = float(raw["experiment"]["constraints"]["max_altitude"])
    return torch.tensor([0.5 * res, 0.5 * res, z], dtype=torch.float32, device=device)


def belief_state(mean0, cov0, pos0, budget: float, gt: torch.Tensor):
    """The port's ``BeliefState`` of missions that start from the prior at
    ``pos0`` with the whole ``budget`` over the ground truths gt (B, N)."""
    from ipp_rl_tpu_torch.env.world import BeliefState

    B, dev = gt.shape[0], gt.device
    return BeliefState(
        mean=mean0.expand(B, -1).clone(), cov=cov0.expand(B, -1, -1).clone(),
        pos=pos0.expand(B, 3).clone(),
        budget=torch.full((B,), budget, dtype=torch.float32, device=dev),
        ground_truth=gt, active=torch.ones(B, dtype=torch.bool, device=dev),
        step=torch.zeros(B, dtype=torch.int32, device=dev))
