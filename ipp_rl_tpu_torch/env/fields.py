"""Ground-truth field generators (reference simulations/).

Port of ``ipp_rl_tpu/env/fields.py``, batched over worlds:

  * Gaussian random field: spectral synthesis, amplitude k^(−r/2)
    (reference simulations/ground_truths.py:14-33), ``torch.fft`` in
    complex64;
  * hotspot field: two non-overlapping rectangular high-value clusters
    (reference simulations/simulations.py:50-90);
  * split field: high/low split along a random axis line in the middle
    third (reference simulations/simulations.py:93-123);
  * temperature field: an RGBA image mapped to temperature and
    area-downsampled to the grid (reference simulations/simulations.py:
    126-168), host-side numpy.

Each random generator has a form that takes its draws as arguments
(white noise, levels, positions), so a test can hand both packages the
same numbers, and ``generate_ground_truth`` draws them from a
``torch.Generator``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config
from ipp_rl_tpu_torch.device import resolve_device


def grf_amplitude(ny: int, nx: int, cluster_radius: float) -> np.ndarray:
    """(ny, nx) float64 spectral amplitude k^(−r/2), 0 at k = 0."""
    ky = np.fft.fftfreq(ny) * ny  # integer frequency indices, fft order
    kx = np.fft.fftfreq(nx) * nx
    kk = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    with np.errstate(divide="ignore"):
        return np.where(kk == 0.0, 0.0, kk ** (-cluster_radius / 2.0))


def gaussian_random_field_from_noise(cfg: Config, white: torch.Tensor) -> torch.Tensor:
    """Spectral-synthesis GRF from white noise ``white`` (..., ny, nx),
    min-max normalised per field to [0, 1]; float32."""
    ny, nx = cfg.environment.y_dim, cfg.environment.x_dim
    amp = torch.as_tensor(
        grf_amplitude(ny, nx, cfg.sensor.cluster_radius), device=white.device
    ).to(torch.complex64)
    spec = torch.fft.fft2(white.to(torch.float32).to(torch.complex64))
    field = torch.fft.ifft2(spec * amp).real
    lo = torch.amin(field, dim=(-2, -1), keepdim=True)
    hi = torch.amax(field, dim=(-2, -1), keepdim=True)
    return (field - lo) / (hi - lo)


def gaussian_random_field(
    cfg: Config,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """(B, ny, nx) fresh GRF worlds with white noise drawn from ``generator``."""
    ny, nx = cfg.environment.y_dim, cfg.environment.x_dim
    white = torch.randn(
        (batch_size, ny, nx), generator=generator, device=resolve_device(device),
        dtype=torch.float32,
    )
    return gaussian_random_field_from_noise(cfg, white)


def hotspot_field_from_draws(
    cfg: Config,
    hi: torch.Tensor,
    lo: torch.Tensor,
    y1: torch.Tensor,
    x1: torch.Tensor,
    y2: torch.Tensor,
    x2: torch.Tensor,
) -> torch.Tensor:
    """(B, ny, nx) fields: ``lo`` everywhere, ``hi`` in the 2r×2r squares
    around (y1, x1) and (y2, x2); every draw is (B,)."""
    ny, nx = cfg.environment.y_dim, cfg.environment.x_dim
    r = int(cfg.sensor.cluster_radius)
    rows = torch.arange(ny, device=hi.device)[None, :, None]
    cols = torch.arange(nx, device=hi.device)[None, None, :]

    def cluster(cy, cx):
        cy, cx = cy[:, None, None], cx[:, None, None]
        return (rows >= cy - r) & (rows < cy + r) & (cols >= cx - r) & (cols < cx + r)

    inside = cluster(y1, x1) | cluster(y2, x2)
    return torch.where(inside, hi[:, None, None], lo[:, None, None].expand(-1, ny, nx))


def _uniform_index(valid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index of the ⌊u·k⌋-th True entry of each row of ``valid`` (B, n),
    u ∈ [0, 1): a uniform draw over the valid indices (0 where none is
    valid, as jax.random.categorical gives over all -inf logits)."""
    k = valid.sum(dim=-1)
    target = torch.clamp((u * k).long(), max=k - 1)
    return torch.searchsorted(torch.cumsum(valid.long(), dim=-1), (target + 1)[:, None])[:, 0]


def hotspot_random_field(
    cfg: Config, batch_size: int, generator: Optional[torch.Generator], device
) -> torch.Tensor:
    """Fresh hotspot worlds; the second centre differs from the first by
    more than r in both coordinates (the reference's rejection loop)."""
    ny, nx = cfg.environment.y_dim, cfg.environment.x_dim
    r = int(cfg.sensor.cluster_radius)
    u = torch.rand((6, batch_size), generator=generator, device=device, dtype=torch.float64)
    y1 = r + (u[2] * (ny - r)).long()
    x1 = r + (u[3] * (nx - r)).long()
    ys = torch.arange(ny, device=device)[None]
    xs = torch.arange(nx, device=device)[None]
    y2 = _uniform_index((ys >= r) & ((ys - y1[:, None]).abs() > r), u[4])
    x2 = _uniform_index((xs >= r) & ((xs - x1[:, None]).abs() > r), u[5])
    hi = (0.7 + 0.3 * u[0]).float()
    lo = (0.3 * u[1]).float()
    return hotspot_field_from_draws(cfg, hi, lo, y1, x1, y2, x2)


def split_field_from_draws(
    cfg: Config,
    hi: torch.Tensor,
    lo: torch.Tensor,
    swap: torch.Tensor,
    along_y: torch.Tensor,
    split_y: torch.Tensor,
    split_x: torch.Tensor,
) -> torch.Tensor:
    """(B, ny, nx) fields split high/low at row ``split_y`` (where
    ``along_y``) or column ``split_x``; ``swap`` puts the low side first."""
    ny, nx = cfg.environment.y_dim, cfg.environment.x_dim
    first = torch.where(swap, lo, hi)[:, None, None]
    second = torch.where(swap, hi, lo)[:, None, None]
    rows = torch.arange(ny, device=hi.device)[None, :, None]
    cols = torch.arange(nx, device=hi.device)[None, None, :]
    by_y = torch.where(rows < split_y[:, None, None], first, second).expand(-1, ny, nx)
    by_x = torch.where(cols < split_x[:, None, None], first, second).expand(-1, ny, nx)
    return torch.where(along_y[:, None, None], by_y, by_x)


def _split_bounds(cfg: Config):
    ny, nx = cfg.environment.y_dim, cfg.environment.x_dim
    return (
        (math.ceil(ny * 0.33), math.ceil(ny * 0.66) + 1),
        (math.floor(nx * 0.33), math.ceil(nx * 0.66) + 1),
    )


def split_random_field(
    cfg: Config, batch_size: int, generator: Optional[torch.Generator], device
) -> torch.Tensor:
    """Fresh split worlds: the split line lies in the middle third."""
    (y_lo, y_hi), (x_lo, x_hi) = _split_bounds(cfg)
    u = torch.rand((5, batch_size), generator=generator, device=device, dtype=torch.float64)
    hi = (0.65 + 0.35 * u[0]).float()
    lo = (0.35 * u[1]).float()
    split_y = y_lo + (u[4] * (y_hi - y_lo)).long()
    split_x = x_lo + (u[4] * (x_hi - x_lo)).long()
    return split_field_from_draws(cfg, hi, lo, u[2] > 0.5, u[3] > 0.5, split_y, split_x)


def _area_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Exact fractional-area average resize (INTER_AREA semantics)."""
    in_h, in_w = img.shape

    def weights(n_in, n_out):
        w = np.zeros((n_out, n_in))
        scale = n_in / n_out
        for o in range(n_out):
            lo, hi = o * scale, (o + 1) * scale
            for i in range(int(np.floor(lo)), int(np.ceil(hi))):
                w[o, i] = min(hi, i + 1) - max(lo, i)
        return w / w.sum(axis=1, keepdims=True)

    return weights(in_h, out_h) @ img @ weights(in_w, out_w).T


def temperature_data_field(cfg: Config, datasets_dir: Optional[str] = None) -> np.ndarray:
    """(ny, nx) field from the configured RGBA temperature image, read
    from ``datasets_dir`` (default: $DATASETS_DIR, else the working
    directory)."""
    if not cfg.sensor.dataset_filename:
        raise ValueError("temperature_data_field needs sensor.dataset_filename")
    datasets_dir = datasets_dir or os.environ.get("DATASETS_DIR", ".")
    path = os.path.join(datasets_dir, cfg.sensor.dataset_filename)
    if not os.path.exists(path):
        raise FileNotFoundError(f"temperature dataset not found: {path}")
    from PIL import Image

    raw = np.asarray(Image.open(path)).astype(np.float64)
    temp = -1.0 * (raw[:, :, 0] - raw[:, :, 2])  # −(R − B) → temperature

    def norm(x):
        lo, hi = x.min(), x.max()
        return x / hi if lo == hi else (x - lo) / (hi - lo)

    resized = _area_resize(norm(temp), cfg.environment.y_dim, cfg.environment.x_dim)
    return norm(resized)


def generate_ground_truth(
    cfg: Config,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """(B, ny, nx) float32 worlds of the configured simulation type."""
    device = resolve_device(device)
    sim = cfg.sensor.simulation_type
    if sim == "gaussian_random_field":
        return gaussian_random_field(cfg, batch_size, generator, device)
    if sim == "hotspot_random_field":
        return hotspot_random_field(cfg, batch_size, generator, device)
    if sim == "split_random_field":
        return split_random_field(cfg, batch_size, generator, device)
    if sim == "temperature_data_field":
        field = torch.as_tensor(temperature_data_field(cfg), dtype=torch.float32, device=device)
        return field.expand(batch_size, -1, -1).clone()
    raise ValueError(f"Unknown simulation type '{sim}'")
