"""The smooth random field of the input kinds ``log_fourier`` and
``smooth_state``: a(x) = σ √(2/M) Σ_k cos(2π k·x + φ_k) over the
M = (k_max+1)³ − 1 wave vectors k ∈ {0..k_max}³ ∖ {0}, with uniform phases
φ_k.  Every draw has the same amplitudes, so its spatial standard
deviation is σ and its contrast alike.

The points it is evaluated at stay on the host (pinned where the device is
a card) and go to the device a block at a time, so the harness holds no
copy of the mesh in the device memory that the program's peak is read
from.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

__all__ = ["FourierField"]

_CHUNK = 1 << 18  # points a block of the field's evaluation


def _wave_vectors(k_max: int) -> torch.Tensor:
    ks = [k for k in itertools.product(range(k_max + 1), repeat=3) if any(k)]
    return torch.tensor(ks, dtype=torch.float64).T        # (3, M)


class FourierField:
    def __init__(self, at: np.ndarray, k_max: int, sigma: float, device: torch.device):
        self.device = device
        at = torch.as_tensor(np.ascontiguousarray(at), dtype=torch.float64)
        self.at = at.pin_memory() if device.type == "cuda" else at
        self.waves = 2 * math.pi * _wave_vectors(k_max).to(device)
        self.amplitude = sigma * math.sqrt(2.0 / self.waves.shape[1])

    def draw(self, g: torch.Generator, post=None) -> torch.Tensor:
        """a at every point, phases from ``g``; ``post(at, values)`` may
        change each block's values in place."""
        m = self.waves.shape[1]
        phase = 2 * math.pi * torch.rand(m, generator=g, device=self.device,
                                         dtype=torch.float64)
        out = torch.empty(self.at.shape[0], dtype=torch.float64, device=self.device)
        weights = torch.full((m,), self.amplitude, dtype=torch.float64, device=self.device)
        for lo in range(0, self.at.shape[0], _CHUNK):
            at = self.at[lo:lo + _CHUNK].to(self.device, non_blocking=True)
            theta = torch.addmm(phase, at, self.waves)
            out[lo:lo + _CHUNK] = theta.cos_() @ weights
            if post is not None:
                post(at, out[lo:lo + _CHUNK])
        return out
