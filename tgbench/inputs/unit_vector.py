"""A constant vector: a direction uniform on the sphere, times
``magnitude``."""

import torch


class Input:
    def __init__(self, spec: dict, points, cells, device):
        self.magnitude, self.device = spec["magnitude"], device

    def draw(self, g):
        v = torch.randn(3, generator=g, device=self.device, dtype=torch.float64)
        return v * (self.magnitude / torch.linalg.vector_norm(v))
