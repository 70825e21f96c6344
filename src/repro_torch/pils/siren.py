"""SIREN backbone (Sitzmann et al. 2020) — shared by all neural-solver
baselines in the paper's controlled comparison (SM B.2.2).

The torch port of ``repro.pils.siren``.  Parameters are the reference's
tree, ``{"layers": [{"w", "b"}, ...], "omega0"}`` of tensors, so that
:func:`repro_torch.convert.params_from_numpy` carries JAX parameters
across; ``omega0`` is a leaf like the weights (the reference's optimizers
update it too).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.assembly import resolve_device

__all__ = ["siren_init", "siren_apply"]


def siren_init(generator: torch.Generator, in_dim: int, hidden: int, out_dim: int,
               depth: int = 4, omega0: float = 30.0, dtype=torch.float64, device=None):
    """Paper setup: 4 hidden layers, width 64, ω0 = 30, SIREN init — the
    weights of layer i uniform in ±1/d_in (i = 0) or ±√(6/d_in)/ω0, drawn
    from ``generator`` (on its own device), biases zero."""
    device = resolve_device(device)
    params = []
    dims = [in_dim] + [hidden] * depth + [out_dim]
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / d_in if i == 0 else np.sqrt(6.0 / d_in) / omega0
        u = torch.rand((d_in, d_out), generator=generator, dtype=dtype,
                       device=generator.device)
        w = ((2.0 * u - 1.0) * bound).to(device)
        params.append({"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=device)})
    return {"layers": params, "omega0": torch.tensor(omega0, dtype=dtype, device=device)}


def siren_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in_dim) → (..., out_dim)."""
    omega0 = params["omega0"]
    layers = params["layers"]
    h = x
    for layer in layers[:-1]:
        h = torch.sin(omega0 * (h @ layer["w"] + layer["b"]))
    last = layers[-1]
    return h @ last["w"] + last["b"]
