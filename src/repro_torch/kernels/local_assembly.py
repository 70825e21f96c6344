"""Stage-I Batch-Map for P1 simplex stiffness: the wrapper of the CUDA
kernel ``csrc/local_assembly.cu`` (the port of the Pallas kernel
``repro.kernels.local_assembly.local_stiffness_p1``)."""

from __future__ import annotations

import torch

from . import _cuda
from .ref import local_stiffness_p1_ref

__all__ = ["local_stiffness_p1"]


def local_stiffness_p1(coords: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """coords (E, k, d) array-of-structs, rho (E,) → K_local (E, k, k), with
    k = d + 1 and d ∈ {2, 3}.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if coords.dim() != 3:
        raise ValueError(f"coords must be (E, k, d), got {tuple(coords.shape)}")
    e, k, d = coords.shape
    if d not in (2, 3) or k != d + 1:
        raise ValueError(f"P1 simplices need k = d + 1 with d in (2, 3), got k={k}, d={d}")
    if tuple(rho.shape) != (e,):
        raise ValueError(f"rho must be ({e},), got {tuple(rho.shape)}")
    if coords.device.type == "cpu" and rho.device.type == "cpu":
        return local_stiffness_p1_ref(coords, rho)
    dtype = _cuda.check_operands("local_stiffness_p1", {"coords": coords, "rho": rho})
    out = torch.empty((e, k, k), dtype=dtype, device=coords.device)
    if e:
        _cuda.launch("local_stiffness_p1", "local_assembly",
                     _cuda.symbol("tg_local_stiffness_p1", dtype), coords, rho, out, e, d)
    return out
