"""ELL SpMV and fused Galerkin residual: the wrappers of the CUDA kernels
in ``csrc/spmv_ell.cu`` (the ports of the Pallas kernels
``repro.kernels.spmv_ell.spmv_ell`` and ``galerkin_residual_ell``).

The column table is int32 and padded slots point back at their own row
with a zero value (:meth:`repro_torch.core.sparse.CSRPattern.ell_layout`
builds it so); the kernels rely on that and do not test slots.
"""

from __future__ import annotations

import torch

from . import _cuda
from .ref import galerkin_residual_ell_ref, spmv_ell_ref

__all__ = ["spmv_ell", "galerkin_residual_ell"]


def _check_shapes(name, vals, cols, *vecs):
    if vals.dim() != 2 or tuple(cols.shape) != tuple(vals.shape):
        raise ValueError(f"{name}: vals and cols must both be (N, L), got "
                         f"{tuple(vals.shape)} and {tuple(cols.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be int32, got {cols.dtype}")
    for v in vecs:
        if tuple(v.shape) != (vals.shape[0],):
            raise ValueError(f"{name}: vectors must be ({vals.shape[0]},), got {tuple(v.shape)}")


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """vals/cols (N, L), x (N,) → y = Σ_l vals[:, l]·x[cols[:, l]] (N,).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_shapes("spmv_ell", vals, cols, x)
    if all(t.device.type == "cpu" for t in (vals, cols, x)):
        return spmv_ell_ref(vals, cols, x)
    dtype = _cuda.check_operands("spmv_ell", {"vals": vals, "cols": cols, "x": x})
    n, width = vals.shape
    y = torch.empty(n, dtype=dtype, device=vals.device)
    if n:
        _cuda.launch("spmv_ell", "spmv_ell", _cuda.symbol("tg_spmv_ell", dtype),
                     vals, cols, x, y, n, width)
    return y


def galerkin_residual_ell(vals: torch.Tensor, cols: torch.Tensor, u: torch.Tensor,
                          f: torch.Tensor) -> torch.Tensor:
    """Fused r = K·u − f in one pass over the ELL operator.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_shapes("galerkin_residual_ell", vals, cols, u, f)
    if all(t.device.type == "cpu" for t in (vals, cols, u, f)):
        return galerkin_residual_ell_ref(vals, cols, u, f)
    dtype = _cuda.check_operands("galerkin_residual_ell",
                                 {"vals": vals, "cols": cols, "u": u, "f": f})
    n, width = vals.shape
    r = torch.empty(n, dtype=dtype, device=vals.device)
    if n:
        _cuda.launch("galerkin_residual_ell", "spmv_ell",
                     _cuda.symbol("tg_residual_ell", dtype), vals, cols, u, f, r, n, width)
    return r
