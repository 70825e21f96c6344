"""Public wrappers over the kernels, in the names of ``repro.kernels.ops``.

Each launches its CUDA kernel for tensors on a CUDA device and runs the
plain PyTorch version for tensors on the CPU; there is no interpret mode.
"""

from __future__ import annotations

from .local_assembly import local_stiffness_p1
from .spmv_ell import galerkin_residual_ell, spmv_ell

__all__ = ["batch_map_stiffness", "ell_matvec", "ell_residual"]


def batch_map_stiffness(coords, rho):
    """Stage-I Batch-Map for P1 simplices: (E,k,d),(E,) → (E,k,k)."""
    return local_stiffness_p1(coords, rho)


def ell_matvec(ell, x):
    """SpMV on a :class:`repro_torch.core.sparse.ELL` operator, with the
    column table the ELL object staged on its device."""
    return spmv_ell(ell.vals, ell.cols_dev, x)


def ell_residual(ell, u, f):
    """Fused ``r = K·u − f`` on an ELL operator."""
    return galerkin_residual_ell(ell.vals, ell.cols_dev, u, f)
