"""Public wrappers over the kernels, in the names of ``repro.kernels.ops``.

Each launches its CUDA kernel for tensors on a CUDA device and runs the
plain PyTorch version for tensors on the CPU; there is no interpret mode.
"""

from __future__ import annotations

from .local_assembly import local_stiffness_p1
from .spmv_ell import (
    BLOCK_N,
    autotune_stream,
    galerkin_residual_ell,
    galerkin_residual_ell_stream,
    spmv_ell,
    spmv_ell_stream,
)

__all__ = [
    "batch_map_stiffness",
    "ell_matvec",
    "ell_residual",
    "ell_matvec_stream",
    "ell_residual_stream",
    "autotune_ell_stream",
]


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


def ell_matvec_stream(ell, x, *, block_n: int = BLOCK_N, nbuf: int | None = None):
    """Streaming SpMV on an ELL operator, with the plan its sparsity pattern
    caches per ``block_n`` (staged on the device once)."""
    return spmv_ell_stream(ell.vals, ell.pattern.stream_plans()(block_n), x, nbuf=nbuf)


def ell_residual_stream(ell, u, f, *, block_n: int = BLOCK_N, nbuf: int | None = None):
    """Fused streaming residual ``r = K·u − f`` on an ELL operator."""
    return galerkin_residual_ell_stream(ell.vals, ell.pattern.stream_plans()(block_n), u, f,
                                        nbuf=nbuf)


def autotune_ell_stream(ell, x, **kw):
    """Pick the fastest ``(block_n, nbuf)`` for this layout by measurement;
    cached on the sparsity pattern and recorded through telemetry."""
    return autotune_stream(ell.vals, ell.pattern.stream_plans(), x, **kw)
