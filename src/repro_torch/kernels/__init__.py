"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) with their plain
PyTorch versions (:mod:`repro_torch.kernels.ref`).

================================  ==========================================
wrapper                           ports the Pallas kernel (``repro.kernels``)
================================  ==========================================
``local_stiffness_p1``            ``local_assembly.local_stiffness_p1``
``matfree_p1_diffusion``          none: the matrix-free action's einsum
``seg_reduce``                    ``seg_reduce.seg_reduce``
``spmv_ell``                      ``spmv_ell.spmv_ell``
``galerkin_residual_ell``         ``spmv_ell.galerkin_residual_ell``
``spmv_ell_stream``               ``spmv_ell.spmv_ell_stream``
``galerkin_residual_ell_stream``  ``spmv_ell.galerkin_residual_ell_stream``
================================  ==========================================

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  ``LAUNCHES`` counts the kernel
launches of each wrapper.  The libraries build with ``nvcc`` at first use
(:func:`build` builds them all at once).
"""

from ._cuda import LAUNCHES, build, reset_launches  # noqa: F401
from .local_assembly import local_stiffness_p1  # noqa: F401
from .matfree_p1 import matfree_p1_diffusion  # noqa: F401
from .ops import (  # noqa: F401
    autotune_ell_stream,
    batch_map_stiffness,
    ell_matvec,
    ell_matvec_stream,
    ell_residual,
    ell_residual_stream,
)
from .seg_reduce import ReduceTable, build_padded_reduce, seg_reduce  # noqa: F401
from .spmv_ell import (  # noqa: F401
    StreamPlan,
    StreamPlans,
    autotune_stream,
    check_stream_fits,
    galerkin_residual_ell,
    galerkin_residual_ell_stream,
    spmv_ell,
    spmv_ell_stream,
    stream_runs,
    stream_smem_bytes,
)
