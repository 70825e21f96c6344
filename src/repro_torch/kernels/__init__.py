"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) with their plain
PyTorch versions (:mod:`repro_torch.kernels.ref`).

=========================  ==================================================
wrapper                    ports the Pallas kernel
=========================  ==================================================
``local_stiffness_p1``     ``repro.kernels.local_assembly.local_stiffness_p1``
``seg_reduce``             ``repro.kernels.seg_reduce.seg_reduce``
``spmv_ell``               ``repro.kernels.spmv_ell.spmv_ell``
``galerkin_residual_ell``  ``repro.kernels.spmv_ell.galerkin_residual_ell``
=========================  ==================================================

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  ``LAUNCHES`` counts the kernel
launches of each wrapper.  The libraries build with ``nvcc`` at first use
(:func:`build` builds them all at once).
"""

from ._cuda import LAUNCHES, build, reset_launches  # noqa: F401
from .local_assembly import local_stiffness_p1  # noqa: F401
from .ops import batch_map_stiffness, ell_matvec, ell_residual  # noqa: F401
from .seg_reduce import ReduceTable, build_padded_reduce, seg_reduce  # noqa: F401
from .spmv_ell import galerkin_residual_ell, spmv_ell  # noqa: F401
