"""TensorGalerkin core on PyTorch: Batch-Map + Sparse-Reduce Galerkin
assembly, sparse containers, matrix-free operators, Dirichlet condensation
and Krylov solvers.

Everything is float64 (the paper solves to a 1e-10 residual) and runs on
the CUDA device unless the caller passes ``device="cpu"``.  The sharded
entry points (:func:`assemble_sharded`, :class:`ShardedMatFreeOperator`)
split the element axis over the ranks of a ``torch.distributed`` group
(:mod:`repro_torch.sharding`).
"""

from .assembly import (  # noqa: F401
    DTYPE,
    AssemblyPlan,
    GalerkinAssembler,
    assemble,
    assemble_batched,
    assemble_rhs,
    assemble_rhs_batched,
    assemble_rhs_sharded,
    assemble_sharded,
    build_plan,
    clear_assembly_caches,
    facet_context,
    geometry_context,
    n_core_traces,
    resolve_device,
)
from .boundary import DirichletCondenser, FacetAssembler  # noqa: F401
from .elements import ReferenceElement, get_element  # noqa: F401
from .matvec import (  # noqa: F401
    MATVEC_BACKENDS,
    make_matvec,
    make_residual,
    matvec_backends,
    register_matvec_backend,
)
from .mesh import (  # noqa: F401
    FunctionSpace,
    Mesh,
    annulus_sector_tri,
    box_hex,
    disk_tri,
    element_for_mesh,
    hollow_cube_tet,
    l_shape_tri,
    rectangle_quad,
    rectangle_tri,
    unit_cube_hex,
    unit_cube_tet,
    unit_square_tri,
)
from .operator import (  # noqa: F401
    LinearOperator,
    MatFreeFamily,
    MatFreeOperator,
    ShardedMatFreeOperator,
    matfree_family,
    matfree_operator,
    n_matfree_traces,
)
from .solvers import (  # noqa: F401
    SolveInfo,
    SolverSpec,
    bicgstab,
    cg,
    jacobi_preconditioner,
    make_preconditioner,
    matfree_solve,
    matfree_solve_batched,
    register_preconditioner,
    resolve_solver_spec,
    sparse_solve,
    sparse_solve_batched,
)
from .elemalg import (  # noqa: F401
    CondensedSystem,
    DofSplit,
    ElementFactors,
    block_partition,
    chebyshev_preconditioner,
    condense,
    condensed_solve,
    dof_split,
    ebe_preconditioner,
    factorize,
    masked_element_matrices,
    vertex_split,
)
from .sparse import (  # noqa: F401
    CSR,
    ELL,
    BatchedCSR,
    CSRPattern,
    cached_diagonal,
    clear_device_mirrors,
    csr_to_ell,
    ell_layout,
)
from . import forms, weakform  # noqa: F401
from .weakform import WeakForm  # noqa: F401
