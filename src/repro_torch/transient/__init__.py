"""repro_torch.transient — time integration over assembled operators.

The torch port of ``repro.transient`` (this slice: the θ-method and
Newmark-β; ``NewtonKrylovIntegrator`` and the batched rollouts come in
later slices, see ROADMAP queue A12).

* :mod:`~repro_torch.transient.stepping` — :func:`segmented_rollout` (the
  time loop with ``torch.utils.checkpoint`` segments) and :func:`axpy_csr`.
* :mod:`~repro_torch.transient.theta` — :class:`ThetaIntegrator`: θ = 1
  backward Euler, θ = ½ Crank–Nicolson, per-step loads and Dirichlet data.
* :mod:`~repro_torch.transient.newmark` — :class:`NewmarkIntegrator`
  (β = ¼, γ = ½ conserves the discrete energy).

Per-step solves go through ``sparse_solve`` on the ``csr`` backend, so
trajectories differentiate with respect to the operator values and the
initial condition; the ELL backends (``ell``, ``ell_stream``) run the
Krylov matvecs through the CUDA SpMV kernels.
"""

from ..core.matvec import make_matvec  # noqa: F401  (the registry, as repro.transient re-exports it)
from .newmark import NewmarkIntegrator  # noqa: F401
from .stepping import axpy_csr, segmented_rollout  # noqa: F401
from .theta import BACKWARD_EULER, CRANK_NICOLSON, ThetaIntegrator  # noqa: F401

__all__ = [
    "ThetaIntegrator",
    "NewmarkIntegrator",
    "BACKWARD_EULER",
    "CRANK_NICOLSON",
    "segmented_rollout",
    "axpy_csr",
    "make_matvec",
]
