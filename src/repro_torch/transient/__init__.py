"""repro_torch.transient — time integration over Galerkin operators.

The torch port of ``repro.transient``:

* :mod:`~repro_torch.transient.stepping` — :func:`segmented_rollout` (the
  time loop with ``torch.utils.checkpoint`` segments) and :func:`axpy_csr`.
* :mod:`~repro_torch.transient.theta` — :class:`ThetaIntegrator`: θ = 1
  backward Euler, θ = ½ Crank–Nicolson, per-step loads and Dirichlet data,
  on assembled or matrix-free operators.
* :mod:`~repro_torch.transient.newmark` — :class:`NewmarkIntegrator`
  (β = ¼, γ = ½ conserves the discrete energy).
* :mod:`~repro_torch.transient.newton` — :class:`NewtonKrylovIntegrator`:
  backward Euler + Newton–Krylov for semilinear problems (Allen–Cahn).
* :func:`batched_rollout` and :func:`batched_theta_rollout` — rollouts
  over a batch of initial conditions or a family of operators
  (``BatchedCSR`` or ``MatFreeFamily`` pairs), instance by instance.

Per-step solves go through ``sparse_solve`` on the ``csr`` backend and
``matfree_solve`` on ``matfree``, so trajectories differentiate with
respect to the operators and the initial condition; the ELL backends
(``ell``, ``ell_stream``) run the Krylov matvecs through the CUDA SpMV
kernels.
"""

import torch

from ..core.matvec import make_matvec  # noqa: F401  (the registry, as repro.transient re-exports it)
from ..core.operator import MatFreeFamily
from ..core.solvers import SolverSpec
from .newmark import NewmarkIntegrator  # noqa: F401
from .newton import NewtonKrylovIntegrator  # noqa: F401
from .stepping import axpy_csr, segmented_rollout  # noqa: F401
from .theta import BACKWARD_EULER, CRANK_NICOLSON, ThetaIntegrator  # noqa: F401

__all__ = [
    "ThetaIntegrator",
    "NewmarkIntegrator",
    "NewtonKrylovIntegrator",
    "BACKWARD_EULER",
    "CRANK_NICOLSON",
    "batched_rollout",
    "batched_theta_rollout",
    "segmented_rollout",
    "axpy_csr",
    "make_matvec",
]


def batched_rollout(integrator, u0_batch, n_steps: int, **rollout_kwargs):
    """``integrator.rollout`` for each of a batch of initial conditions:
    ``(B, N) → (B, n_steps, N)``.  Keyword arguments (loads, bc_values,
    checkpoint_every, ...) are shared across the batch."""
    return torch.stack([integrator.rollout(u0, n_steps, **rollout_kwargs) for u0 in u0_batch])


def batched_theta_rollout(lhs_full, rhs_op, u0_batch, n_steps: int, *, dt,
                          theta: float = BACKWARD_EULER, bc=None, loads=None,
                          bc_values=None, checkpoint_every: int | None = None,
                          **integrator_kwargs):
    """θ-rollouts of a family of problem instances, one after another.

    ``lhs_full`` / ``rhs_op`` hold the B per-instance operators ``M +
    θΔtK_b`` / ``M − (1−θ)ΔtK_b`` on one plan: a
    :class:`~repro_torch.core.BatchedCSR` pair (from ``assemble_batched``;
    the ``csr`` backend unless ``backend=`` says otherwise) or a
    :class:`~repro_torch.core.MatFreeFamily` pair (from ``matfree_family``:
    the ``matfree`` backend, CG by default).  ``u0_batch (B, N) → (B,
    n_steps, N)``; ``loads`` / ``bc_values`` are shared across the batch."""
    if isinstance(lhs_full, MatFreeFamily):
        integrator_kwargs.setdefault("backend", "matfree")
        if integrator_kwargs.get("solver") is None:
            integrator_kwargs.setdefault("spec", SolverSpec(method="cg"))
    trajs = []
    for i, u0 in enumerate(u0_batch):
        integ = ThetaIntegrator(None, None, dt, theta=theta, bc=bc, lhs_full=lhs_full[i],
                                rhs_op=rhs_op[i], **integrator_kwargs)
        trajs.append(integ.rollout(u0, n_steps, loads=loads, bc_values=bc_values,
                                   checkpoint_every=checkpoint_every))
    return torch.stack(trajs)
