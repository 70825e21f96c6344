"""Newton–Krylov backward-Euler integration for semilinear parabolic
problems (Allen–Cahn and friends).

The torch port of ``repro.transient.newton``.  Semidiscrete system
M u̇ + κ K u = R(u), where the reaction load ``R(u)_a = ∫ r(u) φ_a`` is
assembled through the Batch-Map + Sparse-Reduce pipeline
(``weakform.reaction``).  Each backward-Euler step solves

    G(u) = M (u − uⁿ)/Δt + κ K u − R(u) = 0

by a fixed number of Newton iterations.  The Jacobian is exact and shares
the mass pattern:

    J(u) = M/Δt + κ K + M[−r′(u)]

where ``M[c]`` is the mass matrix weighted by the nodal coefficient ``c``,
assembled per iteration (the einsum Map, then B2 on the matrix table on a
CUDA plan); each Newton update is a :func:`~repro_torch.core.sparse_solve`,
so the trajectory differentiates.  ``r′`` is derived from ``r`` with a
pointwise ``torch.func.jvp`` unless given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core import weakform as wf
from ..core.assembly import GalerkinAssembler
from ..core.boundary import DirichletCondenser
from ..core.solvers import SolveInfo, SolverSpec, resolve_solver_spec, sparse_solve
from ..core.sparse import CSR
from ..telemetry import events
from .stepping import axpy_csr, segmented_rollout

__all__ = ["NewtonKrylovIntegrator"]


def _pointwise_derivative(fn: Callable) -> Callable:
    """r′(u) for a pointwise nonlinearity, by a ones-tangent jvp."""

    def fprime(u):
        return torch.func.jvp(fn, (u,), (torch.ones_like(u),))[1]

    return fprime


@dataclasses.dataclass
class NewtonKrylovIntegrator:
    asm: GalerkinAssembler
    mass: CSR
    stiff: CSR
    dt: float
    reaction: Callable                      # pointwise r(u), e.g. −ε²u(u²−1)
    reaction_prime: Callable | None = None  # pointwise r′(u); jvp-derived if None
    diffusion_scale: float = 1.0            # κ multiplying K
    bc: DirichletCondenser | None = None
    newton_iters: int = 3
    spec: SolverSpec | None = None          # Krylov config
    solver: str | None = None               # deprecated → spec.method
    tol: float | None = None                # deprecated → spec.tol (and atol)
    maxiter: int | None = None              # deprecated → spec.maxiter

    def __post_init__(self):
        # J is symmetric (mass-weighted terms) → CG default
        self.spec = resolve_solver_spec(
            self.spec, method=self.solver, tol=self.tol, atol=self.tol,
            maxiter=self.maxiter, default=SolverSpec(method="cg"),
            where="NewtonKrylovIntegrator")
        self.solver = self.spec.method
        self.tol = self.spec.tol
        self.maxiter = self.spec.maxiter
        if self.reaction_prime is None:
            self.reaction_prime = _pointwise_derivative(self.reaction)
        # the linear part of the Jacobian: M/Δt + κK
        self.lin_op = axpy_csr(1.0 / self.dt, self.mass, self.diffusion_scale, self.stiff)

    def residual(self, u_prev, u):
        """G(u) at the implicit stage, projected to the free DoFs."""
        react = self.asm.assemble_rhs(wf.reaction(u, self.reaction))
        r = (self.mass.matvec((u - u_prev) / self.dt)
             + self.diffusion_scale * self.stiff.matvec(u) - react)
        return r if self.bc is None else self.bc.project_residual(r)

    def _jacobian(self, u) -> CSR:
        # M[−r′(u)] shares the mass pattern: a nodal-coefficient mass assembly
        jac_vals = self.asm.assemble(wf.mass(-self.reaction_prime(u))).vals
        jac = self.lin_op.with_vals(self.lin_op.vals + jac_vals)
        return jac if self.bc is None else self.bc.apply_matrix_only(jac)

    def step(self, u_prev, return_info=False):
        """One backward-Euler step: ``newton_iters`` Newton updates.
        ``return_info=True`` also returns a
        :class:`~repro_torch.core.SolveInfo` over the Newton iterations: the
        Krylov iterations summed, the last residual, all converged."""
        u, infos = u_prev, []
        for _ in range(self.newton_iters):
            du, info = sparse_solve(self._jacobian(u), self.residual(u_prev, u), self.spec,
                                    return_info=True)
            u = u - du
            infos.append(info)
        if self.bc is not None:
            m = self.bc.free_mask.to(u.dtype)
            u = u * m + u_prev * (1.0 - m)
        if return_info:
            return u, SolveInfo(sum(i.iters for i in infos), infos[-1].residual,
                                all(i.converged for i in infos))
        return u

    def rollout(self, u0, n_steps: int, *, checkpoint_every: int | None = None,
                return_info: bool = False):
        """Run ``n_steps`` implicit steps; returns ``(n_steps, N)``.
        ``return_info=True`` returns ``(traj, info)`` with per-step
        ``(n_steps,)`` :class:`~repro_torch.core.SolveInfo` host tensors
        (each step's Newton iterations aggregated, see :meth:`step`)."""

        def body(u, _):
            if return_info:
                u_new, info = self.step(u, return_info=True)
                return u_new, (u_new, info)
            u_new = self.step(u)
            return u_new, u_new

        _, out = segmented_rollout(body, u0, None, n_steps, checkpoint_every)
        if return_info:
            traj, info = out
            events.check_convergence(info, where="newton.rollout")
            events.record_solve("newton.rollout", info, method=self.spec.method,
                                backend="csr", precond=self.spec.precond_name)
            return traj, info
        return out
