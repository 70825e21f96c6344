"""TensorMesh — the numerical PDE solver built on TensorGalerkin (paper §3 i).

The torch port of ``repro.fem.tensormesh`` (Poisson and steady
advection–diffusion; elasticity, mixed boundary conditions and the batched
solves come in later slices).  Problem classes own (mesh → space →
assembler → condenser) and expose ``solve()``: assembly plus a
preconditioned Krylov solve.  They run on the CUDA device unless built with
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import telemetry
from ..core import (
    DirichletCondenser,
    FunctionSpace,
    GalerkinAssembler,
    SolverSpec,
    make_matvec,
    make_preconditioner,
    make_residual,
    resolve_solver_spec,
    weakform as wf,
)
from ..core.mesh import Mesh, element_for_mesh
from ..core.solvers import _method
from ..telemetry import events

__all__ = ["PoissonProblem", "AdvectionDiffusionProblem"]


@dataclasses.dataclass
class _SolveResult:
    u: torch.Tensor
    iters: int
    residual: float
    converged: bool = True


class _ProblemBase:
    method = "cg"
    backend = "ell"  # the ELL SpMV kernel in the Krylov loop

    def __init__(self, mesh: Mesh, degree: int = 1, quad_order: int | None = None,
                 device=None):
        self.mesh = mesh
        self.space = FunctionSpace(mesh, element_for_mesh(mesh, degree))
        self.asm = GalerkinAssembler(self.space, quad_order, device)
        self.device = self.asm.device
        self.bc = DirichletCondenser(self.asm, self.space.boundary_dofs())

    @property
    def plan(self):
        """The problem's :class:`~repro_torch.core.AssemblyPlan`."""
        return self.asm.plan

    def _spec(self, spec, tol, maxiter, where) -> SolverSpec:
        """One :class:`~repro_torch.core.SolverSpec` per solve: ``spec=``
        wins, legacy ``tol=``/``maxiter=`` kwargs shim into it (deprecated)."""
        return resolve_solver_spec(
            spec, tol=tol, maxiter=maxiter,
            default=SolverSpec(method=self.method),
            where=f"{type(self).__name__}.{where}")

    def _solve_system(self, k, f, spec: SolverSpec, backend=None, return_info=False):
        """Krylov solve on an assembled operator with the inner matvec from
        the registry (:mod:`repro_torch.core.matvec`).  A ``maxiter`` exit
        is reported through :func:`repro_torch.telemetry.check_convergence`
        and the ``converged`` flag; the relative residual is computed with
        the backend's fused residual."""
        be = backend or self.backend
        t0 = time.perf_counter()
        u, info = _method(spec.method)(
            make_matvec(k, be), f, m=make_preconditioner(k, spec.precond),
            tol=spec.tol, atol=spec.atol, maxiter=spec.maxiter)
        where = f"{type(self).__name__}.solve"
        events.check_convergence(info, where=where)
        if telemetry.is_enabled():
            events.record_solve(where, info, method=spec.method, backend=be,
                                precond=spec.precond_name,
                                wall_us=(time.perf_counter() - t0) * 1e6)
        r = make_residual(k, be)(u, f)
        rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(f))
        res = _SolveResult(u, info.iters, rel, info.converged)
        return (res, info) if return_info else res


class PoissonProblem(_ProblemBase):
    """−∇·(ρ∇u) = f with homogeneous Dirichlet BCs (paper Benchmark I)."""

    def assemble(self, rho=None, f=1.0):
        k = self.asm.assemble(wf.diffusion(rho))
        load = self.asm.assemble_rhs(wf.source(f))
        return self.bc.apply(k, load)

    def solve(self, rho=None, f=1.0, spec: SolverSpec | None = None,
              tol=None, maxiter=None, backend=None, return_info=False):
        """Assemble and solve; solver knobs come in as one
        :class:`~repro_torch.core.SolverSpec` (``spec=``; legacy ``tol=`` /
        ``maxiter=`` kwargs still work but are deprecated).  ``backend``
        names the Krylov matvec and residual of the registry: ``"ell"``
        (default, broadcast-plan kernels), ``"ell_stream"`` (streaming
        kernels) or ``"csr"``.
        ``return_info=True`` appends the raw
        :class:`~repro_torch.core.SolveInfo`."""
        spec = self._spec(spec, tol, maxiter, "solve")
        k, load = self.assemble(rho, f)
        return self._solve_system(k, load, spec, backend=backend, return_info=return_info)


class AdvectionDiffusionProblem(_ProblemBase):
    """−∇·(ε∇u) + β·∇u = f with Dirichlet BCs — ``diffusion(eps) +
    advection(beta)`` in one fused assembly, BiCGSTAB since K is
    nonsymmetric."""

    method = "bicgstab"

    def _beta(self, beta) -> torch.Tensor:
        if isinstance(beta, torch.Tensor):
            return beta.to(self.device)
        return torch.as_tensor(beta, dtype=torch.float64, device=self.device)

    def assemble(self, eps=1.0, beta=(1.0, 0.0), f=1.0, dirichlet_values=0.0):
        form = wf.diffusion(eps) + wf.advection(self._beta(beta))
        k = self.asm.assemble(form)
        load = self.asm.assemble_rhs(wf.source(f))
        return self.bc.apply(k, load, dirichlet_values)

    def solve(self, eps=1.0, beta=(1.0, 0.0), f=1.0, dirichlet_values=0.0,
              spec: SolverSpec | None = None, tol=None, maxiter=None,
              backend=None, return_info=False):
        spec = self._spec(spec, tol, maxiter, "solve")
        k, load = self.assemble(eps, beta, f, dirichlet_values)
        return self._solve_system(k, load, spec, backend=backend, return_info=return_info)
