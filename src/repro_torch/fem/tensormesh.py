"""TensorMesh — the numerical PDE solver built on TensorGalerkin (paper §3 i).

The torch port of ``repro.fem.tensormesh``.  Problem classes own (mesh →
space → assembler → condenser) and expose:

* ``solve()`` — assembly plus a preconditioned Krylov solve; with
  ``backend="matfree"`` only the load is assembled and the Krylov loop
  applies the form matrix-free (gather, per-element action, B2 scatter),
  and with ``backend="matfree_sharded"`` every apply (the Jacobi
  diagonal and the right-hand-side lift too) is split over the ranks of
  the default mesh (:class:`~repro_torch.core.ShardedMatFreeOperator`);
* ``PoissonProblem.solve_batch(fs)`` — many-query batched right-hand sides
  (SM B.1.4): the matrix assembled once, the B loads in one batched
  assembly, one CG solve per instance;
* ``PoissonProblem.solve_coeff_batch(rhos)`` — a family of coefficient
  fields in one batched assembly (one B1 and one B2 launch), solved with
  the differentiable ``sparse_solve_batched``.

They run on the CUDA device unless built with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import telemetry
from ..core import (
    DirichletCondenser,
    FacetAssembler,
    FunctionSpace,
    GalerkinAssembler,
    SolverSpec,
    assemble_batched,
    assemble_rhs,
    assemble_rhs_batched,
    condense,
    forms,
    make_matvec,
    make_preconditioner,
    make_residual,
    matfree_operator,
    resolve_solver_spec,
    sparse_solve_batched,
    vertex_split,
    weakform as wf,
)
from ..core.mesh import Mesh, element_for_mesh
from ..core.solvers import _method, host_read
from ..telemetry import events

__all__ = [
    "PoissonProblem",
    "AdvectionDiffusionProblem",
    "ElasticityProblem",
    "MixedBCPoisson",
]


# the backends that apply the form matrix-free (only the load is assembled)
_MATFREE = ("matfree", "matfree_sharded")


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

    def _solve_system(self, k, f, spec: SolverSpec, backend=None, return_info=False,
                      condensed=False):
        """Krylov solve on an operator (assembled, or matrix-free on the
        ``matfree`` backend) with the inner matvec from the registry
        (:mod:`repro_torch.core.matvec`); with ``condensed`` (a matrix-free
        operator on a P2 space) the Krylov iteration runs on the interface
        Schur complement of :func:`~repro_torch.core.condense`.  A
        ``maxiter`` exit is reported through
        :func:`repro_torch.telemetry.check_convergence` and the
        ``converged`` flag; the relative residual is computed with the
        backend's fused residual."""
        be = backend or self.backend
        t0 = time.perf_counter() if telemetry.is_enabled() else None
        if condensed:
            u, info = condense(k, vertex_split(self.space)).solve(f, spec)
        else:
            u, info = _method(spec.method)(
                make_matvec(k, be), f, m=make_preconditioner(k, spec.precond),
                tol=spec.tol, atol=spec.atol, maxiter=spec.maxiter)
        where = f"{type(self).__name__}.solve"
        events.check_convergence(info, where=where)
        if t0 is not None:
            events.record_solve(where, info, method=spec.method, backend=be,
                                precond="condensed" if condensed else spec.precond_name,
                                wall_us=(time.perf_counter() - t0) * 1e6)
        with telemetry.annotate("tg.solve.residual", profiler_only=True):
            r = make_residual(k, be)(u, f)
            rel = host_read(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(f))
        res = _SolveResult(u, info.iters, rel, info.converged)
        return (res, info) if return_info else res

    def _solve_matfree(self, form, load, spec: SolverSpec, dirichlet_values=0.0,
                       return_info=False, store="context", condensed=False, sharded=False):
        """Matrix-free Krylov solve: the operator applies ``form`` straight
        from the plan (:func:`~repro_torch.core.matfree_operator`, ``store``
        its memory/speed point), Jacobi from a diagonal-only assembly,
        Dirichlet condensation as an apply wrapper; the right-hand-side lift
        runs one apply of the uncondensed operator.  No global values are
        formed.  ``sharded=True`` splits every apply (the Jacobi diagonal
        and the lift too) over the ranks of the default mesh, so one Krylov
        solve spans them all (every rank calls it).  ``condensed=True``
        statically condenses the edge DoFs of a P2 space and iterates on
        the vertex Schur complement.  (For a differentiable solve use
        :func:`~repro_torch.core.matfree_solve` or
        :func:`~repro_torch.core.condensed_solve` on the same operator.)"""
        op_full = matfree_operator(self.plan, form, store=store)
        if sharded:
            op_full = op_full.sharded()
        if isinstance(dirichlet_values, (int, float)) and dirichlet_values == 0.0:
            f = self.bc.project_residual(load)  # homogeneous: the lift is a mask
        else:
            f = self.bc.lift(op_full, load, dirichlet_values)
        return self._solve_system(op_full.condensed(self.bc), f, spec,
                                  backend="matfree_sharded" if sharded else "matfree",
                                  return_info=return_info, condensed=condensed)


class PoissonProblem(_ProblemBase):
    """−∇·(ρ∇u) = f with homogeneous Dirichlet BCs (paper Benchmark I)."""

    def assemble(self, rho=None, f=1.0):
        k = self.asm.assemble(wf.diffusion(rho))
        load = self.asm.assemble_rhs(wf.source(f))
        return self.bc.apply(k, load)

    def solve(self, rho=None, f=1.0, spec: SolverSpec | None = None,
              tol=None, maxiter=None, backend=None, return_info=False,
              condensed=False, store="context"):
        """Assemble and solve; solver knobs come in as one
        :class:`~repro_torch.core.SolverSpec` (``spec=``; legacy ``tol=`` /
        ``maxiter=`` kwargs still work but are deprecated).  ``backend``
        names the Krylov matvec and residual of the registry: ``"ell"``
        (default, broadcast-plan kernels), ``"ell_stream"`` (streaming
        kernels), ``"csr"``, ``"matfree"`` (no matrix assembly: only the
        load is assembled, and ``store`` picks the matrix-free operator's
        store), or ``"matfree_sharded"`` (``matfree`` with every apply
        split over the ranks of the default mesh).  ``condensed=True``
        (matrix-free backends, P2) runs the Krylov iteration on the
        statically condensed interface system.
        ``return_info=True`` appends the raw
        :class:`~repro_torch.core.SolveInfo`."""
        spec = self._spec(spec, tol, maxiter, "solve")
        if backend in _MATFREE:
            load = self.asm.assemble_rhs(wf.source(f))
            return self._solve_matfree(wf.diffusion(rho), load, spec, return_info=return_info,
                                       store=store, condensed=condensed,
                                       sharded=backend == "matfree_sharded")
        if condensed:
            raise ValueError("condensed=True needs a matfree backend")
        k, load = self.assemble(rho, f)
        return self._solve_system(k, load, spec, backend=backend, return_info=return_info)

    # -- many-query batched data generation (SM B.1.4) ------------------------
    def solve_batch(self, f_batch, rho=None, tol=1e-10, maxiter=2000):
        """Solve K u_b = F(f_b) for a batch of nodal source fields
        ``f_batch (B, num_dofs)``: K assembled and condensed once, the B
        loads in one batched assembly, then Jacobi-preconditioned CG on each
        instance with the problem's matvec backend (``ell``: B3).  Returns
        ``(u (B, num_dofs), iters (B,))``, as the reference."""
        k = self.bc.apply_matrix_only(self.asm.assemble(wf.diffusion(rho)))
        m = make_preconditioner(k, "jacobi")
        matvec = make_matvec(k, self.backend)
        fb = torch.as_tensor(f_batch, dtype=torch.float64, device=self.device)
        loads = self.bc.project_residual(
            self.asm.assemble_rhs_batched(wf.source(fb[0]), leaves_batch=(fb, None)))
        us, iters = [], []
        for load in loads:
            u, info = _method("cg")(matvec, load, m=m, tol=tol, maxiter=maxiter)
            us.append(u)
            iters.append(info.iters)
        return torch.stack(us), torch.tensor(iters)

    def solve_coeff_batch(self, rho_batch, f=1.0, tol=1e-10, maxiter=10000):
        """Solve the *family* −∇·(ρ_b ∇u_b) = f for a batch of per-element
        coefficient fields ``rho_batch (B, E)``: ONE batched assembly
        (``assemble_batched`` → shared-pattern ``BatchedCSR``: one B1 and
        one B2 launch on the card), the shared-mask condensation, and the
        differentiable ``sparse_solve_batched``.  Returns ``(B, num_dofs)``;
        gradients flow to ``rho_batch``."""
        rho_batch = torch.as_tensor(rho_batch, dtype=torch.float64, device=self.device)
        kb = assemble_batched(self.plan, wf.diffusion(rho_batch[0]),
                              leaves_batch=(rho_batch, None))
        kc = self.bc.apply_matrix_only(kb)
        load = self.bc.project_residual(assemble_rhs(self.plan, wf.source(f)))
        return sparse_solve_batched(
            kc, load, SolverSpec(method="cg", tol=tol, atol=tol, maxiter=maxiter))


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
        if backend in _MATFREE:
            form = wf.diffusion(eps) + wf.advection(self._beta(beta))
            load = self.asm.assemble_rhs(wf.source(f))
            return self._solve_matfree(form, load, spec, dirichlet_values=dirichlet_values,
                                       return_info=return_info,
                                       sharded=backend == "matfree_sharded")
        k, load = self.assemble(eps, beta, f, dirichlet_values)
        return self._solve_system(k, load, spec, backend=backend, return_info=return_info)


class ElasticityProblem(_ProblemBase):
    """Isotropic linear elasticity, constant body force (paper Benchmark II):
    a vector P1 space (``value_size = d``), clamped on the whole boundary,
    BiCGSTAB + Jacobi."""

    method = "bicgstab"

    def __init__(self, mesh: Mesh, e_mod=1.0, nu=0.3, device=None):
        self.mesh = mesh
        self.space = FunctionSpace(mesh, element_for_mesh(mesh), value_size=mesh.dim)
        self.asm = GalerkinAssembler(self.space, device=device)
        self.device = self.asm.device
        self.bc = DirichletCondenser(self.asm, self.space.boundary_dofs())
        self.lam = e_mod * nu / ((1 + nu) * (1 - 2 * nu))
        self.mu = e_mod / (2 * (1 + nu))

    def _body_force(self, body_force) -> torch.Tensor:
        bf = torch.ones(self.mesh.dim) if body_force is None else body_force
        return torch.as_tensor(bf, dtype=torch.float64, device=self.device)

    def assemble(self, body_force=None, scale=None):
        k = self.asm.assemble(wf.elasticity(self.lam, self.mu, scale=scale))
        f = self.asm.assemble_rhs(wf.source(self._body_force(body_force)))
        return self.bc.apply(k, f)

    def solve(self, body_force=None, spec: SolverSpec | None = None,
              tol=None, maxiter=None, backend=None, return_info=False):
        spec = self._spec(spec, tol, maxiter, "solve")
        if backend in _MATFREE:
            load = self.asm.assemble_rhs(wf.source(self._body_force(body_force)))
            return self._solve_matfree(wf.elasticity(self.lam, self.mu), load, spec,
                                       return_info=return_info,
                                       sharded=backend == "matfree_sharded")
        k, f = self.assemble(body_force)
        return self._solve_system(k, f, spec, backend=backend, return_info=return_info)


class MixedBCPoisson(_ProblemBase):
    """Poisson with simultaneous Dirichlet + Neumann + Robin boundary parts
    (paper SM B.1.5).  Boundary parts are selected by coordinate predicates
    on the facet centres; Neumann/Robin route through the same Map-Reduce
    (:class:`~repro_torch.core.FacetAssembler`), and the Robin matrix joins
    the diffusion matrix in one assembly (B1 for the volume Map, B2 for the
    volume and facet Reduces)."""

    method = "bicgstab"

    def __init__(self, mesh: Mesh, dirichlet_pred, neumann_pred=None, robin_pred=None,
                 device=None):
        self.mesh = mesh
        self.space = FunctionSpace(mesh, element_for_mesh(mesh))
        self.asm = GalerkinAssembler(self.space, device=device)
        self.device = self.asm.device

        facets = mesh.boundary_facets()
        centers = mesh.points[facets].mean(axis=1)
        d_mask = dirichlet_pred(centers)
        n_mask = neumann_pred(centers) if neumann_pred else np.zeros(len(facets), bool)
        r_mask = robin_pred(centers) if robin_pred else np.zeros(len(facets), bool)
        # Dirichlet wins on overlaps; remaining facets default to Dirichlet
        n_mask &= ~d_mask
        r_mask &= ~(d_mask | n_mask)
        self.d_facets = facets[d_mask | ~(n_mask | r_mask)]
        self.n_facets = facets[n_mask]
        self.r_facets = facets[r_mask]

        self.bc = DirichletCondenser(self.asm, np.unique(self.d_facets))

        def facet_assembler(f):
            return (FacetAssembler(self.space, f, volume_routing=self.asm.mat_routing,
                                   device=self.device) if len(f) else None)

        self._fa_n = facet_assembler(self.n_facets)
        self._fa_r = facet_assembler(self.r_facets)
        # quadrature contexts, built once: callables are evaluated on them
        # once per solve and enter the assembly as per-quadrature values
        self._vol_ctx = self.asm.plan.quadrature_points()
        self._ctx_n = self._fa_n.context() if self._fa_n is not None else None
        self._ctx_r = self._fa_r.context() if self._fa_r is not None else None

    def solve(self, f, g_neumann=None, robin_alpha=1.0, g_robin=None,
              dirichlet_values=None, rho=None,
              spec: SolverSpec | None = None, tol=None, maxiter=None,
              backend=None, return_info=False):
        spec = self._spec(spec, tol, maxiter, "solve")
        if backend in _MATFREE:
            raise NotImplementedError(
                "MixedBCPoisson has Robin facet terms, which the matrix-free "
                "apply does not support (volume terms only) — use an "
                "assembled backend ('csr'/'ell'/'ell_pallas'/'ell_stream')"
            )
        # mixed volume + boundary form → ONE CSR (Robin facet values added
        # into the volume pattern), and one RHS over the volume source and
        # the Neumann/Robin boundary loads
        if callable(rho):
            rho = forms.eval_coefficient(rho, self._vol_ctx)
        if callable(f):
            f = forms.eval_coefficient(f, self._vol_ctx)
        form = wf.diffusion(rho)
        rhs = wf.source(f)
        if self._fa_r is not None:
            form = form + wf.robin(robin_alpha, on=self._fa_r)
            if g_robin is not None:
                if callable(g_robin):
                    g_robin = forms.eval_coefficient(g_robin, self._ctx_r)
                rhs = rhs + wf.neumann(g_robin, on=self._fa_r)
        if self._fa_n is not None and g_neumann is not None:
            if callable(g_neumann):
                g_neumann = forms.eval_coefficient(g_neumann, self._ctx_n)
            rhs = rhs + wf.neumann(g_neumann, on=self._fa_n)
        k = self.asm.assemble(form)
        load = self.asm.assemble_rhs(rhs)
        bvals = 0.0
        if dirichlet_values is not None:
            pts = self.space.dof_points[self.bc.bc_dofs]
            bvals = torch.as_tensor(dirichlet_values(pts), dtype=torch.float64,
                                    device=self.device)
        kc, fc = self.bc.apply(k, load, bvals)
        return self._solve_system(kc, fc, spec, backend=backend, return_info=return_info)
