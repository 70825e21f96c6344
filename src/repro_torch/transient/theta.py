"""θ-method time integration for parabolic problems (heat, diffusion).

The torch port of ``repro.transient.theta``.  Semidiscrete system
M u̇ + K u = F(t), u(0) = u₀, stepped by

    (M + θ Δt K) uⁿ⁺¹ = (M − (1−θ) Δt K) uⁿ + Δt Fⁿ⁺ᶿ

θ = 1 is backward Euler, θ = ½ Crank–Nicolson.  Both effective operators
share the pattern of M and K and are formed once, outside the time loop.
With ``backend="csr"`` each step solves through
:func:`~repro_torch.core.sparse_solve`, so the rollout differentiates with
respect to the operator values and the initial condition (adjoint solves
in the backward pass), with optional checkpoint segmentation.  The ELL
backends (``"ell"``, ``"ell_pallas"``, ``"ell_stream"``) run the inner
matvecs through the registry's kernels in a plain Krylov loop warm-started
at uⁿ: the fast forward path.  ``"matfree"`` steps on matrix-free
operators (:meth:`ThetaIntegrator.from_form`) through the differentiable
:func:`~repro_torch.core.matfree_solve`: no CSR values are formed;
``"matfree_sharded"`` splits both operators' applies over a mesh of ranks
(:class:`~repro_torch.core.ShardedMatFreeOperator`).
Dirichlet data may vary per step: the condensed operator is formed once
and only the right-hand-side lift runs in the loop.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.boundary import DirichletCondenser
from ..core.matvec import make_matvec
from ..core.operator import MatFreeOperator, ShardedMatFreeOperator, matfree_operator
from ..core.solvers import (
    SolverSpec,
    _method,
    make_preconditioner,
    matfree_solve,
    resolve_solver_spec,
    sparse_solve,
)
from ..core.sparse import CSR
from ..telemetry import annotate, events
from .stepping import axpy_csr, segmented_rollout

__all__ = ["ThetaIntegrator", "BACKWARD_EULER", "CRANK_NICOLSON"]

BACKWARD_EULER = 1.0
CRANK_NICOLSON = 0.5

# backends whose step is a differentiable solve on the integrator's operators
_SOLVE_BACKENDS = ("csr", "matfree", "matfree_sharded")
_MATFREE_BACKENDS = ("matfree", "matfree_sharded")


@dataclasses.dataclass
class ThetaIntegrator:
    """One-step θ-method over pre-assembled CSR mass/stiffness operators
    (or the two effective operators, via :meth:`from_form`).

    ``backend`` selects the inner-loop apply from the matvec registry
    (:mod:`repro_torch.core.matvec`): ``"csr"`` (default) keeps the rollout
    differentiable through ``sparse_solve``; any other registered backend
    (``"ell"``, ``"ell_pallas"``, ``"ell_stream"``) runs the right-hand
    side and the Krylov matvecs through that backend, warm-started at the
    previous state (forward only).  ``"matfree"`` (build with
    :meth:`from_form`) steps on matrix-free operators through the
    differentiable :func:`~repro_torch.core.matfree_solve`, and
    ``"matfree_sharded"`` shards both matrix-free operators over the
    default mesh of ranks (:meth:`MatFreeOperator.sharded`), so every
    step's solve and its adjoint span the mesh (every rank steps)."""

    mass: CSR | None
    stiff: CSR | None
    dt: float
    theta: float = BACKWARD_EULER
    bc: DirichletCondenser | None = None
    spec: SolverSpec | None = None  # Krylov config (method/tol/precond/...)
    solver: str | None = None       # deprecated → spec.method
    tol: float | None = None        # deprecated → spec.tol (and atol)
    maxiter: int | None = None      # deprecated → spec.maxiter
    backend: str = "csr"
    # effective operators; pass directly (see from_form) or leave None to
    # have them formed from mass/stiff (same pattern as M / K)
    lhs_full: CSR | MatFreeOperator | ShardedMatFreeOperator | None = None
    rhs_op: CSR | MatFreeOperator | ShardedMatFreeOperator | None = None

    def __post_init__(self):
        # M + θΔtK is SPD for θ ≥ 0 → CG default
        self.spec = resolve_solver_spec(
            self.spec, method=self.solver, tol=self.tol, atol=self.tol,
            maxiter=self.maxiter, default=SolverSpec(method="cg"),
            where="ThetaIntegrator")
        self.solver = self.spec.method
        self.tol = self.spec.tol
        self.maxiter = self.spec.maxiter
        if self.lhs_full is None:
            self.lhs_full = axpy_csr(1.0, self.mass, self.theta * self.dt, self.stiff)
        if self.rhs_op is None:
            self.rhs_op = axpy_csr(1.0, self.mass, -(1.0 - self.theta) * self.dt, self.stiff)
        if self.backend == "matfree_sharded":
            if isinstance(self.lhs_full, MatFreeOperator):
                self.lhs_full = self.lhs_full.sharded()
            if isinstance(self.rhs_op, MatFreeOperator):
                self.rhs_op = self.rhs_op.sharded()
        if self.bc is None:
            self.lhs = self.lhs_full
        elif isinstance(self.lhs_full, CSR):
            self.lhs = self.bc.apply_matrix_only(self.lhs_full)
        else:  # matrix-free: condensation as an apply wrapper
            self.lhs = self.lhs_full.condensed(self.bc)
        if self.backend not in _SOLVE_BACKENDS:
            self._lhs_mv = make_matvec(self.lhs, self.backend)
            self._rhs_mv = make_matvec(self.rhs_op, self.backend)
            self._precond = make_preconditioner(self.lhs, self.spec.precond)

    @classmethod
    def from_form(cls, asm, form, dt, *, theta: float = BACKWARD_EULER,
                  mass_coeff=None, bc=None, **kw) -> "ThetaIntegrator":
        """Build the θ-step operators with two fused assemblies:
        ``lhs = assemble(mass(c) + θΔt·form)`` and
        ``rhs_op = assemble(mass(c) − (1−θ)Δt·form)``.  A form with an
        advection term makes the lhs nonsymmetric, so the solver then
        defaults to BiCGSTAB (CG otherwise).  With ``backend="matfree"``
        both are matrix-free operators
        (:func:`~repro_torch.core.matfree_operator`) instead, sharded with
        ``backend="matfree_sharded"``."""
        from ..core import weakform as wf

        terms = wf._as_form(form).terms
        if kw.get("spec") is None and kw.get("solver") is None:
            kw["spec"] = SolverSpec(
                method="bicgstab" if any(t.kind == "advection" for t in terms) else "cg")
        lhs_form = wf.mass(mass_coeff) + (theta * dt) * form
        rhs_form = wf.mass(mass_coeff) + (-(1.0 - theta) * dt) * form
        if kw.get("backend") in _MATFREE_BACKENDS:
            lhs, rhs = matfree_operator(asm.plan, lhs_form), matfree_operator(asm.plan, rhs_form)
        else:
            lhs, rhs = asm.assemble(lhs_form), asm.assemble(rhs_form)
        return cls(None, None, dt, theta=theta, bc=bc, lhs_full=lhs, rhs_op=rhs, **kw)

    # -- one step --------------------------------------------------------------
    def step(self, u, load=None, bc_values=None, return_info=False):
        """Advance uⁿ → uⁿ⁺¹.  ``load`` is the assembled Fⁿ⁺ᶿ; ``bc_values``
        the Dirichlet data at tⁿ⁺¹ (scalar, (n_bc,), or full field).
        ``return_info=True`` also returns the step's
        :class:`~repro_torch.core.SolveInfo`.  While a trace is taken the
        step is a ``tg.theta.step`` range and its right-hand side a
        ``tg.theta.rhs`` range inside it."""
        with annotate("tg.theta.step", profiler_only=True):
            with annotate("tg.theta.rhs", profiler_only=True):
                b = self._rhs(u, load, bc_values)
            if self.backend == "csr":
                return sparse_solve(self.lhs, b, self.spec, return_info=return_info)
            if self.backend in _MATFREE_BACKENDS:
                return matfree_solve(self.lhs, b, self.spec, return_info=return_info)
            u_new, info = _method(self.spec.method)(
                self._lhs_mv, b, x0=u, tol=self.spec.tol, atol=self.spec.atol,
                maxiter=self.spec.maxiter, m=self._precond)
        return (u_new, info) if return_info else u_new

    def _rhs(self, u, load, bc_values):
        """(M − (1−θ)Δt K) uⁿ + Δt Fⁿ⁺ᶿ, condensed."""
        b = self.rhs_op.matvec(u) if self.backend in _SOLVE_BACKENDS else self._rhs_mv(u)
        if load is not None:
            b = b + self.dt * load
        if self.bc is None:
            if bc_values is not None:
                raise ValueError("bc_values given but no DirichletCondenser (bc=)")
            return b
        if bc_values is None:
            # homogeneous Dirichlet: the lift reduces to masking
            return self.bc.project_residual(b)
        return self.bc.lift(self.lhs_full, b, bc_values)

    # -- rollout ---------------------------------------------------------------
    def rollout(self, u0, n_steps: int, *, loads=None, bc_values=None,
                checkpoint_every: int | None = None, return_info: bool = False):
        """Run ``n_steps`` steps from ``u0``; returns ``(n_steps, N)`` (u0
        excluded).

        ``loads``: None | (N,) static | (n_steps, N) per-step.
        ``bc_values``: None | scalar | (n_bc,) or (N,) static | (n_steps,
        n_bc) per-step (Dirichlet data at tⁿ⁺¹).  ``u0`` is taken as is:
        with Dirichlet data it must satisfy u0[bc] = g(t0).

        ``return_info=True`` returns ``(traj, info)``, ``info`` a
        :class:`~repro_torch.core.SolveInfo` of ``(n_steps,)`` host tensors
        (iterations, residuals, converged flags per step)."""
        as_t = (lambda a: None if a is None
                else torch.as_tensor(a, dtype=u0.dtype, device=u0.device))
        loads, bcv = as_t(loads), as_t(bc_values)
        scan_loads = loads is not None and loads.dim() == 2
        scan_bcv = bcv is not None and bcv.dim() == 2
        if bcv is not None and self.bc is None:
            raise ValueError("bc_values given but no DirichletCondenser (bc=)")
        if bcv is not None:
            n_bc, n = self.bc.bc_dofs.shape[0], self.bc.num_dofs
            ok = (bcv.dim() == 0
                  or (bcv.dim() == 1 and bcv.shape[0] in (n_bc, n))
                  or (bcv.dim() == 2 and tuple(bcv.shape) == (n_steps, n_bc)))
            if not ok:
                raise ValueError(
                    f"bc_values shape {tuple(bcv.shape)} not understood: expected a scalar, "
                    f"({n_bc},) / ({n},) static data, or ({n_steps}, {n_bc}) per-step data")
        xs = {}
        if scan_loads:
            xs["f"] = loads
        if scan_bcv:
            xs["g"] = bcv

        def body(u, x):
            f = x["f"] if scan_loads else loads
            g = x["g"] if scan_bcv else bcv
            if return_info:
                u_new, info = self.step(u, load=f, bc_values=g, return_info=True)
                return u_new, (u_new, info)
            u_new = self.step(u, load=f, bc_values=g)
            return u_new, u_new

        _, out = segmented_rollout(body, u0, xs or None, n_steps, checkpoint_every)
        if return_info:
            traj, info = out
            events.check_convergence(info, where="theta.rollout")
            events.record_solve("theta.rollout", info, method=self.spec.method,
                                backend=self.backend, precond=self.spec.precond_name)
            return traj, info
        return out
