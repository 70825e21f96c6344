"""Newmark-β time integration for second-order hyperbolic problems (wave,
elastodynamics).

The torch port of ``repro.transient.newmark``.  Semidiscrete system
M ü + K u = F(t), stepped in predictor–corrector form for the
acceleration:

    u*  = uⁿ + Δt vⁿ + ½Δt²(1−2β) aⁿ
    v*  = vⁿ + Δt(1−γ) aⁿ
    (M + βΔt²K) aⁿ⁺¹ = Fⁿ⁺¹ − K u*
    uⁿ⁺¹ = u* + βΔt² aⁿ⁺¹,   vⁿ⁺¹ = v* + γΔt aⁿ⁺¹

β = ¼, γ = ½ conserves the discrete energy ½(vᵀMv + uᵀKu) for F = 0.  The
effective operator is formed once; each step is one differentiable
``sparse_solve``, and the stiffness applies K·u go through the matvec
registry (``backend``).  Dirichlet: homogeneous or fixed-in-time
constraints through a :class:`DirichletCondenser`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.boundary import DirichletCondenser
from ..core.matvec import make_matvec
from ..core.solvers import SolverSpec, resolve_solver_spec, sparse_solve
from ..core.sparse import CSR
from ..telemetry import events
from .stepping import axpy_csr, segmented_rollout

__all__ = ["NewmarkIntegrator"]


@dataclasses.dataclass
class NewmarkIntegrator:
    mass: CSR
    stiff: CSR
    dt: float
    beta: float = 0.25
    gamma: float = 0.5
    bc: DirichletCondenser | None = None
    spec: SolverSpec | None = None  # Krylov config (method/tol/precond/...)
    solver: str | None = None       # deprecated → spec.method
    tol: float | None = None        # deprecated → spec.tol (and atol)
    maxiter: int | None = None      # deprecated → spec.maxiter
    # the backend of the stiffness applies K·u (two per step with the
    # initial acceleration's); the solve itself is sparse_solve
    backend: str = "csr"

    def __post_init__(self):
        # M + βΔt²K is SPD → CG default
        self.spec = resolve_solver_spec(
            self.spec, method=self.solver, tol=self.tol, atol=self.tol,
            maxiter=self.maxiter, default=SolverSpec(method="cg"),
            where="NewmarkIntegrator")
        self.solver = self.spec.method
        self.tol = self.spec.tol
        self.maxiter = self.spec.maxiter
        self.lhs_full = axpy_csr(1.0, self.mass, self.beta * self.dt**2, self.stiff)
        self._stiff_mv = make_matvec(self.stiff, self.backend)
        if self.bc is not None:
            self.lhs = self.bc.apply_matrix_only(self.lhs_full)
            self.mass_c = self.bc.apply_matrix_only(self.mass)
        else:
            self.lhs = self.lhs_full
            self.mass_c = self.mass

    def _mask(self, r):
        return r if self.bc is None else self.bc.project_residual(r)

    def initial_acceleration(self, u0, load0=None):
        """Consistent a₀ from M a₀ = F(0) − K u₀ (condensed)."""
        r = -self._stiff_mv(u0)
        if load0 is not None:
            r = r + load0
        return sparse_solve(self.mass_c, self._mask(r), self.spec)

    def step(self, u, v, a, load=None, return_info=False):
        dt, beta, gamma = self.dt, self.beta, self.gamma
        u_star = u + dt * v + 0.5 * dt**2 * (1 - 2 * beta) * a
        v_star = v + dt * (1 - gamma) * a
        rhs = -self._stiff_mv(u_star)
        if load is not None:
            rhs = rhs + load
        out = sparse_solve(self.lhs, self._mask(rhs), self.spec, return_info=return_info)
        a_new, info = out if return_info else (out, None)
        u_new = u_star + beta * dt**2 * a_new
        if self.bc is not None:
            # constrained DoFs stay at their (initial) boundary values
            free = self.bc.free_mask.to(u.dtype)
            u_new = u_new * free + u * (1.0 - free)
        v_new = v_star + gamma * dt * a_new
        if return_info:
            return u_new, v_new, a_new, info
        return u_new, v_new, a_new

    def rollout(self, u0, n_steps: int, *, v0=None, loads=None, load0=None,
                checkpoint_every: int | None = None, return_velocity: bool = False,
                return_info: bool = False):
        """Run ``n_steps`` Newmark steps; returns ``(n_steps, N)``
        displacements (u0 excluded), or ``(u_traj, v_traj)`` when
        ``return_velocity``.  ``loads``: None | (N,) | (n_steps, N), row
        ``n`` being Fⁿ⁺¹.  ``load0`` is F(0) for the consistent initial
        acceleration; it defaults to ``loads`` when static and to
        ``loads[0]`` when per-step.

        ``return_info=True`` appends a
        :class:`~repro_torch.core.SolveInfo` of ``(n_steps,)`` host
        tensors."""
        v0 = torch.zeros_like(u0) if v0 is None else v0
        loads = None if loads is None else torch.as_tensor(loads, dtype=u0.dtype,
                                                           device=u0.device)
        scan_loads = loads is not None and loads.dim() == 2
        if load0 is None and loads is not None:
            load0 = loads[0] if scan_loads else loads
        a0 = self.initial_acceleration(u0, load0)

        def body(carry, x):
            u, v, a = carry
            f = x if scan_loads else loads
            if return_info:
                u, v, a, info = self.step(u, v, a, load=f, return_info=True)
                return (u, v, a), (u, v, info)
            u, v, a = self.step(u, v, a, load=f)
            return (u, v, a), (u, v)

        _, ys = segmented_rollout(body, (u0, v0, a0), loads if scan_loads else None,
                                  n_steps, checkpoint_every)
        if return_info:
            u_traj, v_traj, info = ys
            events.check_convergence(info, where="newmark.rollout")
            events.record_solve("newmark.rollout", info, method=self.spec.method,
                                backend=self.backend, precond=self.spec.precond_name)
            out = (u_traj, v_traj) if return_velocity else u_traj
            return out, info
        u_traj, v_traj = ys
        return (u_traj, v_traj) if return_velocity else u_traj
