"""Physics-informed operator learning for time-dependent PDEs (paper §B.3).

The torch port of ``repro.pils.operator``.

* Wave equation:   M (Uᵏ⁺² − 2Uᵏ⁺¹ + Uᵏ)/Δt² + c² K Uᵏ⁺¹ = 0      (Eq. B.16)
* Allen–Cahn:      M (Uᵏ⁺¹ − Uᵏ)/Δt + a² K Uᵏ⁺¹ − F(Uᵏ⁺¹) = 0     (Eq. B.19)

The discrete per-step residuals define the TensorPILS operator-learning loss
(Eq. B.22); reference trajectories come from the same matrices via the
:mod:`repro_torch.transient` integrators (Newmark-β for the wave equation,
backward Euler + Newton–Krylov for Allen–Cahn).  The wave residuals of a
whole trajectory are one batched matvec over the time axis; the Allen–Cahn
residuals (a reaction load per step) run step by step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import (
    DirichletCondenser,
    FunctionSpace,
    GalerkinAssembler,
    weakform as wf,
)
from ..core.assembly import DTYPE, resolve_device
from ..core.mesh import Mesh, element_for_mesh
from ..transient import NewmarkIntegrator, NewtonKrylovIntegrator

__all__ = [
    "TimeDependentProblem",
    "random_initial_condition",
    "wave_residuals",
    "allen_cahn_residuals",
]


def _sine_field(a: torch.Tensor, points: np.ndarray, r: float, domain_scale) -> torch.Tensor:
    """The multi-frequency sine expansion of Eq. B.15 for the amplitude
    matrix ``a (K, K)``, at ``points (N, 2)``, on ``a``'s device."""
    k_modes = a.shape[0]
    pts = torch.as_tensor(points, dtype=a.dtype, device=a.device)
    x = pts[:, 0] / domain_scale
    y = pts[:, 1] / domain_scale
    ii = torch.arange(1, k_modes + 1, dtype=a.dtype, device=a.device)[:, None]
    jj = torch.arange(1, k_modes + 1, dtype=a.dtype, device=a.device)[None, :]
    amp = a * (ii**2 + jj**2) ** (-r)
    sx = torch.sin(math.pi * ii[:, :, None] * x[None, None, :])   # (K,1,N)->(K,K,N)
    sy = torch.sin(math.pi * jj[:, :, None] * y[None, None, :])
    field = torch.einsum("kl,kln,kln->n", amp, sx, sy)
    return (math.pi / k_modes**2) * field


def random_initial_condition(generator: torch.Generator, points: np.ndarray,
                             k_modes: int = 6, r: float = 0.5, domain_scale=1.0,
                             device=None) -> torch.Tensor:
    """Multi-frequency sine expansion (Eq. B.15), a ~ U[-1, 1] drawn from
    ``generator`` (on its own device)."""
    a = torch.rand((k_modes, k_modes), generator=generator, dtype=DTYPE,
                   device=generator.device) * 2.0 - 1.0
    return _sine_field(a.to(resolve_device(device)), points, r, domain_scale)


@dataclasses.dataclass
class TimeDependentProblem:
    """Owns M, K (condensed) for a mesh; provides residuals + reference
    integrators for the wave / Allen–Cahn benchmarks, on ``device`` (CUDA
    unless the caller passes ``"cpu"``).  The residuals take states with
    any leading axes (a trajectory's time axis)."""

    mesh: Mesh
    c: float = 4.0                 # wave speed
    a2: float = 1e-3               # AC diffusion a²
    eps2: float = 5.0              # AC reaction strength ε²
    dt: float = 5e-4
    device: object = None

    def __post_init__(self):
        self.space = FunctionSpace(self.mesh, element_for_mesh(self.mesh))
        self.asm = GalerkinAssembler(self.space, device=self.device)
        self.device = self.asm.device
        bdofs = self.space.boundary_dofs()
        self.bc = DirichletCondenser(self.asm, bdofs)
        self.mass = self.asm.assemble(wf.mass())
        self.stiff = self.asm.assemble(wf.diffusion())
        self.interior = self.bc.free_mask.to(torch.bool)
        self.n = self.space.num_dofs
        # one stable function object for the AC reaction
        self._react_fn = lambda u: -self.eps2 * u * (u**2 - 1.0)

    # -- discrete residuals (the TensorPILS loss terms) ------------------------
    def wave_residual(self, u0, u1, u2):
        """R = M(u2 − 2u1 + u0)/Δt² + c²K u1, masked to interior rows."""
        r = self.mass.matvec((u2 - 2 * u1 + u0) / self.dt**2) + (
            self.c**2
        ) * self.stiff.matvec(u1)
        return r * self.bc.free_mask

    def wave_residual_normalized(self, u0, u1, u2):
        """Same zero set as :meth:`wave_residual`, preconditioned for
        training: scaled by Δt² and the lumped-mass inverse so the loss is
        O(u) instead of O(u/Δt²) — the conditioning trick that makes the
        Galerkin operator-learning loss trainable at small Δt."""
        if not hasattr(self, "_m_lumped"):
            ones = torch.ones(self.n, dtype=self.mass.vals.dtype, device=self.device)
            self._m_lumped = torch.clamp(self.mass.matvec(ones), min=1e-12)
        r = (u2 - 2 * u1 + u0) + self.dt**2 * self.c**2 * (
            self.stiff.matvec(u1) / self._m_lumped
        )
        return r * self.bc.free_mask

    def ac_residual(self, u0, u1):
        """R = M(u1 − u0)/Δt + a²K u1 − F_react(u1)."""
        if u1.dim() > 1:
            return torch.stack([self.ac_residual(a, b) for a, b in zip(u0, u1)])
        react = self.asm.assemble_rhs(wf.reaction(u1, self._react_fn))
        r = self.mass.matvec((u1 - u0) / self.dt) + self.a2 * self.stiff.matvec(u1) - react
        return r * self.bc.free_mask

    # -- reference integrators (repro_torch.transient) ---------------------------
    def newmark_integrator(self, **kw) -> NewmarkIntegrator:
        """Newmark-β (β=¼, γ=½ — average acceleration, unconditionally
        stable, energy-preserving) over M and c²K."""
        stiff_c2 = self.stiff.with_vals(self.c**2 * self.stiff.vals)
        return NewmarkIntegrator(self.mass, stiff_c2, dt=self.dt, bc=self.bc, **kw)

    def newton_integrator(self, newton_iters: int = 3, **kw) -> NewtonKrylovIntegrator:
        """Backward Euler + Newton–Krylov for the Allen–Cahn semilinear term."""
        return NewtonKrylovIntegrator(
            self.asm, self.mass, self.stiff, dt=self.dt,
            reaction=self._react_fn,
            reaction_prime=lambda u: -self.eps2 * (3 * u**2 - 1.0),
            diffusion_scale=self.a2, bc=self.bc, newton_iters=newton_iters, **kw,
        )

    def wave_reference(self, u_init: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Newmark-β reference trajectory, zero initial velocity.
        Returns (n_steps, N)."""
        return self.newmark_integrator().rollout(
            u_init * self.bc.free_mask, n_steps
        )

    def ac_reference(self, u_init: torch.Tensor, n_steps: int,
                     newton_iters: int = 3) -> torch.Tensor:
        """Backward Euler with Newton (paper B.3.1). Returns (n_steps, N)."""
        return self.newton_integrator(newton_iters).rollout(
            u_init * self.bc.free_mask, n_steps
        )

    # -- losses over trajectories (Eq. B.22) -------------------------------------
    def wave_trajectory_loss(self, traj: torch.Tensor, normalized: bool = False):
        """traj: (T, N) including the first two known steps."""
        res = self.wave_residual_normalized if normalized else self.wave_residual
        r = res(traj[:-2], traj[1:-1], traj[2:])
        return torch.mean(torch.sum(r**2, dim=-1))

    def ac_trajectory_loss(self, traj: torch.Tensor) -> torch.Tensor:
        r = self.ac_residual(traj[:-1], traj[1:])
        return torch.mean(torch.sum(r**2, dim=-1))


def wave_residuals(problem: TimeDependentProblem, traj):
    return problem.wave_residual(traj[:-2], traj[1:-1], traj[2:])


def allen_cahn_residuals(problem: TimeDependentProblem, traj):
    return problem.ac_residual(traj[:-1], traj[1:])
