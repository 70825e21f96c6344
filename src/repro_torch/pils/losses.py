"""The four learning paradigms of the paper's controlled comparison (Fig. B.7).

The torch port of ``repro.pils.losses``.  All four share a backbone
``u_fn(params, x) -> u`` and the same mesh; they differ only in the
objective:

* :func:`pinn_poisson_loss`   — strong form, two AD passes (the paper's
  "graph-within-graph" anti-pattern, kept as the baseline): Δu per point
  by ``torch.func.vmap`` over ``torch.func.hessian``,
* :func:`vpinn_loss`          — variational residual against FEM test
  functions, one AD pass for ∇u (``torch.func.vmap`` over ``grad``), the
  Reduce onto the vector table (B2 on a CUDA plan),
* :func:`deep_ritz_loss`      — energy functional with deterministic Gauss
  quadrature, one AD pass,
* :class:`GalerkinResidualLoss` — **TensorPILS**: the network predicts the
  *coefficient vector* U; spatial derivatives are analytic shape-function
  gradients inside the assembled K — **zero** AD passes through space
  (Eq. 4), Dirichlet BCs imposed by condensation (hard constraints).  On a
  CUDA plan its ``ell`` residual is the fused B4 kernel (the training
  gradient through its ``autograd.Function``).
"""

from __future__ import annotations

import torch

from ..core import (
    DirichletCondenser,
    GalerkinAssembler,
    SolverSpec,
    assemble_batched,
    assemble_rhs,
    assemble_rhs_batched,
    make_residual,
    matfree_family,
    matfree_operator,
    matfree_solve_batched,
    sparse_solve_batched,
    weakform as wf,
)
from ..core.assembly import reduce_vector

__all__ = [
    "pinn_poisson_loss",
    "vpinn_loss",
    "deep_ritz_loss",
    "GalerkinResidualLoss",
    "BatchedGalerkinResidualLoss",
]


def _pointwise(u_fn, params):
    """The backbone as a scalar function of one point ``x (d,)``."""
    return lambda x: u_fn(params, x[None, :])[0, 0]


# ---------------------------------------------------------------------------
# strong-form PINN (−Δu = f): 2 AD passes per point
# ---------------------------------------------------------------------------

def _laplacian(u_scalar):
    """x ↦ Δu(x) at a single point: the trace of the Hessian
    (forward-over-reverse)."""
    hess = torch.func.hessian(u_scalar)
    return lambda x: torch.diagonal(hess(x)).sum()


def pinn_poisson_loss(u_fn, params, interior_pts, f_vals, boundary_pts,
                      boundary_vals=0.0, lambda_bc: float = 100.0):
    lap = _laplacian(_pointwise(u_fn, params))
    res = torch.func.vmap(lambda x, f: lap(x) + f)(interior_pts, f_vals)
    loss_pde = torch.mean(res**2)
    ub = u_fn(params, boundary_pts)[:, 0]
    loss_bc = torch.mean((ub - boundary_vals) ** 2)
    return loss_pde + lambda_bc * loss_bc


# ---------------------------------------------------------------------------
# Deep Ritz: E(u) = ∫ ½|∇u|² − f u with Gauss quadrature on elements
# ---------------------------------------------------------------------------

def deep_ritz_loss(u_fn, params, xq, wdet, f_q, boundary_pts,
                   boundary_vals=0.0, lambda_bc: float = 100.0):
    """xq: (E, Q, d) physical quadrature points; wdet: (E, Q) weights."""
    pts = xq.reshape(-1, xq.shape[-1])
    grads = torch.func.vmap(torch.func.grad(_pointwise(u_fn, params)))(pts)
    u_vals = u_fn(params, pts)[:, 0]
    integrand = 0.5 * torch.sum(grads**2, dim=-1) - f_q.reshape(-1) * u_vals
    energy = torch.sum(wdet.reshape(-1) * integrand)
    ub = u_fn(params, boundary_pts)[:, 0]
    return energy + lambda_bc * torch.mean((ub - boundary_vals) ** 2)


# ---------------------------------------------------------------------------
# VPINN: variational residual r_i = ∫ ∇u·∇φ_i − ∫ f φ_i (FEM test functions)
# ---------------------------------------------------------------------------

def vpinn_loss(u_fn, params, asm: GalerkinAssembler, f_load, free_mask,
               boundary_pts, boundary_vals=0.0, lambda_bc: float = 100.0):
    ctx = asm.context()
    pts = ctx.xq.reshape(-1, ctx.xq.shape[-1])
    grads = torch.func.vmap(torch.func.grad(_pointwise(u_fn, params)))(pts)
    grads = grads.reshape(ctx.xq.shape)                                  # (E,Q,d)
    # ∫ ∇u·∇φ_a over each element → local vector, then Sparse-Reduce
    local = torch.einsum("eq,eqi,eqai->ea", ctx.wdet, grads, ctx.grad)
    r = reduce_vector(local, asm.plan) - f_load
    r = r * free_mask
    loss_var = torch.sum(r**2)
    ub = u_fn(params, boundary_pts)[:, 0]
    return loss_var + lambda_bc * torch.mean((ub - boundary_vals) ** 2)


# ---------------------------------------------------------------------------
# TensorPILS: discrete Galerkin residual ‖K U − F‖², hard BCs, no spatial AD
# ---------------------------------------------------------------------------

class GalerkinResidualLoss:
    """Assembles K, F and the condenser once; the per-step loss is a
    single residual apply + norm — the O(1)-graph training objective of
    Eq. (4).

    The network may predict U directly or via a pointwise backbone
    evaluated at DoF coordinates (:meth:`loss_from_net`).

    ``backend`` picks the residual inner op from the registry
    (:mod:`repro_torch.core.matvec`): ``"csr"`` (default), ``"ell"`` and
    ``"ell_pallas"`` (the fused ``r = K·u − f`` kernel B4 on a CUDA plan),
    or ``"matfree"`` (K is never assembled; the residual applies the weak
    form element-locally).
    """

    def __init__(self, asm: GalerkinAssembler, bc: DirichletCondenser,
                 rho=None, f=1.0, backend: str = "csr"):
        load = asm.assemble_rhs(wf.source(f))
        if backend == "matfree":
            self.k = matfree_operator(asm.plan, wf.diffusion(rho)).condensed(bc)
            # homogeneous lift: K·u_D ≡ 0, so condensation reduces to masking
            self.f = bc.project_residual(load)
        else:
            k = asm.assemble(wf.diffusion(rho))
            self.k, self.f = bc.apply(k, load)
        self._residual = make_residual(self.k, backend)
        self.backend = backend
        self.bc = bc
        self.dof_points = torch.as_tensor(asm.space.dof_points, dtype=torch.float64,
                                          device=asm.device)

    def residual(self, u: torch.Tensor) -> torch.Tensor:
        return self._residual(u, self.f)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        r = self.residual(u)
        return torch.sum(r**2)

    def loss_from_net(self, u_fn, params) -> torch.Tensor:
        """Hard-constrained: predicted values are *overwritten* on Dirichlet
        DoFs (system reduction), so no boundary penalty exists."""
        u = u_fn(params, self.dof_points)[:, 0]
        u = u * self.bc.free_mask + self.f * (1.0 - self.bc.free_mask)
        return self(u)


class BatchedGalerkinResidualLoss:
    """Family-of-instances TensorPILS objective (Eq. B.22): B per-sample
    systems K(ρ_b) U_b = F_b with the per-sample matrices assembled in
    **one** batched call (shared static pattern, ``(B, nnz)`` values: one
    batched B1 and one batched B2 launch on a CUDA plan) and condensed with
    the shared static Dirichlet masks.

    The loss of a ``(B, num_dofs)`` prediction batch is the mean squared
    Galerkin residual over the family — one batched matvec, zero AD passes
    through space.  Homogeneous Dirichlet BCs (hard constraints via
    condensation, matching :class:`GalerkinResidualLoss`).

    ``backend="matfree"`` keeps the whole family matrix-free: the per-sample
    operators are one :class:`~repro_torch.core.operator.MatFreeFamily` on
    the shared plan and :meth:`solve` goes through
    :func:`~repro_torch.core.solvers.matfree_solve_batched`, with zero CSR
    values for the B instances.
    """

    def __init__(self, asm: GalerkinAssembler, bc: DirichletCondenser,
                 rho_batch, f=1.0, f_batch=None, backend="csr"):
        plan = asm.plan
        rho_batch = torch.as_tensor(rho_batch, device=plan.device)
        self.backend = backend
        if backend == "matfree":
            fam = matfree_family(
                plan, wf.diffusion(rho_batch[0]), leaves_batch=(rho_batch, None)
            )
            self.k = fam.condensed(bc)
        elif backend == "csr":
            kb = assemble_batched(
                plan, wf.diffusion(rho_batch[0]), leaves_batch=(rho_batch, None)
            )
            self.k = bc.apply_matrix_only(kb)   # masks broadcast over (B, nnz)
        else:
            raise ValueError(
                f"unknown backend {backend!r}: expected 'csr' or 'matfree'"
            )
        if f_batch is not None:
            f_batch = torch.as_tensor(f_batch, device=plan.device)
            load = assemble_rhs_batched(
                plan, wf.source(f_batch[0]), leaves_batch=(f_batch, None)
            )
        else:
            load = assemble_rhs(plan, wf.source(f))
        # homogeneous lift: F ← F·free_mask (u_D = 0, so the K·u_D matvec is
        # identically zero and the bc rows of F become the bc values)
        self.f = bc.project_residual(load)
        self.bc = bc
        self.batch = int(rho_batch.shape[0])
        self.dof_points = torch.as_tensor(asm.space.dof_points, dtype=torch.float64,
                                          device=plan.device)

    def residual(self, u_batch: torch.Tensor) -> torch.Tensor:
        return self.k.matvec(u_batch) - self.f

    def __call__(self, u_batch: torch.Tensor) -> torch.Tensor:
        r = self.residual(u_batch)
        return torch.mean(torch.sum(r**2, dim=-1))

    def solve(self, spec: SolverSpec | None = None, *, tol=1e-10,
              maxiter=10000) -> torch.Tensor:
        """Direct FEM solutions of the whole family, one adjoint solve per
        instance (reference targets / sanity checks for the learned U_b).
        ``spec=`` overrides the default CG+Jacobi configuration."""
        if spec is None:
            spec = SolverSpec(method="cg", tol=tol, atol=tol, maxiter=maxiter)
        if self.backend == "matfree":
            return matfree_solve_batched(self.k, self.f, spec)
        return sparse_solve_batched(self.k, self.f, spec)

    def loss_from_net(self, u_fn, params_batch) -> torch.Tensor:
        """Hard-constrained family loss for B per-instance backbones: each
        parameter set (the leaves of ``params_batch`` carry a leading batch
        axis) predicts its instance's coefficients at the DoF coordinates,
        Dirichlet rows are overwritten by condensation (no boundary penalty)
        — the batched twin of :meth:`GalerkinResidualLoss.loss_from_net`."""
        u = torch.func.vmap(lambda p: u_fn(p, self.dof_points)[:, 0])(params_batch)
        u = u * self.bc.free_mask + self.f * (1.0 - self.bc.free_mask)
        return self(u)
