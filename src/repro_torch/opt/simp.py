"""TensorOpt — SIMP compliance minimization (paper §B.4).

The torch port of ``repro.opt.simp``.  2D cantilever: rectangular QUAD4
mesh, fixed left edge, downward load near the bottom-right corner.
Compliance C(ρ) = FᵀU with K(ρ)U = F, SIMP interpolation
E(ρ) = E_min + ρᵖ(E_max − E_min), sensitivity by **autograd through the
differentiable assembly and sparse solve**: the elasticity Map (einsum),
the Reduce (B2's ``_SegReduce`` on a CUDA plan), the Dirichlet masks and
the adjoint ``sparse_solve``.  Eq. B.28 is not hand-coded on that path; it
is only the check (:meth:`CantileverProblem.analytic_sensitivity`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import (
    DirichletCondenser,
    FunctionSpace,
    GalerkinAssembler,
    assemble_batched,
    forms,
    weakform as wf,
)
from ..core.assembly import DTYPE, resolve_device
from ..core.mesh import element_for_mesh, rectangle_quad
from ..core.solvers import SolverSpec, sparse_solve, sparse_solve_batched

# SIMP compliance solves: CG+Jacobi at paper tolerance, deep maxiter for
# the nearly-void SIMP states near convergence
_SIMP_SPEC = SolverSpec(method="cg", tol=1e-10, atol=1e-10, maxiter=30000)

__all__ = ["CantileverProblem", "sensitivity_filter", "oc_update"]


def sensitivity_filter(centers: np.ndarray, rmin: float, device=None):
    """Classic sensitivity/density filter: sparse row-normalized weights
    w_ij = max(0, rmin − |x_i − x_j|) over element centers, built on the
    host; the returned ``apply(x)`` takes ``(E,)`` or ``(B, E)`` on
    ``device`` (one ``index_add`` over the last axis)."""
    from scipy.spatial import cKDTree

    device = resolve_device(device)
    tree = cKDTree(centers)
    pairs = tree.query_pairs(rmin, output_type="ndarray")
    i = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(len(centers))])
    j = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(len(centers))])
    d = np.linalg.norm(centers[i] - centers[j], axis=-1)
    w = np.maximum(0.0, rmin - d)
    rowsum = np.zeros(len(centers))
    np.add.at(rowsum, i, w)
    i_t = torch.as_tensor(i, dtype=torch.int64, device=device)
    j_t = torch.as_tensor(j, dtype=torch.int64, device=device)
    w_t = torch.as_tensor(w, dtype=DTYPE, device=device)
    rs = torch.as_tensor(rowsum, dtype=DTYPE, device=device)

    def apply(x):
        contrib = w_t * x[..., j_t]
        num = torch.zeros_like(x).index_add(-1, i_t, contrib)
        return num / rs

    return apply


class CantileverProblem:
    """60×30 QUAD4 cantilever (paper B.4.1 geometry & SIMP constants), on
    ``device`` (CUDA unless the caller passes ``"cpu"``)."""

    def __init__(self, nx=60, ny=30, lx=60.0, ly=30.0,
                 e_max=70_000.0, e_min=70.0, nu=0.3, penal=3.0,
                 volfrac=0.5, rmin_factor=1.5, load=-100.0, device=None):
        self.mesh = rectangle_quad(nx, ny, lx, ly)
        self.space = FunctionSpace(self.mesh, element_for_mesh(self.mesh), value_size=2)
        self.asm = GalerkinAssembler(self.space, device=device)
        self.device = self.asm.device
        self.penal, self.e_max, self.e_min = penal, e_max, e_min
        self.volfrac = volfrac
        self.n_elem = self.mesh.num_cells

        # unit-modulus Lamé parameters (scaled per-element by SIMP E(ρ))
        self.lam1 = nu / ((1 + nu) * (1 - 2 * nu))
        self.mu1 = 1.0 / (2 * (1 + nu))

        # BCs: clamp left edge (x=0); traction on x=lx, 0<=y<=0.1*ly lumped
        # onto the corner nodes (consistent with the classic 88-line setup).
        pts = self.space.dof_points
        left = np.nonzero(pts[:, 0] < 1e-9)[0]
        bc_dofs = (left[:, None] * 2 + np.arange(2)).ravel()
        self.bc = DirichletCondenser(self.asm, bc_dofs)
        loaded = np.nonzero((pts[:, 0] > lx - 1e-9) & (pts[:, 1] <= 0.1 * ly + 1e-9))[0]
        f = np.zeros(self.space.num_dofs)
        f[loaded * 2 + 1] = load / len(loaded)
        self.f = torch.as_tensor(f, dtype=DTYPE, device=self.device) * self.bc.free_mask

        centers = self.mesh.points[self.mesh.cells].mean(axis=1)
        h = lx / nx
        self.filter = sensitivity_filter(centers, rmin_factor * h, self.device)

        # reference local stiffness at unit modulus (for the analytic
        # sensitivity check, Eq. B.28)
        self._k0_local = forms.elasticity(self.asm.context(), self.lam1, self.mu1)
        self._cell_dofs = torch.as_tensor(self.space.cell_dofs, dtype=torch.int64,
                                          device=self.device)

    # -- differentiable forward -------------------------------------------------
    def simp_modulus(self, rho):
        return self.e_min + rho**self.penal * (self.e_max - self.e_min)

    def _displacement(self, rho):
        """``(u, SolveInfo)`` of K(ρ)u = F: one fused assembly (E(ρ) is the
        per-element scale of the elasticity term), the Dirichlet masks,
        and the adjoint CG solve."""
        k = self.asm.assemble(wf.elasticity(self.lam1, self.mu1, scale=self.simp_modulus(rho)))
        kc = self.bc.apply_matrix_only(k)
        return sparse_solve(kc, self.f, _SIMP_SPEC, return_info=True)

    def compliance(self, rho):
        u, _ = self._displacement(rho)
        return torch.dot(self.f, u)

    def compliance_and_sensitivity(self, rho):
        """``(C(ρ), ∂C/∂ρ)``: one forward solve, one adjoint solve."""
        rho = rho.detach().requires_grad_(True)
        with torch.enable_grad():
            c = self.compliance(rho)
            (grad,) = torch.autograd.grad(c, rho)
        return c.detach(), grad

    # -- multi-start batched evaluation ----------------------------------------
    def _compliance_batch(self, rho_batch):
        # ONE batched assembly over the whole family: the B SIMP-interpolated
        # scale fields ride the batched leaf slot of the elasticity term (the
        # Map runs instance by instance, the Reduce is one batched B2 launch),
        # the Dirichlet masks broadcast over (B, nnz), and the B adjoint
        # solves run one after another
        scale = self.simp_modulus(rho_batch)                   # (B, E)
        kb = assemble_batched(
            self.asm.plan,
            wf.elasticity(self.lam1, self.mu1, scale=scale[0]),
            leaves_batch=(None, None, scale, None),
        )
        kc = self.bc.apply_matrix_only(kb)
        u = sparse_solve_batched(kc, self.f, _SIMP_SPEC)   # (B, n)
        return u @ self.f

    def compliance_batch(self, rho_batch):
        """Compliance of a batch of density fields ``(B, E) → (B,)`` — the
        multi-start evaluation: one fused batched assembly and the B
        adjoint solves instead of B separate pipelines."""
        return self._compliance_batch(rho_batch)

    def compliance_and_sensitivity_batch(self, rho_batch):
        """Per-instance compliances and sensitivities of a ``(B, E)`` family
        in one reverse pass (instances are independent, so the backward of
        ``c.sum()`` recovers each instance's gradient row)."""
        rho_batch = rho_batch.detach().requires_grad_(True)
        with torch.enable_grad():
            c = self._compliance_batch(rho_batch)
            (grad,) = torch.autograd.grad(c.sum(), rho_batch)
        return c.detach(), grad

    def multistart_step(self, rho_batch, move=0.1):
        """One OC update of every start in the family: batched
        compliance/sensitivity, the sensitivity filter and the OC bisection
        over the batch axis.  Returns ``(rho_batch', compliances)``."""
        c, sens = self.compliance_and_sensitivity_batch(rho_batch)
        filt = self.filter(sens * rho_batch) / torch.clamp(rho_batch, min=1e-3)
        rho_new = oc_update(rho_batch, filt, self.volfrac, move=move)
        return rho_new, c

    def analytic_sensitivity(self, rho):
        """Closed-form Eq. B.28 — used only to validate the AD path."""
        u, _ = self._displacement(rho)
        u_e = u[self._cell_dofs]                                # (E, k)
        quad = torch.einsum("ea,eab,eb->e", u_e, self._k0_local, u_e)
        return -self.penal * rho ** (self.penal - 1) * (self.e_max - self.e_min) * quad

    def volume(self, rho):
        return torch.mean(rho)


def oc_update(rho, sens, volfrac, move=0.1, rho_min=1e-3,
              l1=1e-9, l2=1e9, iters=60):
    """Optimality-criteria update with bisection on the volume multiplier:
    a fixed count of ``torch.where`` steps on the device (no host read).
    A leading batch axis bisects each instance on its own."""
    sens = torch.clamp(sens, max=0.0)  # compliance sensitivities are negative
    bshape = (*rho.shape[:-1], 1)
    lo = torch.full(bshape, l1, dtype=rho.dtype, device=rho.device)
    hi = torch.full(bshape, l2, dtype=rho.dtype, device=rho.device)

    def design(lmid):
        b = rho * torch.sqrt(-sens / lmid)
        return torch.clamp(torch.clamp(b, rho - move, rho + move), rho_min, 1.0)

    for _ in range(iters):
        lmid = 0.5 * (lo + hi)
        too_much = design(lmid).mean(dim=-1, keepdim=True) > volfrac
        lo, hi = torch.where(too_much, lmid, lo), torch.where(too_much, hi, lmid)
    return design(0.5 * (lo + hi))
