"""Dirichlet boundary conditions by in-pattern condensation.

The torch port of ``repro.core.boundary`` (``DirichletCondenser``; the
facet assembler for Neumann/Robin terms comes in a later slice).  Rows and
columns of constrained DoFs are masked, a unit diagonal is inserted and the
right-hand side is lifted by ``F ← F − K·u_D`` — a handful of elementwise
ops with masks precomputed from the DoF set, so the sparsity pattern never
changes.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import DTYPE, resolve_device
from .sparse import CSR

__all__ = ["DirichletCondenser"]


class DirichletCondenser:
    """Precomputes the masks that impose ``u[dofs] = values``.

    ``space_or_routing`` is a :class:`~repro_torch.core.GalerkinAssembler`
    (its routing and device are used) or a ``MatrixRouting``, with
    ``device`` then naming where the masks live."""

    def __init__(self, space_or_routing, bc_dofs: np.ndarray, device=None):
        routing = getattr(space_or_routing, "mat_routing", space_or_routing)
        if device is None:
            device = getattr(space_or_routing, "device", None)
        self.device = resolve_device(device)
        self.num_dofs = routing.num_dofs
        self.bc_dofs = np.asarray(bc_dofs, dtype=np.int64)
        is_bc = np.zeros(self.num_dofs, dtype=bool)
        is_bc[self.bc_dofs] = True
        row_bc = is_bc[routing.row_of_nnz]
        col_bc = is_bc[routing.indices]
        # diag entries of constrained rows -> 1.0
        diag_of_bc = routing.diag_pos[self.bc_dofs]
        assert np.all(diag_of_bc >= 0), "constrained DoF missing diagonal entry"

        def dev(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.keep_mask = dev(~(row_bc | col_bc), DTYPE)
        self.diag_of_bc = dev(diag_of_bc, torch.int64)
        self.free_mask = dev(~is_bc, DTYPE)
        self._bc_dofs_dev = dev(self.bc_dofs, torch.int64)
        self._is_bc_dev = dev(is_bc, torch.bool)

    def boundary_field(self, values, dtype=None) -> torch.Tensor:
        """Expand Dirichlet data to a full ``(num_dofs,)`` field ``u_D``.

        ``values`` may be a scalar, a ``(n_bc,)`` tensor (one entry per
        constrained DoF, in ``bc_dofs`` order), or a full ``(num_dofs,)``
        field whose non-constrained entries are ignored.
        """
        if isinstance(values, torch.Tensor):
            values = values.to(device=self.device, dtype=dtype or values.dtype)
        else:
            values = torch.as_tensor(values, dtype=dtype or torch.float64, device=self.device)
        u_d = torch.zeros(self.num_dofs, dtype=values.dtype, device=self.device)
        if values.dim() == 0 or tuple(values.shape) == (self.bc_dofs.shape[0],):
            return u_d.index_put((self._bc_dofs_dev,), values.expand(self.bc_dofs.shape[0]))
        if tuple(values.shape) == (self.num_dofs,):
            # where(), not multiplication: free-DoF entries must be *ignored*,
            # even when non-finite (0 * NaN would leak into the lift matvec)
            return torch.where(self._is_bc_dev, values, u_d)
        raise ValueError(f"un-interpretable Dirichlet value shape {tuple(values.shape)}")

    def lift(self, k: CSR, f: torch.Tensor, values=0.0) -> torch.Tensor:
        """RHS-only condensation: ``F ← F − K u_D`` on free rows, ``F[bc] = g``.
        ``k`` must be the *uncondensed* matrix (the lift needs the
        constrained columns)."""
        u_d = self.boundary_field(values, dtype=f.dtype)
        f_lift = (f - k.matvec(u_d)) * self.free_mask.to(f.dtype)
        bc = self._bc_dofs_dev
        return f_lift.index_put((bc,), u_d[bc])

    def apply(self, k: CSR, f: torch.Tensor, values=0.0) -> tuple[CSR, torch.Tensor]:
        """Return the condensed system (same sparsity pattern)."""
        return self.apply_matrix_only(k), self.lift(k, f, values)

    def apply_matrix_only(self, k: CSR) -> CSR:
        """Mask constrained rows/columns, unit diagonal."""
        vals = k.vals * self.keep_mask.to(k.vals.dtype)
        one = torch.ones((), dtype=vals.dtype, device=vals.device)
        vals = vals.index_put((self.diag_of_bc,), one.expand(self.diag_of_bc.shape[0]))
        return k.with_vals(vals)

    def project_residual(self, r: torch.Tensor) -> torch.Tensor:
        """Zero residual entries on constrained DoFs (for loss functions)."""
        return r * self.free_mask.to(r.dtype)
