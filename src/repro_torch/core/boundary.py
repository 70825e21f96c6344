"""Boundary conditions.

The torch port of ``repro.core.boundary``:

* **Dirichlet** (:class:`DirichletCondenser`) — in-pattern condensation:
  rows and columns of constrained DoFs are masked, a unit diagonal is
  inserted and the right-hand side is lifted by ``F ← F − K·u_D`` — a
  handful of elementwise ops with masks precomputed from the DoF set, so
  the sparsity pattern never changes.  The masks broadcast over a leading
  batch axis, so a whole ``BatchedCSR`` family condenses at once.
* **Neumann / Robin** (:class:`FacetAssembler`) — assembled on boundary
  facets through the same Map-Reduce pipeline (facet contexts and facet
  routing, paper SM B.1.5); the facet Reduces run the same kernel as the
  volume ones.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from . import forms
from .assembly import DTYPE, facet_context, resolve_device
from .elements import get_element
from .mesh import FunctionSpace
from .routing import build_matrix_routing, build_vector_routing
from .sparse import CSR
from ..kernels.seg_reduce import ReduceTable, seg_reduce
from ..telemetry import annotate

if TYPE_CHECKING:
    from .operator import LinearOperator

__all__ = ["DirichletCondenser", "FacetAssembler"]


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

    def lift(self, k: CSR | LinearOperator, f: torch.Tensor, values=0.0) -> torch.Tensor:
        """RHS-only condensation: ``F ← F − K u_D`` on free rows, ``F[bc] = g``.
        ``k`` must be the *uncondensed* operator, assembled or matrix-free
        (the lift needs the constrained columns: one ``k.matvec``)."""
        u_d = self.boundary_field(values, dtype=f.dtype)
        f_lift = (f - k.matvec(u_d)) * self.free_mask.to(f.dtype)
        bc = self._bc_dofs_dev
        return f_lift.index_put((bc,), u_d[bc])

    def apply(self, k: CSR, f: torch.Tensor, values=0.0) -> tuple[CSR, torch.Tensor]:
        """Return the condensed system (same sparsity pattern); a
        ``tg.condense`` range while a trace is taken."""
        with annotate("tg.condense", profiler_only=True):
            return self.apply_matrix_only(k), self.lift(k, f, values)

    def apply_matrix_only(self, k):
        """Mask constrained rows/columns, unit diagonal.  The masks
        broadcast over leading axes, so this also condenses a whole
        ``BatchedCSR`` family ((B, nnz) values) at once."""
        vals = k.vals * self.keep_mask.to(k.vals.dtype)
        return k.with_vals(vals.index_fill(-1, self.diag_of_bc, 1.0))

    def project_residual(self, r: torch.Tensor) -> torch.Tensor:
        """Zero residual entries on constrained DoFs (for loss functions)."""
        return r * self.free_mask.to(r.dtype)


class FacetAssembler:
    """Boundary-facet Map-Reduce: Robin matrices and Neumann loads that
    share the *volume* DoF numbering, so their Reduce lands in the global
    system.  The facet matrix routing is built over the same ``num_dofs``,
    and its values enter the volume CSR pattern through an injection map
    (facet nnz → volume nnz).

    A ``FacetAssembler`` is also the integration domain of boundary terms
    in the weak-form API — ``weakform.robin(alpha, on=fa)`` /
    ``weakform.neumann(g, on=fa)`` — where :meth:`context` supplies the
    facet geometry and :meth:`injection_into` the nnz injection into the
    volume pattern of the assembling plan.  Its two Reduce tables are built
    once on ``device`` (default: CUDA), so facet Reduces run the same
    kernel as the volume ones."""

    def __init__(self, space: FunctionSpace, facets: np.ndarray, volume_routing=None,
                 quad_order: int | None = None, device=None):
        assert space.value_size == 1, "facet terms implemented for scalar spaces"
        self.space = space
        mesh = space.mesh
        if mesh.cell_type != "tri":
            raise NotImplementedError("facet assembly: 2D triangles")
        self.device = resolve_device(device)
        el = get_element("P1_line")
        pts, w = el.default_rule(quad_order)

        def dev(a, dtype=DTYPE):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        self.w = dev(w)
        self.phi = dev(el.tabulate(pts))
        self.gradhat = dev(el.tabulate_grad(pts))
        self.facets = np.asarray(facets, dtype=np.int64)       # (F, 2) vertex ids
        self.coords = dev(mesh.points[self.facets])            # (F, 2, d)
        self._facet_dofs_dev = dev(self.facets, torch.int64)
        self.vec_routing = build_vector_routing(self.facets, space.num_dofs)
        self.mat_routing = build_matrix_routing(self.facets, None, space.num_dofs)
        self.vec_reduce = ReduceTable.for_vector(self.vec_routing, self.device)
        self.mat_reduce = ReduceTable.for_matrix(self.mat_routing, self.device)
        self._injections: dict = {}    # id(volume_routing) -> (routing, pos, pos on device)
        self._ctx = None
        self._vol_routing = volume_routing
        self._vol_injection = None
        if volume_routing is not None:
            self._vol_injection = self.injection_into(volume_routing)

    def _injection(self, volume_routing):
        hit = self._injections.get(id(volume_routing))
        if hit is None:
            n = self.space.num_dofs
            vol_key = volume_routing.row_of_nnz * n + volume_routing.indices
            fac_key = self.mat_routing.row_of_nnz * n + self.mat_routing.indices
            pos = np.searchsorted(vol_key, fac_key)
            assert np.all(vol_key[pos] == fac_key), "facet entry outside volume pattern"
            # keep the routing alive so the id() key stays unique
            hit = (volume_routing, pos, torch.as_tensor(pos, device=self.device))
            self._injections[id(volume_routing)] = hit
        return hit

    def injection_into(self, volume_routing) -> np.ndarray:
        """Positions of this facet pattern's nnz inside a volume CSR pattern
        (precomputed numpy, cached per volume routing)."""
        return self._injection(volume_routing)[1]

    def injection_index(self, volume_routing) -> torch.Tensor:
        """:meth:`injection_into` as an int64 tensor on the assembler's
        device (staged once per volume routing)."""
        return self._injection(volume_routing)[2]

    def context(self) -> forms.FormContext:
        """The facet geometry (built once: the facet coordinates are fixed
        at construction)."""
        if self._ctx is None:
            self._ctx = facet_context(self.coords, self.phi, self.gradhat, self.w,
                                      scalar_facet_dofs=self._facet_dofs_dev)
        return self._ctx

    def neumann_load(self, g) -> torch.Tensor:
        """∫_Γ g φ over the facet set → global (num_dofs,) vector."""
        return seg_reduce(forms.load(self.context(), g), self.vec_reduce)

    def robin_matrix_vals(self, alpha):
        """∫_Γ α φφ — its facet-pattern values and their positions in the
        *volume* CSR pattern."""
        vals = seg_reduce(forms.mass(self.context(), alpha), self.mat_reduce)
        assert self._vol_injection is not None, "need volume_routing for Robin"
        return vals, self._vol_injection

    def add_robin(self, k: CSR, alpha) -> CSR:
        vals, _ = self.robin_matrix_vals(alpha)
        pos = self.injection_index(self._vol_routing)
        return k.with_vals(k.vals.index_add(0, pos, vals.to(k.vals.dtype)))
