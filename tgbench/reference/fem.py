"""Plain P1 finite elements on tetrahedra, in PyTorch.

The yardstick that decides ``correct``: element matrices from the
textbook formulas (constant gradients of the barycentric functions, exact
integrals), the boundary set from the faces that only one cell has, the
global operator applied element by element (gather, product, ``index_add_``)
and the Dirichlet-condensed residual.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

__all__ = ["Geometry", "ElementOperator", "boundary_vertices", "cell_dofs",
           "condensed_residual", "diffusion_local", "elasticity_local", "load_vector",
           "mass_local"]

# the local vertices of each face of a tetrahedron
_FACES = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))


class Geometry:
    """Per-cell gradients of the four barycentric functions ``grads (E, 4,
    3)`` and volumes ``vol (E,)`` of a tetrahedral mesh."""

    def __init__(self, points, cells, device, dtype=torch.float64):
        pts = torch.as_tensor(points, dtype=dtype, device=device)
        self.cells = torch.as_tensor(cells, dtype=torch.int64, device=device)
        self.num_vertices = pts.shape[0]
        x = pts[self.cells]                                  # (E, 4, 3)
        jac = (x[:, 1:] - x[:, :1]).transpose(1, 2)          # columns x_a − x_0
        inv = torch.linalg.inv(jac)                          # rows: ∇λ_1..∇λ_3
        grads = torch.cat([-inv.sum(dim=1, keepdim=True), inv], dim=1)
        self.vol = torch.linalg.det(jac).abs() / 6.0
        self.grads = grads

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]


def diffusion_local(geo: Geometry, rho) -> torch.Tensor:
    """``K_e[a, b] = ρ_e |T_e| ∇λ_a·∇λ_b`` (rho a scalar or ``(E,)``)."""
    rho = torch.as_tensor(rho, dtype=geo.vol.dtype, device=geo.vol.device)
    return (rho * geo.vol)[:, None, None] * (geo.grads @ geo.grads.transpose(1, 2))


def mass_local(geo: Geometry) -> torch.Tensor:
    """``M_e[a, b] = |T_e| (1 + δ_ab) / 20``."""
    eye = torch.eye(4, dtype=geo.vol.dtype, device=geo.vol.device)
    return geo.vol[:, None, None] * (1.0 + eye) / 20.0


def elasticity_local(geo: Geometry, lam: float, mu: float) -> torch.Tensor:
    """Isotropic linear elasticity, DoF ``3·a + i``:
    ``K[ai, bj] = |T| (μ (δ_ij ∇λ_a·∇λ_b + ∂_j λ_a ∂_i λ_b) + λ ∂_i λ_a ∂_j λ_b)``."""
    g = geo.grads
    e = g.shape[0]
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    dots = g @ g.transpose(1, 2)                                   # (E, a, b)
    k = (mu * dots[:, :, None, :, None] * eye[None, None, :, None, :]
         + mu * torch.einsum("eaj,ebi->eaibj", g, g)
         + lam * torch.einsum("eai,ebj->eaibj", g, g))
    return (geo.vol[:, None, None, None, None] * k).reshape(e, 12, 12)


def cell_dofs(geo: Geometry, value_size: int) -> torch.Tensor:
    """``(E, 4·v)`` global DoFs, components interleaved (``v·node + i``)."""
    if value_size == 1:
        return geo.cells
    comp = torch.arange(value_size, device=geo.cells.device)
    return (geo.cells[:, :, None] * value_size + comp).reshape(geo.num_cells, -1)


def load_vector(geo: Geometry, force, value_size: int) -> torch.Tensor:
    """``∫ f·φ`` for a constant source (scalar) or body force (vector):
    each vertex of a cell gets ``|T| f / 4``."""
    f = torch.as_tensor(force, dtype=geo.vol.dtype, device=geo.vol.device).reshape(-1)
    local = (geo.vol / 4.0)[:, None, None] * f.expand(value_size)[None, None, :]
    local = local.expand(-1, 4, -1).reshape(geo.num_cells, -1)
    dofs = cell_dofs(geo, value_size)
    out = torch.zeros(geo.num_vertices * value_size, dtype=local.dtype, device=local.device)
    return out.index_add_(0, dofs.reshape(-1), local.reshape(-1))


def boundary_vertices(geo: Geometry) -> torch.Tensor:
    """The vertices of the faces that belong to one cell only."""
    faces = geo.cells[:, list(_FACES)].reshape(-1, 3).sort(dim=1).values
    v = geo.num_vertices
    key = (faces[:, 0] * v + faces[:, 1]) * v + faces[:, 2]
    uniq, counts = torch.unique(key, return_counts=True)
    once = uniq[counts == 1]
    return torch.unique(torch.stack([once // (v * v), (once // v) % v, once % v], 1))


class ElementOperator:
    """``y = Σ_e P_eᵀ A_e P_e x`` from element matrices ``local (E, k, k)``
    and their global DoFs ``dofs (E, k)``."""

    def __init__(self, local: torch.Tensor, dofs: torch.Tensor, n: int):
        self.local, self.dofs, self.n = local, dofs, n
        self._flat = dofs.reshape(-1)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.einsum("eij,ej->ei", self.local, x[self.dofs])
        return torch.zeros(self.n, dtype=y.dtype, device=y.device).index_add_(
            0, self._flat, y.reshape(-1))

    def diagonal(self) -> torch.Tensor:
        d = torch.diagonal(self.local, dim1=1, dim2=2).reshape(-1)
        return torch.zeros(self.n, dtype=d.dtype, device=d.device).index_add_(0, self._flat, d)


def condensed_residual(op: ElementOperator, free: torch.Tensor, u: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """The residual of ``u`` in the homogeneous Dirichlet system: free rows
    ``P (A (P u) − b)``, constrained rows ``u`` (their equation is u = 0)."""
    u = u.to(op.local.dtype)
    return free * (op.apply(free * u) - b) + (1 - free) * u
