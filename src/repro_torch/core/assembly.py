"""TensorGalerkin: Batch-Map + Sparse-Reduce assembly (the paper's core).

The torch port of ``repro.core.assembly`` (single-instance assembly; the
batched and sharded variants come in later slices):

* :func:`geometry_context` — Stage-I geometry: batched Jacobians,
  closed-form inverses/determinants, push-forward gradients (Alg. 1,
  lines 1–3).
* :class:`AssemblyPlan` — one (mesh topology × element × quadrature)
  signature: the quadrature/element tables, the host routing, and the
  device tables of both Reduces, staged once to the plan's device.
* :func:`assemble` / :func:`assemble_rhs` — one Map, one Reduce.
* :class:`GalerkinAssembler` — the facade over a plan.

The Map of a form that is exactly ``diffusion(rho)`` on a P1 simplex space
runs the hand-written kernel :func:`repro_torch.kernels.local_stiffness_p1`
(P1 gradients are constant, so every coefficient encoding reduces to one
value per element); every other form, and any call where an input requires
grad, runs the einsum Map.  Every Reduce runs
:func:`repro_torch.kernels.seg_reduce`.  On a CUDA plan both are the CUDA
kernels, so assembly on the card is deterministic; on a CPU plan they are
the plain versions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import telemetry
from ..kernels.local_assembly import local_stiffness_p1
from ..kernels.seg_reduce import ReduceTable, seg_reduce
from ..telemetry import annotate
from . import forms, weakform
from .elements import get_element
from .mesh import FunctionSpace
from .routing import build_matrix_routing, build_vector_routing
from .sparse import CSR

__all__ = [
    "DTYPE",
    "AssemblyPlan",
    "GalerkinAssembler",
    "assemble",
    "assemble_rhs",
    "build_plan",
    "geometry_context",
    "reduce_matrix",
    "reduce_vector",
    "resolve_device",
]

DTYPE = torch.float64  # FEM numerics in double precision (the paper solves to 1e-10)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA without a usable card raises — the port
    never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default, but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# Stage I geometry (closed-form small-matrix algebra, element-parallel)
# ---------------------------------------------------------------------------

def _det(j: torch.Tensor) -> torch.Tensor:
    d = j.shape[-1]
    if d == 1:
        return j[..., 0, 0]
    if d == 2:
        return j[..., 0, 0] * j[..., 1, 1] - j[..., 0, 1] * j[..., 1, 0]
    if d == 3:
        return (
            j[..., 0, 0] * (j[..., 1, 1] * j[..., 2, 2] - j[..., 1, 2] * j[..., 2, 1])
            - j[..., 0, 1] * (j[..., 1, 0] * j[..., 2, 2] - j[..., 1, 2] * j[..., 2, 0])
            + j[..., 0, 2] * (j[..., 1, 0] * j[..., 2, 1] - j[..., 1, 1] * j[..., 2, 0])
        )
    raise ValueError(d)


def _inv(j: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    d = j.shape[-1]
    if d == 1:
        return 1.0 / j
    if d == 2:
        adj = torch.stack(
            [
                torch.stack([j[..., 1, 1], -j[..., 0, 1]], -1),
                torch.stack([-j[..., 1, 0], j[..., 0, 0]], -1),
            ],
            -2,
        )
        return adj / det[..., None, None]
    if d == 3:
        c00 = j[..., 1, 1] * j[..., 2, 2] - j[..., 1, 2] * j[..., 2, 1]
        c01 = j[..., 0, 2] * j[..., 2, 1] - j[..., 0, 1] * j[..., 2, 2]
        c02 = j[..., 0, 1] * j[..., 1, 2] - j[..., 0, 2] * j[..., 1, 1]
        c10 = j[..., 1, 2] * j[..., 2, 0] - j[..., 1, 0] * j[..., 2, 2]
        c11 = j[..., 0, 0] * j[..., 2, 2] - j[..., 0, 2] * j[..., 2, 0]
        c12 = j[..., 0, 2] * j[..., 1, 0] - j[..., 0, 0] * j[..., 1, 2]
        c20 = j[..., 1, 0] * j[..., 2, 1] - j[..., 1, 1] * j[..., 2, 0]
        c21 = j[..., 0, 1] * j[..., 2, 0] - j[..., 0, 0] * j[..., 2, 1]
        c22 = j[..., 0, 0] * j[..., 1, 1] - j[..., 0, 1] * j[..., 1, 0]
        adj = torch.stack(
            [
                torch.stack([c00, c01, c02], -1),
                torch.stack([c10, c11, c12], -1),
                torch.stack([c20, c21, c22], -1),
            ],
            -2,
        )
        return adj / det[..., None, None]
    raise ValueError(d)


def geometry_context(coords, geo_phi, geo_grad, phi, gradhat, w,
                     scalar_cell_dofs=None) -> forms.FormContext:
    """Build the Stage-I :class:`FormContext` from batched coordinates.

    coords: (E, nv_geo, d); geo_phi/geo_grad: geometric element tables
    (Q, nv_geo[, d]); phi/gradhat: field element tables (Q, k[, d]).
    Differentiable with respect to ``coords``.
    """
    # J_eqij = Σ_a X_eai ĝeo_qaj     (Alg. 1 line 1)
    j = torch.einsum("eai,qaj->eqij", coords, geo_grad)
    det = _det(j)
    jinv = _inv(j, det)
    # push-forward 𝒢_eqai = Σ_j (J⁻¹)_ji ĝ_qaj   (Alg. 1 line 2)
    grad = torch.einsum("eqji,qaj->eqai", jinv, gradhat)
    xq = torch.einsum("qa,eai->eqi", geo_phi, coords)
    return forms.FormContext(w=w, phi=phi, detj=det.abs(), grad=grad, xq=xq,
                             scalar_cell_dofs=scalar_cell_dofs)


# ---------------------------------------------------------------------------
# The assembly plan
# ---------------------------------------------------------------------------

_GEOMETRY = {"tri": "P1_tri", "tet": "P1_tet", "quad": "Q1_quad", "hex": "Q1_hex"}


class AssemblyPlan:
    """One (mesh topology × element × quadrature) assembly signature, with
    every table staged on ``device``: quadrature/element tables, the
    element coordinates ``coords (E, nv_geo, d)``, and the device tables of
    the matrix and vector Reduces.  The host routing stays on the plan as
    numpy.  Build one with :func:`build_plan`."""

    def __init__(self, space: FunctionSpace, quad_order: int | None, device):
        mesh, element = space.mesh, space.element
        self.device = resolve_device(device)
        self.element = element
        self.value_size = space.value_size
        self.num_dofs = space.num_dofs
        pts, w = element.default_rule(quad_order)
        geo = get_element(_GEOMETRY[mesh.cell_type])

        def dev(a, dtype=DTYPE):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        self.w = dev(w)
        self.phi = dev(element.tabulate(pts))
        self.gradhat = dev(element.tabulate_grad(pts))
        self.geo_phi = dev(geo.tabulate(pts))
        self.geo_grad = dev(geo.tabulate_grad(pts))
        scalar = space.cell_dofs[:, :: space.value_size] // space.value_size
        self.scalar_cell_dofs = dev(scalar, torch.int64)
        self.coords = dev(mesh.points[mesh.cells])
        self.mat_routing = build_matrix_routing(space.cell_dofs, None, space.num_dofs)
        self.vec_routing = build_vector_routing(space.cell_dofs, space.num_dofs)
        self.mat_reduce = ReduceTable.for_matrix(self.mat_routing, self.device)
        self.vec_reduce = ReduceTable.for_vector(self.vec_routing, self.device)

    @property
    def nnz(self) -> int:
        return self.mat_routing.nnz

    @property
    def num_cells(self) -> int:
        return int(self.coords.shape[0])

    def context(self, coords: torch.Tensor | None = None) -> forms.FormContext:
        return geometry_context(
            self.coords if coords is None else coords,
            self.geo_phi, self.geo_grad, self.phi, self.gradhat, self.w,
            scalar_cell_dofs=self.scalar_cell_dofs,
        )

    def quadrature_points(self, coords: torch.Tensor | None = None) -> forms.FormContext:
        """A context with the quadrature points only (no Jacobians): enough
        to evaluate a coefficient."""
        c = self.coords if coords is None else coords
        return forms.FormContext(
            w=self.w, phi=self.phi, detj=None, grad=None,
            xq=torch.einsum("qa,eai->eqi", self.geo_phi, c),
            scalar_cell_dofs=self.scalar_cell_dofs,
        )

    def csr(self, vals: torch.Tensor) -> CSR:
        r = self.mat_routing
        telemetry.gauge_set(
            "csr_bytes", r.nnz * vals.element_size() + r.indptr.nbytes + r.indices.nbytes
        )
        return CSR(vals, r.pattern)


def build_plan(space: FunctionSpace, quad_order: int | None = None,
               device=None) -> AssemblyPlan:
    """Precompute one :class:`AssemblyPlan` for a function space on
    ``device`` (default CUDA)."""
    return AssemblyPlan(space, quad_order, device)


# ---------------------------------------------------------------------------
# Stage II reduce
# ---------------------------------------------------------------------------

def reduce_matrix(k_local: torch.Tensor, plan: AssemblyPlan) -> torch.Tensor:
    """``S_mat · vec(K_local)`` onto the plan's CSR values."""
    return seg_reduce(k_local, plan.mat_reduce)


def reduce_vector(f_local: torch.Tensor, plan: AssemblyPlan) -> torch.Tensor:
    """``S_vec · vec(F_local)`` onto a ``(num_dofs,)`` vector."""
    return seg_reduce(f_local, plan.vec_reduce)


# ---------------------------------------------------------------------------
# The Map
# ---------------------------------------------------------------------------

def _requires_grad(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _p1_element_rho(plan: AssemblyPlan, coords, spec, leaves):
    """For a form that is exactly ``scale * diffusion(rho)`` on a P1
    simplex space, the per-element coefficient the P1 kernel takes:
    ``ρ_e = scale · Σ_q ŵ_q ρ_eq / |ref|`` (P1 gradients are constant, so
    this is exact for every coefficient encoding).  ``None`` for any other
    form, or when an input requires grad (the kernel has no gradient)."""
    if len(spec) != 1 or spec[0][0] != "diffusion":
        return None
    if plan.element.name not in ("P1_tri", "P1_tet") or plan.value_size != 1:
        return None
    if _requires_grad(coords, *leaves):
        return None
    leaf = iter(leaves)
    rho, scale = [next(leaf) if d == weakform.TRACED else d[1] for d in spec[0][1]]
    e = coords.shape[0]
    if rho is None:
        rho_e = torch.ones(e, dtype=coords.dtype, device=coords.device)
    elif isinstance(rho, torch.Tensor) and tuple(rho.shape) == (e,):
        rho_e = rho.to(device=coords.device)
    elif not callable(rho) and torch.as_tensor(rho).dim() == 0:
        rho_e = torch.full((e,), float(rho), dtype=coords.dtype, device=coords.device)
    else:
        rho_q = forms.eval_coefficient(rho, plan.quadrature_points(coords))
        rho_e = rho_q @ plan.w / plan.w.sum()
    rho_e = (rho_e * scale).to(coords.dtype)
    if rho_e.requires_grad:
        return None
    return rho_e.contiguous()


def _map_stage(plan: AssemblyPlan, coords, spec, leaves):
    """One fused Map: every term of ``spec`` against one shared volume
    context, local matrices/vectors summed term-wise."""
    rho_e = _p1_element_rho(plan, coords, spec, leaves)
    if rho_e is not None:
        return local_stiffness_p1(coords.contiguous(), rho_e)
    ctx = plan.context(coords)
    leaf = iter(leaves)
    local_sum = None
    for kind, desc in spec:
        *coeffs, scale = [next(leaf) if d == weakform.TRACED else d[1] for d in desc]
        local = weakform.KERNELS[kind].fn(ctx, plan.value_size, *coeffs) * scale
        if local_sum is not None and local_sum.shape != local.shape:
            raise ValueError(
                f"term '{kind}' local shape {tuple(local.shape)} does not match "
                f"earlier terms {tuple(local_sum.shape)}"
            )
        local_sum = local if local_sum is None else local_sum + local
    return local_sum


def _assemble_vals(plan: AssemblyPlan, form, arity: str, coords=None) -> torch.Tensor:
    spec, leaves = weakform.lower(form, arity)
    c = plan.coords if coords is None else coords
    t0 = time.perf_counter() if telemetry.is_enabled() else None
    with annotate("tg.map"):
        local = _map_stage(plan, c, spec, leaves)
    with annotate("tg.reduce"):
        if arity == weakform.MATRIX:
            out = reduce_matrix(local, plan)
        else:
            out = reduce_vector(local, plan)
    if t0 is not None:
        is_mat = arity == weakform.MATRIX
        telemetry.record_assembly(
            "assemble" if is_mat else "assemble_rhs",
            num_dofs=plan.num_dofs, nnz=plan.nnz if is_mat else None,
            num_cells=int(c.shape[0]), form="+".join(kind for kind, _ in spec),
            wall_us=(time.perf_counter() - t0) * 1e6,
        )
    return out


def assemble(plan: AssemblyPlan, form, coords=None) -> CSR:
    """Assemble a bilinear :class:`~repro_torch.core.weakform.WeakForm`
    into a CSR on the plan's pattern: one fused Map, one Reduce.
    ``coords`` overrides the plan's element coordinates (shape
    optimisation: gradients flow to it through the einsum Map)."""
    return plan.csr(_assemble_vals(plan, form, weakform.MATRIX, coords))


def assemble_rhs(plan: AssemblyPlan, form, coords=None) -> torch.Tensor:
    """Assemble a linear form into a global ``(num_dofs,)`` vector."""
    return _assemble_vals(plan, form, weakform.VECTOR, coords)


class GalerkinAssembler:
    """The facade over an :class:`AssemblyPlan`: one instance per
    (mesh topology × element × quadrature) signature."""

    def __init__(self, space: FunctionSpace, quad_order: int | None = None, device=None):
        self.space = space
        self.mesh = space.mesh
        self.element = space.element
        self.plan = build_plan(space, quad_order, device)
        self.device = self.plan.device
        self.coords = self.plan.coords
        self.mat_routing = self.plan.mat_routing
        self.vec_routing = self.plan.vec_routing

    def context(self, coords: torch.Tensor | None = None) -> forms.FormContext:
        return self.plan.context(coords)

    def csr(self, vals: torch.Tensor) -> CSR:
        return self.plan.csr(vals)

    def assemble(self, form, coords=None) -> CSR:
        """Assemble a bilinear form into a CSR on the volume pattern."""
        return assemble(self.plan, form, coords)

    def assemble_rhs(self, form, coords=None) -> torch.Tensor:
        """Assemble a linear form into a global ``(num_dofs,)`` vector."""
        return assemble_rhs(self.plan, form, coords)
