"""TensorGalerkin: Batch-Map + Sparse-Reduce assembly (the paper's core).

The torch port of ``repro.core.assembly`` (single-instance and batched
assembly; the sharded variants come in a later slice):

* :func:`geometry_context` — Stage-I geometry: batched Jacobians,
  closed-form inverses/determinants, push-forward gradients (Alg. 1,
  lines 1–3); :func:`facet_context` the same for boundary facets, with the
  surface measure √det(JᵀJ).
* :class:`AssemblyPlan` — one (mesh topology × element × quadrature)
  signature: the quadrature/element tables, the host routing, and the
  device tables of both Reduces, staged once to the plan's device.
* :func:`assemble` / :func:`assemble_rhs` — one Map, one Reduce; facet
  terms (``robin``/``neumann`` on a ``FacetAssembler``) reduce through
  their facet routing and land in the volume values.
* :func:`assemble_batched` / :func:`assemble_rhs_batched` — B instances
  (coefficient sets or geometries) in one batched Reduce, and for P1
  diffusion on shared coordinates one batched Map.
* :class:`GalerkinAssembler` — the facade over a plan.

The volume Map of a form whose volume part is exactly ``diffusion(rho)`` on
a P1 simplex space runs the hand-written kernel
:func:`repro_torch.kernels.local_stiffness_p1` (P1 gradients are constant,
so every coefficient encoding reduces to one value per element), facet
terms or not, and whether or not an input requires grad (the kernel's
wrapper then records its autograd Function); every other form runs the
einsum Map.  Every Reduce runs :func:`repro_torch.kernels.seg_reduce`.  On
a CUDA plan both are the CUDA kernels, so assembly on the card is
deterministic; on a CPU plan they are the plain versions.
"""

from __future__ import annotations

import functools
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
from .sparse import CSR, BatchedCSR

__all__ = [
    "DTYPE",
    "AssemblyPlan",
    "GalerkinAssembler",
    "assemble",
    "assemble_rhs",
    "assemble_batched",
    "assemble_rhs_batched",
    "build_plan",
    "facet_context",
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


def facet_context(coords, phi, gradhat, w, scalar_facet_dofs=None) -> forms.FormContext:
    """Geometry for (d-1)-facets embedded in R^d: the surface measure
    √det(JᵀJ) replaces |det J| (Neumann/Robin boundary terms route through
    the same Map-Reduce pipeline — paper SM B.1.5)."""
    j = torch.einsum("eai,qaj->eqij", coords, gradhat)     # (F, Q, d, d-1)
    jtj = torch.einsum("eqij,eqik->eqjk", j, j)
    measure = torch.sqrt(_det(jtj))
    xq = torch.einsum("qa,eai->eqi", phi, coords)
    return forms.FormContext(w=w, phi=phi, detj=measure, grad=None, xq=xq,
                             scalar_cell_dofs=scalar_facet_dofs)


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

    def batched_csr(self, vals: torch.Tensor) -> BatchedCSR:
        return BatchedCSR(vals, self.mat_routing.pattern)


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

def _terms(spec, leaves):
    """``(kind, domain, coeffs, scale)`` per term, each slot's value taken
    from ``leaves`` or from its static descriptor."""
    leaf = iter(leaves)
    out = []
    for kind, domain, desc in spec:
        *coeffs, scale = [next(leaf) if d == weakform.TRACED else d[1] for d in desc]
        out.append((kind, domain, coeffs, scale))
    return out


def _p1_element_rho(plan: AssemblyPlan, coords, volume):
    """For a volume part that is exactly ``scale * diffusion(rho)`` on a P1
    simplex space, the per-element coefficient the P1 kernel takes:
    ``ρ_e = scale · Σ_q ŵ_q ρ_eq / |ref|`` (P1 gradients are constant, so
    this is exact for every coefficient encoding; differentiable in ρ,
    ``scale`` and ``coords``).  ``None`` for any other volume part."""
    if len(volume) != 1 or volume[0][0] != "diffusion":
        return None
    if plan.element.name not in ("P1_tri", "P1_tet") or plan.value_size != 1:
        return None
    _, (rho,), scale = volume[0]
    e = coords.shape[0]
    if rho is None:
        rho_e = torch.ones(e, dtype=coords.dtype, device=coords.device)
    elif isinstance(rho, (int, float)) or (isinstance(rho, torch.Tensor) and rho.dim() == 0):
        rho_e = torch.as_tensor(rho, dtype=coords.dtype, device=coords.device).expand(e)
    elif isinstance(rho, torch.Tensor) and tuple(rho.shape) == (e,):
        rho_e = rho.to(device=coords.device)
    else:
        rho_q = forms.eval_coefficient(rho, plan.quadrature_points(coords))
        rho_e = rho_q @ plan.w / plan.w.sum()
    return (rho_e * scale).to(coords.dtype).contiguous()


def _volume_map(plan: AssemblyPlan, coords, volume):
    """The fused volume Map: every volume term against one shared context,
    local matrices/vectors summed term-wise (B1 for P1 diffusion)."""
    rho_e = _p1_element_rho(plan, coords, volume)
    if rho_e is not None:
        return local_stiffness_p1(coords.contiguous(), rho_e)
    ctx = plan.context(coords)
    local_sum = None
    for kind, coeffs, scale in volume:
        local = weakform.KERNELS[kind].fn(ctx, plan.value_size, *coeffs) * scale
        if local_sum is not None and local_sum.shape != local.shape:
            raise ValueError(
                f"term '{kind}' local shape {tuple(local.shape)} does not match "
                f"earlier terms {tuple(local_sum.shape)} — scalar and vector-valued "
                "kernels cannot be fused"
            )
        local_sum = local if local_sum is None else local_sum + local
    return local_sum


def _map_stage(plan: AssemblyPlan, coords, spec, leaves):
    """One fused Map: the volume terms against the shared volume context,
    each facet term against its domain's facet context.  Returns the volume
    local tensor (``None`` without volume terms) and ``{domain: local}``."""
    volume, facet_sums = [], {}
    for kind, domain, coeffs, scale in _terms(spec, leaves):
        if domain is None:
            volume.append((kind, coeffs, scale))
            continue
        local = weakform.KERNELS[kind].fn(domain.context(), plan.value_size, *coeffs) * scale
        prev = facet_sums.get(domain)
        facet_sums[domain] = local if prev is None else prev + local
    return (_volume_map(plan, coords, volume) if volume else None), facet_sums


def _check_facet_coords(spec, coords):
    if coords is not None and any(domain is not None for _, domain, _ in spec):
        # facet geometry comes from the FacetAssembler's construction-time
        # coords; mixing it with overridden volume coords would give
        # inconsistent values and no boundary coordinate gradients
        raise NotImplementedError(
            "assemble(form, coords=...) does not support facet terms: "
            "boundary geometry is fixed at FacetAssembler construction"
        )


def _record(name, plan, spec, is_mat, num_cells, t0):
    telemetry.record_assembly(
        name if is_mat else name.replace("assemble", "assemble_rhs"),
        num_dofs=plan.num_dofs, nnz=plan.nnz if is_mat else None, num_cells=num_cells,
        form="+".join(kind for kind, _, _ in spec),
        wall_us=(time.perf_counter() - t0) * 1e6,
    )


def _assemble_vals(plan: AssemblyPlan, form, arity: str, coords=None) -> torch.Tensor:
    spec, leaves = weakform.lower(form, arity)
    _check_facet_coords(spec, coords)
    c = plan.coords if coords is None else coords
    is_mat = arity == weakform.MATRIX
    t0 = time.perf_counter() if telemetry.is_enabled() else None
    with annotate("tg.map"):
        local, facet_sums = _map_stage(plan, c, spec, leaves)
    with annotate("tg.reduce"):
        if local is not None:
            out = reduce_matrix(local, plan) if is_mat else reduce_vector(local, plan)
        else:
            # facet terms only: zeros in the facet locals' dtype, not the default
            dtype = functools.reduce(torch.promote_types,
                                     [loc.dtype for loc in facet_sums.values()])
            out = torch.zeros(plan.nnz if is_mat else plan.num_dofs, dtype=dtype,
                              device=plan.device)
    with annotate("tg.facet_inject"):
        for domain, loc in facet_sums.items():
            if is_mat:
                # unique positions: index_add is a deterministic, differentiable add
                fvals = seg_reduce(loc, domain.mat_reduce)
                out = out.index_add(0, domain.injection_index(plan.mat_routing),
                                    fvals.to(out.dtype))
            else:
                out = out + seg_reduce(loc, domain.vec_reduce).to(out.dtype)
    if t0 is not None:
        _record("assemble", plan, spec, is_mat, int(c.shape[0]), t0)
    return out


def assemble(plan: AssemblyPlan, form, coords=None) -> CSR:
    """Assemble a bilinear :class:`~repro_torch.core.weakform.WeakForm`
    into a CSR on the plan's pattern: one fused Map, one Reduce; facet terms
    (``robin(alpha, on=facets)``) reduce through their facet routing and
    are added into the volume values.  ``coords`` overrides the plan's
    element coordinates (shape optimisation: gradients flow to it through
    the Map)."""
    return plan.csr(_assemble_vals(plan, form, weakform.MATRIX, coords))


def assemble_rhs(plan: AssemblyPlan, form, coords=None) -> torch.Tensor:
    """Assemble a linear form into a global ``(num_dofs,)`` vector."""
    return _assemble_vals(plan, form, weakform.VECTOR, coords)


# -- batched multi-instance assembly -----------------------------------------

def _lower_batched(plan: AssemblyPlan, form, arity, coords_batch, leaves_batch):
    """The reference's batching conventions: returns ``(spec, leaves,
    coords, coords_batched, leaf_batched, B)`` with ``leaves`` the form's
    own values where a slot is shared."""
    spec, leaves0 = weakform.lower(form, arity)
    if any(domain is not None for _, domain, _ in spec):
        raise NotImplementedError(
            "batched assembly supports volume terms only: facet geometry is "
            "fixed at FacetAssembler construction and cannot vary per instance"
        )
    if leaves_batch is None:
        leaves_batch = (None,) * len(leaves0)
    elif not isinstance(leaves_batch, (tuple, list)):
        # single-tensor convenience: batch the first value slot
        leaves_batch = (leaves_batch,) + (None,) * (len(leaves0) - 1)
    if len(leaves_batch) != len(leaves0):
        raise ValueError(
            f"leaves_batch has {len(leaves_batch)} slots but the form lowers "
            f"to {len(leaves0)} traced leaves (per term: coefficients, then "
            "the scale factor) — pass None for slots shared across the batch"
        )

    def dev(b):
        return b if isinstance(b, torch.Tensor) else torch.as_tensor(b, device=plan.device)

    leaves_batch = tuple(None if b is None else dev(b) for b in leaves_batch)
    merged = tuple(b if b is not None else l0 for b, l0 in zip(leaves_batch, leaves0))
    sizes = {int(b.shape[0]) for b in leaves_batch if b is not None}
    if coords_batch is not None:
        sizes.add(int(coords_batch.shape[0]))
    if not sizes:
        raise ValueError("nothing is batched: pass coords_batch and/or batched leaves")
    if len(sizes) > 1:
        raise ValueError(f"inconsistent batch sizes {sorted(sizes)}")
    coords = plan.coords if coords_batch is None else coords_batch
    batched = tuple(b is not None for b in leaves_batch)
    return spec, merged, coords, coords_batch is not None, batched, sizes.pop()


def _batched_vals(plan: AssemblyPlan, form, arity, coords_batch, leaves_batch):
    spec, leaves, coords, coords_batched, batched, n_inst = _lower_batched(
        plan, form, arity, coords_batch, leaves_batch)
    is_mat = arity == weakform.MATRIX
    t0 = time.perf_counter() if telemetry.is_enabled() else None

    def instance(b):
        c = coords[b] if coords_batched else coords
        lv = tuple(v[b] if is_b else v for v, is_b in zip(leaves, batched))
        return c, [(k, cf, sc) for k, _, cf, sc in _terms(spec, lv)]

    with annotate("tg.map"):
        local = None
        if not coords_batched:
            # P1 diffusion on shared coordinates: one batched B1 launch
            rhos = [_p1_element_rho(plan, *instance(b)) for b in range(n_inst)]
            if n_inst and rhos[0] is not None:
                local = local_stiffness_p1(coords.contiguous(), torch.stack(rhos))
        if local is None:
            local = torch.stack([_volume_map(plan, *instance(b)) for b in range(n_inst)])
    with annotate("tg.reduce"):
        out = seg_reduce(local, plan.mat_reduce if is_mat else plan.vec_reduce, batch=True)
    if t0 is not None:
        _record("assemble_batched", plan, spec, is_mat, plan.num_cells, t0)
    return out


def assemble_batched(plan: AssemblyPlan, form, coords_batch=None,
                     leaves_batch=None) -> BatchedCSR:
    """Assemble B problem instances on the plan's pattern: one batched
    Reduce (B2 over ``(B, E·k²)``) and, for P1 diffusion on shared
    coordinates, one batched Map (B1 over ``ρ (B, E)``); other forms map
    instance by instance.

    ``form`` is the template form (its own coefficient values fill any slot
    not batched).  ``coords_batch (B, E, nv, d)`` batches the geometry;
    ``leaves_batch`` batches coefficients/scales — a tuple aligned with the
    form's value slots (per term: coefficients, then the scale factor),
    each entry ``None`` (shared) or a tensor with a leading batch axis.  A
    bare tensor batches the first slot::

        kb = assemble_batched(plan, wf.diffusion(rho_b[0]),
                              leaves_batch=(rho_b, None))   # (B, E) coeffs

    Returns a :class:`~repro_torch.core.sparse.BatchedCSR` — the shared
    pattern with ``(B, nnz)`` values (see
    :func:`~repro_torch.core.solvers.sparse_solve_batched`)."""
    return plan.batched_csr(
        _batched_vals(plan, form, weakform.MATRIX, coords_batch, leaves_batch))


def assemble_rhs_batched(plan: AssemblyPlan, form, coords_batch=None,
                         leaves_batch=None) -> torch.Tensor:
    """Batched linear-form assembly → ``(B, num_dofs)`` (see
    :func:`assemble_batched` for the batching conventions)."""
    return _batched_vals(plan, form, weakform.VECTOR, coords_batch, leaves_batch)


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

    def assemble_batched(self, form, coords_batch=None, leaves_batch=None) -> BatchedCSR:
        return assemble_batched(self.plan, form, coords_batch, leaves_batch)

    def assemble_rhs_batched(self, form, coords_batch=None,
                             leaves_batch=None) -> torch.Tensor:
        return assemble_rhs_batched(self.plan, form, coords_batch, leaves_batch)
