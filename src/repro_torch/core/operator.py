"""Matrix-free Galerkin operators: ``y = A(form) @ x`` without CSR values.

The torch port of ``repro.core.operator``: single operators, their
element-parallel sharded form (:class:`ShardedMatFreeOperator`) and
families.  The operator applies a bilinear weak form straight from an
:class:`AssemblyPlan`:

    gather   x_e = x[cell_dofs]            (E, k)
    action   y_e = K_e(form) x_e           per element, torch einsum
    scatter  y   = S_vec · vec(y_e)        the Sparse-Reduce onto a vector

The scatter is :func:`~repro_torch.core.assembly.reduce_vector`, so on a
CUDA plan every apply launches B2 (``repro_torch.kernels.seg_reduce``) on
the plan's vector table.  For the built-in kernels the action is fused:
diffusion applies ``𝒢ᵀ(w ρ (𝒢 x_e))`` through (E, Q, d) intermediates and
never forms the (E, k, k) element matrices; other kernels form K_e on the
fly (still no global values).  A single diffusion term on a scalar P1
simplex space, applied without an autograd graph, runs gather and action
as one kernel (:func:`~repro_torch.kernels.matfree_p1_diffusion`: the
geometry is affine, so it reads one of the context's Q gradient blocks);
the telemetry counter ``matfree_action{path=fused|einsum}`` counts the
applies of each path.

Storage strategies (the memory/speed dial):

=========  =====================================  ===========================
store      state beyond the plan                  geometry work per apply
=========  =====================================  ===========================
"coords"   coefficient leaves only                full Stage-I recompute
"context"  the Stage-I FormContext (E·Q·k·d)      none (precomputed)
"local"    the element matrices (E·k²)            none (K_e precomputed)
=========  =====================================  ===========================

``"local"`` forms its element matrices through the assembly's volume Map,
so a P1 diffusion form runs B1 (``local_stiffness_p1``).  Every apply is
differentiable with respect to the operator's tensors (:meth:`traced`):
coefficients, scale factors, coordinates, the context and the element
matrices; :func:`repro_torch.core.solvers.matfree_solve` adds the adjoint
solve on top.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import telemetry
from ..kernels.matfree_p1 import matfree_p1_diffusion
from ..kernels.seg_reduce import seg_reduce
from ..sharding.partitioning import (FemMesh, reduce_from_shards, resolve_fem_mesh,
                                     shard_leaves, to_shard)
from ..telemetry import annotate
from . import forms, weakform
from .assembly import (AssemblyPlan, _batched_map, _lower_batched, _terms, _volume_map,
                       note_signature, reduce_vector)

__all__ = [
    "LinearOperator",
    "MatFreeOperator",
    "MatFreeFamily",
    "ShardedMatFreeOperator",
    "matfree_operator",
    "matfree_family",
    "n_matfree_traces",
]

_N_MF_TRACES = [0]


def n_matfree_traces() -> int:
    """Builds of matrix-free operators and families: one for each (plan,
    form signature, store) the first time an operator of it is built while
    telemetry is on.  Building again with new coefficient or geometry *values* does not grow
    it (the zero-retrace property of the reference's counter)."""
    return _N_MF_TRACES[0]


class LinearOperator:
    """The interface the solver stack dispatches on: anything with
    ``matvec`` / ``rmatvec`` / ``diagonal`` / ``shape`` drives
    :func:`~repro_torch.core.solvers.cg`,
    :func:`~repro_torch.core.solvers.bicgstab`,
    :func:`~repro_torch.core.solvers.jacobi_preconditioner` and
    :func:`~repro_torch.core.solvers.matfree_solve`."""

    shape: tuple[int, int]

    def matvec(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def rmatvec(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def diagonal(self):  # pragma: no cover - interface
        raise NotImplementedError

    def __matmul__(self, x):
        return self.matvec(x)


# ---------------------------------------------------------------------------
# Fused per-element actions: y_e = K_e x_e through (E, Q, ...) intermediates.
# One (action, transpose action, diagonal) triple per weak-form kernel;
# kernels without an entry form K_e (the generic fallback).
# ---------------------------------------------------------------------------

def _diffusion_act(ctx, vs, xe, rho=None):
    rho_q = forms.eval_coefficient(rho, ctx)
    gu = torch.einsum("eqai,ea->eqi", ctx.grad, xe)
    return torch.einsum("eqai,eqi->ea", ctx.grad, (ctx.wdet * rho_q)[..., None] * gu)


def _diffusion_diag(ctx, vs, rho=None):
    rho_q = forms.eval_coefficient(rho, ctx)
    return torch.einsum("eq,eq,eqai,eqai->ea", ctx.wdet, rho_q, ctx.grad, ctx.grad)


def _mass_act(ctx, vs, xe, c=None):
    c_q = forms.eval_coefficient(c, ctx)
    uq = torch.einsum("qa,ea->eq", ctx.phi, xe)
    return torch.einsum("eq,qa->ea", ctx.wdet * c_q * uq, ctx.phi)


def _mass_diag(ctx, vs, c=None):
    c_q = forms.eval_coefficient(c, ctx)
    return torch.einsum("eq,qa,qa->ea", ctx.wdet * c_q, ctx.phi, ctx.phi)


def _advection_act(ctx, vs, xe, beta):
    d = ctx.grad.shape[-1]
    b_q = forms.eval_coefficient(beta, ctx, vector_size=d)
    gu = torch.einsum("eqbi,eb->eqi", ctx.grad, xe)
    s = torch.einsum("eqi,eqi->eq", b_q, gu)
    return torch.einsum("eq,qa->ea", ctx.wdet * s, ctx.phi)


def _advection_act_t(ctx, vs, xe, beta):
    # Kᵀ: y_b = Σ_q ŵ|detJ| (β·𝒢_b) u_q with u_q the interpolated input
    d = ctx.grad.shape[-1]
    b_q = forms.eval_coefficient(beta, ctx, vector_size=d)
    uq = torch.einsum("qa,ea->eq", ctx.phi, xe)
    return torch.einsum("eq,eqi,eqbi->eb", ctx.wdet * uq, b_q, ctx.grad)


def _advection_diag(ctx, vs, beta):
    d = ctx.grad.shape[-1]
    b_q = forms.eval_coefficient(beta, ctx, vector_size=d)
    return torch.einsum("eq,qa,eqi,eqai->ea", ctx.wdet, ctx.phi, b_q, ctx.grad)


def _aniso_act(ctx, vs, xe, a=None, transpose=False):
    d = ctx.grad.shape[-1]
    a_q = forms.eval_tensor_coefficient(a, ctx, d)
    if transpose:
        a_q = a_q.transpose(-1, -2)
    gu = torch.einsum("eqbj,eb->eqj", ctx.grad, xe)
    z = torch.einsum("eqij,eqj->eqi", a_q, gu)
    return torch.einsum("eq,eqai,eqi->ea", ctx.wdet, ctx.grad, z)


def _aniso_act_t(ctx, vs, xe, a=None):
    return _aniso_act(ctx, vs, xe, a, transpose=True)


def _aniso_diag(ctx, vs, a=None):
    d = ctx.grad.shape[-1]
    a_q = forms.eval_tensor_coefficient(a, ctx, d)
    return torch.einsum("eq,eqai,eqij,eqaj->ea", ctx.wdet, ctx.grad, a_q, ctx.grad)


# kind -> (action, transpose action, diagonal); absent → generic K_e fallback
_ACTIONS: dict[str, tuple] = {
    "diffusion": (_diffusion_act, _diffusion_act, _diffusion_diag),
    "mass": (_mass_act, _mass_act, _mass_diag),
    "advection": (_advection_act, _advection_act_t, _advection_diag),
    "anisotropic_diffusion": (_aniso_act, _aniso_act_t, _aniso_diag),
}


def _kernel_apply(k_local, xe, transpose: bool):
    return torch.einsum("eab,ea->eb" if transpose else "eab,eb->ea", k_local, xe)


def _is_symmetric(spec) -> bool:
    return all(weakform.KERNELS[kind].symmetric for kind, _, _ in spec)


def _masked(free_mask, x, apply):
    """Dirichlet condensation around an apply: ``m·A(m·x) + (1−m)·x``
    (``A(x)`` without a mask)."""
    if free_mask is None:
        return apply(x)
    m = free_mask.to(x.dtype)
    return m * apply(m * x) + (1.0 - m) * x


def _masked_diagonal(free_mask, diag):
    """The diagonal of the condensed operator: a unit diagonal on the
    constrained rows."""
    if free_mask is None:
        return diag
    m = free_mask.to(diag.dtype)
    return m * diag + (1.0 - m)


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------

_STORES = ("coords", "context", "local")


@dataclasses.dataclass(frozen=True, eq=False)
class MatFreeOperator(LinearOperator):
    """``y = A(form) @ x`` from an :class:`AssemblyPlan` and a lowered
    :class:`~repro_torch.core.weakform.WeakForm` — build with
    :func:`matfree_operator`.

    The store decides which geometry it holds: ``coords (E, nv, d)``, the
    Stage-I ``ctx``, or the element matrices ``k_local (E, k, k)``.
    ``leaves`` are the form's coefficient and scale values in slot order,
    ``free_mask`` the Dirichlet mask of a condensed operator."""

    plan: AssemblyPlan
    spec: tuple                            # lowered form signature
    store: str
    coords: torch.Tensor | None = None     # store="coords"
    ctx: forms.FormContext | None = None   # store="context"
    k_local: torch.Tensor | None = None    # store="local"
    leaves: tuple = ()
    free_mask: torch.Tensor | None = None  # (n,) 1 = free, 0 = Dirichlet

    @property
    def shape(self) -> tuple[int, int]:
        return (self.plan.num_dofs, self.plan.num_dofs)

    def condensed(self, bc) -> "MatFreeOperator":
        """Dirichlet condensation as an apply wrapper: ``y = m·A(m·x) +
        (1−m)·x`` — rows and columns of constrained DoFs masked and a unit
        diagonal, as :meth:`DirichletCondenser.apply_matrix_only` on the
        assembled matrix."""
        return dataclasses.replace(self, free_mask=bc.free_mask)

    # -- the tensors a gradient reaches -----------------------------------
    def _slots(self) -> tuple:
        ctx = self.ctx
        geo = (ctx.detj, ctx.grad, ctx.xq) if ctx is not None else (None, None, None)
        return (self.coords, self.k_local, *geo, *self.leaves)

    def traced(self) -> tuple[torch.Tensor, ...]:
        """The operator's tensors that the apply differentiates in, in a
        fixed order: ``coords``, ``k_local``, the context's ``detj``,
        ``grad`` and ``xq``, then the tensor leaves (those present)."""
        return tuple(t for t in self._slots() if isinstance(t, torch.Tensor))

    def with_traced(self, tensors) -> "MatFreeOperator":
        """This operator with :meth:`traced`'s tensors replaced, in order."""
        it = iter(tensors)
        coords, k_local, detj, grad, xq, *leaves = (
            next(it) if isinstance(t, torch.Tensor) else t for t in self._slots())
        ctx = self.ctx
        if ctx is not None:
            ctx = dataclasses.replace(ctx, detj=detj, grad=grad, xq=xq)
        return dataclasses.replace(self, coords=coords, k_local=k_local, ctx=ctx,
                                   leaves=tuple(leaves))

    # -- the apply --------------------------------------------------------
    def _context(self) -> forms.FormContext:
        return self.ctx if self.ctx is not None else self.plan.context(self.coords)

    def _term_values(self):
        return [(kind, coeffs, scale) for kind, _, coeffs, scale in _terms(self.spec, self.leaves)]

    def _local_apply(self, xe, transpose: bool):
        if self.k_local is not None:
            return _kernel_apply(self.k_local, xe, transpose)
        ctx, vs = self._context(), self.plan.value_size
        out = None
        for kind, coeffs, scale in self._term_values():
            entry = _ACTIONS.get(kind)
            if entry is not None:
                y = (entry[1] if transpose else entry[0])(ctx, vs, xe, *coeffs)
            else:
                k_local = weakform.KERNELS[kind].fn(ctx, vs, *coeffs)
                y = _kernel_apply(k_local, xe, transpose)
            y = y * scale
            out = y if out is None else out + y
        return out

    def _fused_terms(self, x):
        """``(rho, scale)`` of the diffusion term when this apply may run
        gather and action as the fused P1 kernel, else ``None``: one
        diffusion term on a scalar P1 simplex space (affine geometry), a
        context to read (no stored element matrices), a scalar scale, and
        no autograd graph to record — grad mode off, or none of ``x`` and
        :meth:`traced` requires grad and the coefficient is no callable
        (which may close over a tensor that does)."""
        if self.k_local is not None or len(self.spec) != 1 or self.spec[0][0] != "diffusion":
            return None
        if not self.plan.p1_simplex:
            return None
        _, (rho,), scale = self._term_values()[0]
        if isinstance(scale, torch.Tensor) and scale.numel() != 1:
            return None
        if torch.is_grad_enabled() and (callable(rho) or x.requires_grad
                                        or any(t.requires_grad for t in self.traced())):
            return None
        return rho, scale

    def _fused_action(self, x, rho, scale):
        """y_e of every element by the fused P1 diffusion kernel."""
        ctx = self._context()
        if rho is not None and not isinstance(rho, (int, float)):
            rho = forms.eval_coefficient(rho, ctx).to(ctx.grad.dtype)
        if isinstance(scale, torch.Tensor):  # a host scalar goes in as a number
            scale = float(scale) if scale.device.type == "cpu" else scale.to(ctx.grad.dtype)
        return matfree_p1_diffusion(x, self.plan.cell_dofs, ctx.grad, ctx.detj, ctx.w, rho,
                                    scale)

    def _scatter_apply(self, x, transpose: bool):
        """Gather, per-element action, B2 scatter: ``A x`` without the
        Dirichlet mask; gather and action in one kernel where
        :meth:`_fused_terms` allows (that action is symmetric, so
        ``transpose`` does not matter there)."""
        fused = self._fused_terms(x)
        telemetry.counter_inc("matfree_action", 1, path="einsum" if fused is None else "fused")
        if fused is None:
            with annotate("tg.matfree.gather"):
                xe = x[self.plan.cell_dofs]
            with annotate("tg.matfree.action"):
                y_local = self._local_apply(xe, transpose)
        else:
            with annotate("tg.matfree.action"):
                y_local = self._fused_action(x, *fused)
        with annotate("tg.matfree.scatter"):
            return reduce_vector(y_local, self.plan)

    def _apply(self, x, transpose: bool):
        return _masked(self.free_mask, x, lambda v: self._scatter_apply(v, transpose))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x``: gather, per-element action, B2 scatter."""
        return self._apply(x, False)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = Aᵀ x``: the row and column dof maps coincide, so the
        transpose is the same pipeline with the per-element action
        transposed (kernels declared ``symmetric`` reuse the forward
        action)."""
        return self._apply(x, not (self.k_local is None and _is_symmetric(self.spec)))

    def _diag_local(self):
        if self.k_local is not None:
            return torch.diagonal(self.k_local, dim1=-2, dim2=-1)
        ctx, vs = self._context(), self.plan.value_size
        out = None
        for kind, coeffs, scale in self._term_values():
            entry = _ACTIONS.get(kind)
            if entry is not None:
                d = entry[2](ctx, vs, *coeffs)
            else:
                d = torch.diagonal(weakform.KERNELS[kind].fn(ctx, vs, *coeffs), dim1=-2, dim2=-1)
            d = d * scale
            out = d if out is None else out + d
        return out

    def diagonal(self) -> torch.Tensor:
        """diag(A) by a diagonal-only assembly: per-element diagonals
        reduced onto the dofs (B2 on a CUDA plan), no nnz vector."""
        return _masked_diagonal(self.free_mask, reduce_vector(self._diag_local(), self.plan))

    def element_matrices(self) -> torch.Tensor:
        """The per-element tensors ``K_e`` of this form, ``(E, k, k)``:
        the stored ones for ``store="local"``, else the assembly's volume
        Map on the operator's geometry (B1 for P1 diffusion from
        coordinates).  The Dirichlet mask is not applied."""
        if self.k_local is not None:
            return self.k_local
        return _volume_map(self.plan, self.coords, self._term_values(), ctx=self.ctx)

    def is_spd(self) -> bool:
        """True when every kernel of the form is declared SPD."""
        return all(weakform.KERNELS[kind].spd for kind, _, _ in self.spec)

    def sharded(self, mesh: FemMesh | None = None,
                axis_name: str | None = None) -> "ShardedMatFreeOperator":
        """This operator with its applies split over the element axis of a
        mesh of ranks (default: :func:`~repro_torch.sharding.fem_mesh` on
        the plan's device) — see :class:`ShardedMatFreeOperator`.  The
        rank's block of the plan and its vector Reduce table are built at
        the first apply, once per plan and mesh."""
        mesh = resolve_fem_mesh(mesh, axis_name, self.plan.device)
        note_signature(self.plan, ("matfree_sharded", self.store, self.spec, mesh.size,
                                   mesh.rank), "matfree", self.spec, _N_MF_TRACES,
                       backend=f"sharded_{self.store}")
        return ShardedMatFreeOperator(self, mesh)

    def state_bytes(self) -> int:
        """Bytes of state this operator carries beyond the plan (a
        ``"coords"`` operator shares the plan's coordinates)."""
        tensors = [self.k_local, self.free_mask, *self.leaves]
        if self.store == "context":
            tensors += [getattr(self.ctx, f.name) for f in dataclasses.fields(self.ctx)]
        return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def _check_volume(spec, what: str) -> None:
    if any(domain is not None for _, domain, _ in spec):
        raise NotImplementedError(
            f"{what} supports volume terms only: assemble facet terms into a CSR "
            "and combine, or condense them into the right-hand side")


def _local_spec(spec) -> tuple:
    """The signature of a ``"local"`` operator: the kinds only (its element
    matrices hold the coefficients)."""
    return tuple((kind, None, ()) for kind, _, _ in spec)


def matfree_operator(plan: AssemblyPlan, form, store: str = "context",
                     coords=None) -> MatFreeOperator:
    """Build the matrix-free operator of a bilinear form on a plan.

    ``store`` picks the memory/speed point (module docstring):
    ``"context"`` (default) precomputes the Stage-I geometry once;
    ``"coords"`` recomputes it per apply; ``"local"`` precomputes the
    element matrices.  ``coords`` overrides the plan's element
    coordinates.  ``op.matvec(x)`` equals ``assemble(plan, form).matvec(x)``
    to rounding."""
    if store not in _STORES:
        raise ValueError(f"unknown store {store!r}; use one of {_STORES}")
    spec, leaves = weakform.lower(form, weakform.MATRIX)
    _check_volume(spec, "the matrix-free apply")
    note_signature(plan, ("matfree", store, spec), "matfree", spec, _N_MF_TRACES,
                   backend=store)
    c = plan.coords if coords is None else coords
    op = MatFreeOperator(plan, spec, store, coords=c, leaves=leaves)
    if store == "context":
        op = dataclasses.replace(op, ctx=plan.context(c), coords=None)
    elif store == "local":
        op = dataclasses.replace(op, k_local=op.element_matrices(), coords=None, leaves=(),
                                 spec=_local_spec(spec))
    telemetry.gauge_set("operator_state_bytes", op.state_bytes(), store=store)
    return op


# ---------------------------------------------------------------------------
# Element-parallel sharding: the same gather → action → scatter apply, with
# the element axis split over a mesh of ranks (a partial scatter a rank and
# one all-reduce)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedMatFreeOperator(LinearOperator):
    """A :class:`MatFreeOperator` whose applies are split over the element
    axis of a :class:`~repro_torch.sharding.FemMesh`.

    Per apply, each rank gathers from the replicated ``(n,)`` vector into
    its own element block only, runs the per-element action on that
    block, reduces it with B2 on its block's table to a partial vector, and
    one all-reduce completes the Sparse-Reduce: the gather, the action's
    (E, Q, ...) state and the local results exist only as the rank's
    block.  ``matvec`` / ``rmatvec`` / ``diagonal`` all split so, and the
    Dirichlet mask runs on the replicated vector, so
    :func:`~repro_torch.core.solvers.matfree_solve` (and its adjoint solve
    and operator pullback) runs sharded end to end, with every rank
    calling it.  :meth:`traced` and :meth:`with_traced` take the *whole*
    tensors of the wrapped operator: a rank's block enters its apply
    through :func:`~repro_torch.sharding.to_shard`, whose backward
    all-reduces, so every rank gets the whole gradient.  Build with
    :meth:`MatFreeOperator.sharded`."""

    op: MatFreeOperator
    mesh: FemMesh

    @property
    def shape(self) -> tuple[int, int]:
        return self.op.shape

    def condensed(self, bc) -> "ShardedMatFreeOperator":
        """Dirichlet condensation, the same apply wrapper as the single
        operator's (it runs on the replicated vector)."""
        return dataclasses.replace(self, op=self.op.condensed(bc))

    def traced(self) -> tuple[torch.Tensor, ...]:
        return self.op.traced()

    def with_traced(self, tensors) -> "ShardedMatFreeOperator":
        return dataclasses.replace(self, op=self.op.with_traced(tensors))

    def state_bytes(self) -> int:
        return self.op.state_bytes()

    def _block(self) -> MatFreeOperator:
        """The rank's block of the operator, on the plan's
        :class:`~repro_torch.core.assembly.PlanShard`: its block of the
        coordinates, context or element matrices and of the per-element
        leaves (through ``to_shard``), the other leaves whole, no mask."""
        op, mesh = self.op, self.mesh
        shard = op.plan.shard(mesh)
        lo, hi = shard.block

        def cut(t):
            return None if t is None else to_shard(t, mesh, (lo, hi))

        ctx = op.ctx
        if ctx is not None:
            scd = ctx.scalar_cell_dofs
            ctx = dataclasses.replace(ctx, detj=cut(ctx.detj), grad=cut(ctx.grad), xq=cut(ctx.xq),
                                      scalar_cell_dofs=None if scd is None else scd[lo:hi])
        return dataclasses.replace(
            op, plan=shard, coords=cut(op.coords), ctx=ctx, k_local=cut(op.k_local),
            leaves=shard_leaves(op.leaves, op.plan.num_cells, mesh, (lo, hi), shard.device),
            free_mask=None)

    def _apply(self, x, transpose: bool):
        def apply(v):
            part = self._block()._scatter_apply(to_shard(v, self.mesh), transpose)
            with annotate("tg.matfree.all_reduce"):
                return reduce_from_shards(part, self.mesh)

        return _masked(self.op.free_mask, x, apply)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x``: the rank's gather, action and B2 scatter, then one
        all-reduce."""
        return self._apply(x, False)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = Aᵀ x`` (kernels declared ``symmetric`` reuse the forward
        action)."""
        op = self.op
        return self._apply(x, not (op.k_local is None and _is_symmetric(op.spec)))

    def diagonal(self) -> torch.Tensor:
        """diag(A) by a sharded diagonal-only assembly: the rank's element
        diagonals reduced (B2), then one all-reduce."""
        block = self._block()
        part = reduce_vector(block._diag_local(), block.plan)
        with annotate("tg.matfree.all_reduce"):
            return _masked_diagonal(self.op.free_mask, reduce_from_shards(part, self.mesh))


# ---------------------------------------------------------------------------
# Batched families: B same-signature operators on one shared plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class MatFreeFamily(LinearOperator):
    """A family of B matrix-free operators on one plan and one form
    signature — the matrix-free twin of
    :class:`~repro_torch.core.sparse.BatchedCSR`.

    ``op`` carries the batched leaves (a leading ``(B, ...)`` axis where
    ``leaf_axes`` says 0), batched coordinates (``coords_ax``) or batched
    element matrices (``k_local_ax``); the rest is shared.

    * ``matvec(X)`` / ``rmatvec(X)`` — ``(B, n)`` (an ``(n,)`` input is
      shared), the B scatters in one batched B2 launch;
    * ``diagonal()`` — ``(B, n)``, one batched B2 launch;
    * ``condensed(bc)`` — one shared Dirichlet mask;
    * ``family[i]`` — instance ``i`` as a :class:`MatFreeOperator`.

    Built by :func:`matfree_family`."""

    op: MatFreeOperator
    batch: int
    leaf_axes: tuple                # per leaf: 0 (batched) or None (shared)
    coords_ax: int | None = None
    k_local_ax: int | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.op.shape  # per instance, as BatchedCSR

    def __getitem__(self, b: int) -> MatFreeOperator:
        if not isinstance(b, (int, np.integer)):
            raise TypeError(f"MatFreeFamily indices must be int, got {type(b).__name__}")
        op = self.op
        leaves = tuple(leaf[b] if ax == 0 else leaf for leaf, ax in zip(op.leaves, self.leaf_axes))
        coords = op.coords[b] if self.coords_ax == 0 else op.coords
        k_local = op.k_local[b] if self.k_local_ax == 0 else op.k_local
        return dataclasses.replace(op, leaves=leaves, coords=coords, k_local=k_local)

    def condensed(self, bc) -> "MatFreeFamily":
        """Shared-mask Dirichlet condensation of the whole family."""
        return dataclasses.replace(self, op=self.op.condensed(bc))

    def _reduce(self, local: torch.Tensor) -> torch.Tensor:
        # the kernel reads (B, n_src) rows in place: a strided view must be copied
        return seg_reduce(local.contiguous(), self.op.plan.vec_reduce, batch=True)

    def _scatter_apply(self, xb, transpose: bool):
        op = self.op
        telemetry.counter_inc("matfree_action", 1, path="einsum")
        with annotate("tg.matfree.gather"):
            xe = xb[:, op.plan.cell_dofs]
        with annotate("tg.matfree.action"):
            if self.k_local_ax == 0:
                sub = "neab,nea->neb" if transpose else "neab,neb->nea"
                y_local = torch.einsum(sub, op.k_local, xe)
            else:
                y_local = torch.stack([self[b]._local_apply(xe[b], transpose)
                                       for b in range(self.batch)])
        with annotate("tg.matfree.scatter"):
            return self._reduce(y_local)

    def _apply(self, x, transpose: bool):
        xb = x if x.dim() == 2 else x.expand(self.batch, -1)
        return _masked(self.op.free_mask, xb, lambda v: self._scatter_apply(v, transpose))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``Y_b = A_b @ x_b`` for ``x (B, n)`` (an ``(n,)`` x is shared)."""
        return self._apply(x, False)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        op = self.op
        return self._apply(x, not (op.k_local is None and _is_symmetric(op.spec)))

    def diagonal(self) -> torch.Tensor:
        """Per-instance diagonals ``(B, n)`` by one batched diagonal-only
        assembly."""
        if self.k_local_ax == 0:
            local = torch.diagonal(self.op.k_local, dim1=-2, dim2=-1)
        else:
            local = torch.stack([self[b]._diag_local() for b in range(self.batch)])
        return _masked_diagonal(self.op.free_mask, self._reduce(local))

    def state_bytes(self) -> int:
        return self.op.state_bytes()


def matfree_family(plan: AssemblyPlan, form, leaves_batch=None, store: str = "context",
                   coords_batch=None) -> MatFreeFamily:
    """Build a batched matrix-free family on one shared plan.

    ``form`` is the template form; ``leaves_batch`` batches its value slots
    with the conventions of :func:`~repro_torch.core.assemble_batched` (per
    term: coefficients, then the scale factor; ``None`` for a shared slot;
    a bare tensor batches the first slot)::

        fam = matfree_family(plan, wf.diffusion(rho_b[0]),
                             leaves_batch=(rho_b, None))     # (B, E) coeffs

    ``coords_batch (B, E, nv, d)`` batches the geometry and forces
    ``store="coords"``.  With ``store="local"`` the element matrices of
    all B instances are formed at construction: for P1 diffusion on shared
    coordinates in one batched B1 launch."""
    if store not in _STORES:
        raise ValueError(f"unknown store {store!r}; use one of {_STORES}")
    _check_volume(weakform.lower(form, weakform.MATRIX)[0], "a matrix-free family")
    spec, merged, coords, coords_batched, batched, n_inst = _lower_batched(
        plan, form, weakform.MATRIX, coords_batch, leaves_batch)
    if coords_batched:
        store = "coords"
    note_signature(plan, ("matfree_family", store, spec, coords_batched, batched), "matfree",
                   spec, _N_MF_TRACES, backend=f"family_{store}")
    if store == "local":
        k_b = _batched_map(plan, spec, merged, coords, False, batched, n_inst)
        op = MatFreeOperator(plan, _local_spec(spec), "local", k_local=k_b)
        family = MatFreeFamily(op, n_inst, (), k_local_ax=0)
    else:
        ctx = plan.context(coords) if store == "context" else None
        op = MatFreeOperator(plan, spec, store, coords=coords if store == "coords" else None,
                             ctx=ctx, leaves=merged)
        family = MatFreeFamily(op, n_inst, tuple(0 if b else None for b in batched),
                               coords_ax=0 if coords_batched else None)
    telemetry.gauge_set("operator_state_bytes", family.state_bytes(), store=f"family_{store}")
    return family
