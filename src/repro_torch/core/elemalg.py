"""Element tensor algebra: dense local algebra on ``(E, k, k)`` tensors.

The torch port of ``repro.core.elemalg``.  The Map stage's per-element
tensors ``K_e`` are treated as a batch of dense matrices:

* :func:`factorize` / :class:`ElementFactors` — batched Cholesky
  (``torch.linalg.cholesky_ex``, for forms whose kernels are declared
  ``spd``) or LU with partial pivoting (``torch.linalg.lu_factor_ex``) over
  all E elements at once, with :meth:`ElementFactors.solve`.  The ``_ex``
  forms check nothing on the host; a Cholesky factor that fails is set to
  NaN, as the reference's is, so the Krylov loop that uses it reports it.
* :func:`block_partition` — static sub-blocks ``K_e[rows, cols]``.
* **Static condensation** (:func:`vertex_split` → :func:`condense` →
  :func:`condensed_solve`): the vertex DoFs of a P2 space are the
  interface, the edge DoFs are eliminated element by element, and the
  Krylov iteration runs on the Schur complement ``S = K_bb − K_bi K_ii⁻¹
  K_ib`` alone.  Every block apply is a gather, a batched block product and
  a scatter onto a compact numbering (B2 on a CUDA plan, on tables built
  once per scaffold); ``K_ii⁻¹`` is an inner CG.  The gradient of
  :func:`condensed_solve` is the uncondensed adjoint's.
* Two preconditioners, registered on import (``make_preconditioner`` looks
  the names up lazily):

  - ``"ebe"`` (:func:`ebe_preconditioner`): element-by-element additive
    Schwarz on ``C_e = θI + s K_e s`` (``s = diag(A)^{-1/2}``), factorized
    once; each apply is a gather, a batched solve and the plan's vector
    Reduce (B2).
  - ``"chebyshev"`` (:func:`chebyshev_preconditioner`): a fixed-degree
    Chebyshev polynomial in ``D⁻¹A`` on an eigenvalue window from power
    iterations run once at build time (``λ_max`` stays on the device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.seg_reduce import ReduceTable, seg_reduce
from ..telemetry import annotate, events
from .assembly import reduce_vector
from .operator import _kernel_apply
from .routing import build_vector_routing
from .solvers import SolveInfo, SolverSpec, _method, register_preconditioner
from .sparse import cached_diagonal

__all__ = [
    "ElementFactors",
    "factorize",
    "block_partition",
    "masked_element_matrices",
    "DofSplit",
    "dof_split",
    "vertex_split",
    "CondensedSystem",
    "condense",
    "condensed_solve",
    "ebe_preconditioner",
    "chebyshev_preconditioner",
]


# ---------------------------------------------------------------------------
# Batched factorize / solve / block-partition primitives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElementFactors:
    """A batched factorization of ``(E, k, k)`` element tensors.

    ``piv is None`` ⇒ lower Cholesky factors ``(E, k, k)``; otherwise LU
    factors with ``(E, k)`` int32 pivots (1-based, as torch gives them)."""

    data: torch.Tensor
    piv: torch.Tensor | None = None

    @property
    def is_cholesky(self) -> bool:
        return self.piv is None

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve all E local systems at once: ``rhs`` is ``(E, k)`` or
        ``(E, k, m)``; returns the same shape."""
        vec = rhs.dim() == 2
        r = rhs[..., None] if vec else rhs
        if self.piv is None:
            y = torch.linalg.solve_triangular(self.data, r, upper=False)
            x = torch.linalg.solve_triangular(self.data.transpose(-1, -2), y, upper=True)
        else:
            x = torch.linalg.lu_solve(self.data, self.piv, r)
        return x[..., 0] if vec else x


def factorize(k_e: torch.Tensor, spd: bool = False) -> ElementFactors:
    """Factorize a batch of element tensors: Cholesky when ``spd``
    (diffusion, mass, elasticity), batched LU with partial pivoting
    otherwise (advection, general anisotropic tensors)."""
    if spd:
        chol, info = torch.linalg.cholesky_ex(k_e)
        return ElementFactors(torch.where((info > 0)[:, None, None], torch.nan, chol))
    lu, piv, _ = torch.linalg.lu_factor_ex(k_e)
    return ElementFactors(lu, piv)


def block_partition(k_e: torch.Tensor, rows, cols=None) -> torch.Tensor:
    """The static sub-block ``K_e[rows, cols]`` of every element tensor —
    ``rows``/``cols`` are local-slot index arrays (``cols`` defaults to
    ``rows``).  Returns ``(E, len(rows), len(cols))``."""
    r = torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=k_e.device)
    c = r if cols is None else torch.as_tensor(np.asarray(cols), dtype=torch.int64,
                                               device=k_e.device)
    return k_e[:, r[:, None], c[None, :]]


def masked_element_matrices(op) -> torch.Tensor:
    """``op.element_matrices()`` with the Dirichlet rows and columns zeroed
    by the operator's ``free_mask`` (the condensed apply ``y = m·A(m·x) +
    (1−m)·x`` up to its unit diagonal, which callers reinstate globally)."""
    base = _base_op(op)
    k_e = base.element_matrices()
    if base.free_mask is None:
        return k_e
    me = base.free_mask.to(k_e.dtype)[base.plan.cell_dofs]
    return k_e * me[:, :, None] * me[:, None, :]


def _base_op(op):
    """The operator that carries element tensors (a wrapper delegates to
    its inner operator under ``.op``)."""
    if hasattr(op, "element_matrices"):
        return op
    inner = getattr(op, "op", None)
    if inner is not None and hasattr(inner, "element_matrices"):
        return inner
    raise TypeError(
        f"{type(op).__name__} carries no element tensors — element-level "
        "algebra (ebe preconditioner, static condensation) needs a "
        "matrix-free operator (repro_torch.core.matfree_operator); assembled CSR "
        "solves can use precond='jacobi' or 'chebyshev'"
    )


# ---------------------------------------------------------------------------
# Static condensation: interface/interior split + Schur-complement system
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DofSplit:
    """An interface/interior partition of a space's DoFs that is uniform in
    local slots: every element sees the same local slots as interface (kept
    in the condensed system) and interior (eliminated)."""

    interface_mask: np.ndarray   # (n,) bool — True = interface DoF
    interface_slots: np.ndarray  # (kb,) local slots holding interface DoFs
    interior_slots: np.ndarray   # (ki,) local slots holding interior DoFs


def dof_split(cell_dofs, interface_mask) -> DofSplit:
    """Build a :class:`DofSplit` from the element DoF map and a boolean
    interface mask, checking that the split is slot-uniform across
    elements."""
    cd = np.asarray(cell_dofs)
    im = np.asarray(interface_mask, dtype=bool)
    slot_if = im[cd]                      # (E, k)
    col_if = slot_if.all(axis=0)
    col_in = (~slot_if).all(axis=0)
    if not (col_if | col_in).all():
        bad = np.where(~(col_if | col_in))[0]
        raise ValueError(
            f"interface split is not slot-uniform: local slots {bad.tolist()} "
            "mix interface and interior DOFs across elements"
        )
    if not col_in.any():
        raise ValueError(
            "no interior DOFs to condense — static condensation needs a "
            "degree ≥ 2 space (P2/P3: edge/bubble DOFs)"
        )
    return DofSplit(im, np.where(col_if)[0], np.where(col_in)[0])


def vertex_split(space) -> DofSplit:
    """The condensation split of a P2 space: vertex DoFs are the interface,
    the edge DoFs are interior."""
    nv = space.mesh.num_vertices
    im = (np.arange(space.num_dofs) // space.value_size) < nv
    return dof_split(space.cell_dofs, im)


@dataclasses.dataclass(frozen=True, eq=False)
class _Scaffold:
    """The static tables of one condensed system: compact interface and
    interior numberings, the per-element gather maps into them (index
    ``nb``/``ni`` is the padding row of Dirichlet DoFs, whose element rows
    and columns are masked to zero), and their device copies with the
    Reduce tables of the compact scatters (onto ``nb + 1`` / ``ni + 1``
    rows)."""

    cell_b: np.ndarray          # (E, kb) compact interface ids, nb = padding
    cell_i: np.ndarray          # (E, ki) compact interior ids, ni = padding
    interface_dofs: np.ndarray  # (nb,) global ids of free interface DoFs
    interior_dofs: np.ndarray   # (ni,) global ids of free interior DoFs
    nb: int
    ni: int
    n: int
    dev: dict                   # the four arrays above as int64 device tensors
    reduce_b: ReduceTable       # cell_b's slots onto nb + 1 rows
    reduce_i: ReduceTable       # cell_i's slots onto ni + 1 rows


def _build_scaffold(plan, split: DofSplit, free_mask) -> _Scaffold:
    cd = plan.cell_dofs.cpu().numpy()
    n = plan.num_dofs
    free = (np.ones(n, dtype=bool) if free_mask is None
            else free_mask.cpu().numpy() > 0)
    b_dofs = np.where(split.interface_mask & free)[0]
    i_dofs = np.where(~split.interface_mask & free)[0]
    nb, ni = b_dofs.shape[0], i_dofs.shape[0]
    lut_b = np.full(n, nb, dtype=np.int64)
    lut_b[b_dofs] = np.arange(nb)
    lut_i = np.full(n, ni, dtype=np.int64)
    lut_i[i_dofs] = np.arange(ni)
    cell_b = lut_b[cd[:, split.interface_slots]]
    cell_i = lut_i[cd[:, split.interior_slots]]
    device = plan.device
    arrays = {"cell_b": cell_b, "cell_i": cell_i, "interface_dofs": b_dofs,
              "interior_dofs": i_dofs}
    return _Scaffold(
        cell_b=cell_b, cell_i=cell_i, interface_dofs=b_dofs, interior_dofs=i_dofs,
        nb=nb, ni=ni, n=n,
        dev={k: torch.as_tensor(v, dtype=torch.int64, device=device) for k, v in arrays.items()},
        reduce_b=ReduceTable.for_vector(build_vector_routing(cell_b, nb + 1), device),
        reduce_i=ReduceTable.for_vector(build_vector_routing(cell_i, ni + 1), device),
    )


# scaffold per (plan, split, bc mask) identity — the values hold the keys'
# objects, so their ids cannot be recycled while cached
_SCAFFOLDS: dict[tuple, tuple] = {}
_SCAFFOLDS_LIMIT = 64


def _scaffold(op, split: DofSplit) -> _Scaffold:
    key = (id(op.plan), id(split), id(op.free_mask))
    hit = _SCAFFOLDS.get(key)
    if hit is not None:
        return hit[1]
    sc = _build_scaffold(op.plan, split, op.free_mask)
    while len(_SCAFFOLDS) >= _SCAFFOLDS_LIMIT:
        _SCAFFOLDS.pop(next(iter(_SCAFFOLDS)))
    _SCAFFOLDS[key] = ((op.plan, split, op.free_mask), sc)
    return sc


def _gather(x, idx):
    """Pad-gather: a compact vector and one trailing zero, indexed by a map
    that sends constrained DoFs to the padding slot."""
    return torch.cat([x, x.new_zeros(1)])[idx]


def _scatter(y_local, table: ReduceTable, num: int):
    """The compact scatter: B2 (the plain version on the CPU) onto
    ``num + 1`` rows, the padding row dropped."""
    return seg_reduce(y_local, table)[:num]


_INNER_DEFAULT = SolverSpec(method="cg", tol=1e-12, atol=1e-12, maxiter=2000,
                            precond="jacobi")


@dataclasses.dataclass(frozen=True, eq=False)
class CondensedSystem:
    """The interface Schur-complement system of a matrix-free operator,
    applied through per-element blocks.

    ``S x_b = (K_bb − K_bi K_ii⁻¹ K_ib) x_b``: every block apply is a
    gather, a batched ``(E, ·, ·)`` block product and a compact scatter, and
    ``K_ii⁻¹`` is an inner Krylov solve on the interior system (Jacobi by
    default, or element by element with the factorized interior blocks).
    Nothing global is formed; ``shape`` is ``(nb, nb)`` with ``nb < n``."""

    op: object                  # the (Dirichlet-condensed) MatFreeOperator
    split: DofSplit
    kbb: torch.Tensor           # (E, kb, kb)
    kbi: torch.Tensor           # (E, kb, ki)
    kib: torch.Tensor           # (E, ki, kb)
    kii: torch.Tensor           # (E, ki, ki)
    ii_factors: ElementFactors  # factorized regularized interior blocks
    diag_b: torch.Tensor        # (nb,) assembled interface diagonal
    diag_i: torch.Tensor        # (ni,) assembled interior diagonal
    sc: _Scaffold
    inner: SolverSpec

    @property
    def shape(self) -> tuple[int, int]:
        return (self.sc.nb, self.sc.nb)

    @property
    def full_shape(self) -> tuple[int, int]:
        return (self.sc.n, self.sc.n)

    # -- block applies ----------------------------------------------------
    def _apply_block(self, block, x, idx_in, table_out, num_out):
        return _scatter(_kernel_apply(block, _gather(x, idx_in), False), table_out, num_out)

    def kbb_matvec(self, xb):
        sc = self.sc
        return self._apply_block(self.kbb, xb, sc.dev["cell_b"], sc.reduce_b, sc.nb)

    def kii_matvec(self, xi):
        sc = self.sc
        return self._apply_block(self.kii, xi, sc.dev["cell_i"], sc.reduce_i, sc.ni)

    def kib_matvec(self, xb):
        sc = self.sc
        return self._apply_block(self.kib, xb, sc.dev["cell_b"], sc.reduce_i, sc.ni)

    def kbi_matvec(self, xi):
        sc = self.sc
        return self._apply_block(self.kbi, xi, sc.dev["cell_i"], sc.reduce_b, sc.nb)

    # -- interior solve (inner Krylov) --------------------------------------
    def _ii_precond(self):
        one = torch.ones((), dtype=self.diag_i.dtype, device=self.diag_i.device)
        inv = torch.where(self.diag_i.abs() > 0, 1.0 / self.diag_i, one)
        if self.inner.precond == "ebe":
            dinv_sqrt = inv.abs().sqrt()
            ci, fac, sc = self.sc.dev["cell_i"], self.ii_factors, self.sc

            def m(x):
                xs = _gather(x * dinv_sqrt, ci)
                return _scatter(fac.solve(xs), sc.reduce_i, sc.ni) * dinv_sqrt
            return m
        if self.inner.precond in ("identity", "none"):
            return lambda x: x
        return lambda x: inv * x  # jacobi (default)

    def ii_solve(self, fi, x0=None) -> tuple[torch.Tensor, SolveInfo]:
        """``K_ii⁻¹ fi`` by the inner Krylov solve."""
        inner = self.inner
        return _method(inner.method)(self.kii_matvec, fi, x0, tol=inner.tol, atol=inner.atol,
                                     maxiter=inner.maxiter, m=self._ii_precond())

    # -- the Schur apply --------------------------------------------------
    def matvec(self, xb):
        with annotate("tg.elemalg.schur_apply"):
            yi, _ = self.ii_solve(self.kib_matvec(xb))
            return self.kbb_matvec(xb) - self.kbi_matvec(yi)

    rmatvec = matvec  # condensation requires a symmetric operator

    def diagonal(self):
        """diag(K_bb): the Jacobi surrogate for diag(S), whose true
        diagonal would cost nb interior solves."""
        return self.diag_b

    # -- rhs reduction / interior recovery --------------------------------
    def reduce_rhs(self, b):
        fb = b[self.sc.dev["interface_dofs"]]
        wi, _ = self.ii_solve(b[self.sc.dev["interior_dofs"]])
        return fb - self.kbi_matvec(wi)

    def recover(self, xb, b):
        """Interior recovery ``u_i = K_ii⁻¹ (f_i − K_ib u_b)`` and
        re-expansion to the full DoF vector (constrained DoFs take their
        lifted values from ``b``, as the uncondensed solve's do)."""
        dev = self.sc.dev
        ui, _ = self.ii_solve(b[dev["interior_dofs"]] - self.kib_matvec(xb))
        x = xb.new_zeros(self.sc.n)
        x = x.index_copy(0, dev["interface_dofs"], xb).index_copy(0, dev["interior_dofs"], ui)
        fm = self.op.free_mask
        if fm is not None:
            m = fm.to(x.dtype)
            x = m * x + (1.0 - m) * b
        return x

    def solve(self, b, spec: SolverSpec | None = None) -> tuple[torch.Tensor, SolveInfo]:
        """Full condensed solve: reduce the right-hand side, run the outer
        Krylov on the interface Schur system, recover the interior.
        Returns ``(x_full, SolveInfo)``; the info counts outer
        iterations."""
        spec = _COND_DEFAULT if spec is None else spec
        g = self.reduce_rhs(b)
        if spec.precond in ("identity", "none"):
            m = lambda x: x  # noqa: E731
        else:
            one = torch.ones((), dtype=self.diag_b.dtype, device=self.diag_b.device)
            inv = torch.where(self.diag_b.abs() > 0, 1.0 / self.diag_b, one)
            m = lambda x: inv * x  # noqa: E731
        xb, info = _method(spec.method)(self.matvec, g, tol=spec.tol, atol=spec.atol,
                                        maxiter=spec.maxiter, m=m)
        return self.recover(xb, b), info


_COND_DEFAULT = SolverSpec(method="cg", tol=1e-10, atol=1e-10, maxiter=10000,
                           precond="jacobi")


def condense(op, split: DofSplit, inner: SolverSpec | None = None,
             transpose: bool = False) -> CondensedSystem:
    """Build the interface Schur-complement system of ``op`` (a matrix-free
    operator, normally already ``.condensed(bc)``) for a :class:`DofSplit`
    — see :class:`CondensedSystem`.  ``transpose`` condenses ``Aᵀ``."""
    base = _base_op(op)
    sc = _scaffold(base, split)
    dev = sc.dev
    with annotate("tg.elemalg.condense"):
        k_e = masked_element_matrices(base)
        if transpose:
            k_e = k_e.transpose(-1, -2)
        bs, is_ = split.interface_slots, split.interior_slots
        kbb = block_partition(k_e, bs)
        kbi = block_partition(k_e, bs, is_)
        kib = block_partition(k_e, is_, bs)
        kii = block_partition(k_e, is_)
        diag = cached_diagonal(base)
        diag_b = diag[dev["interface_dofs"]]
        diag_i = diag[dev["interior_dofs"]]
        # regularized interior blocks for the inner EbE preconditioner:
        # I + s K_ii s is SPD whenever K_e is PSD
        one = torch.ones((), dtype=diag.dtype, device=diag.device)
        inv_i = torch.where(diag.abs() > 0, 1.0 / diag.abs(), one)
        s_e = _gather(inv_i[dev["interior_dofs"]], dev["cell_i"]).sqrt()
        c_e = torch.eye(kii.shape[-1], dtype=kii.dtype, device=kii.device) + (
            s_e[:, :, None] * kii * s_e[:, None, :])
        ii_factors = factorize(c_e, spd=base.is_spd())
    return CondensedSystem(
        op=base, split=split, kbb=kbb, kbi=kbi, kib=kib, kii=kii, ii_factors=ii_factors,
        diag_b=diag_b, diag_i=diag_i, sc=sc,
        inner=_INNER_DEFAULT if inner is None else inner,
    )


# ---------------------------------------------------------------------------
# Differentiable condensed solve: the adjoint structure of matfree_solve
# ---------------------------------------------------------------------------

class _CondensedSolve(torch.autograd.Function):
    """The condensed solve on the operator's detached tensors; the backward
    solves the transposed condensed system ``Aᵀλ = ḡ`` and pulls ``−λ``
    back through one apply of the operator rebuilt from fresh leaves
    (``b̄ = λ``, ``θ̄ = vjp(θ ↦ A(θ)·x)(−λ)``) — the uncondensed adjoint's
    cotangents."""

    @staticmethod
    def forward(ctx, b, op, spec: SolverSpec, inner: SolverSpec, split: DofSplit,
                infos: list, *tensors):
        op = op.with_traced([t.detach() for t in tensors])
        x, info = condense(op, split, inner=inner).solve(b.detach(), spec)
        infos.append(info)
        ctx.op, ctx.spec, ctx.inner, ctx.split = op, spec, inner, split
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        op, spec = ctx.op, ctx.spec
        lam, adj_info = condense(op, ctx.split, inner=ctx.inner, transpose=True).solve(
            g.contiguous(), spec)
        events.record_solve("condensed_solve.adjoint", adj_info, method=spec.method,
                            precond="condensed", phase="adjoint")
        need = ctx.needs_input_grad[6:]
        grads = [None] * len(need)
        if any(need):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) for t, n in zip(op.traced(), need)]
                y = op.with_traced(leaves).matvec(x)
                got = iter(torch.autograd.grad(y, [t for t in leaves if t.requires_grad], -lam,
                                               allow_unused=True))
                grads = [next(got) if n else None for n in need]
        return (lam, None, None, None, None, None, *grads)


def condensed_solve(op, b, spec: SolverSpec | None = None, *,
                    split: DofSplit | None = None, space=None,
                    inner_spec: SolverSpec | None = None,
                    return_info: bool = False):
    """Solve ``A x = b`` by static condensation: eliminate the interior
    (edge) DoFs element by element and run the Krylov iteration on the
    interface Schur complement only.

    ``op`` is a (Dirichlet-condensed) :class:`~repro_torch.core.MatFreeOperator`
    of a symmetric form on a P2 space; pass the ``split`` from
    :func:`vertex_split`/:func:`dof_split` (or ``space=`` to derive it).
    The solution matches the uncondensed solve to solver tolerance, and
    gradients with respect to ``b`` and the operator's tensors are the
    uncondensed adjoint's.  ``return_info=True`` also returns the
    :class:`~repro_torch.core.SolveInfo` of the outer iteration."""
    if split is None:
        if space is None:
            raise TypeError("condensed_solve needs split= (see vertex_split) or space=")
        split = vertex_split(space)
    spec = _COND_DEFAULT if spec is None else spec
    inner = _INNER_DEFAULT if inner_spec is None else inner_spec
    base = _base_op(op)
    tensors = base.traced()
    if torch.is_grad_enabled() and (b.requires_grad or any(t.requires_grad for t in tensors)):
        infos: list[SolveInfo] = []
        x = _CondensedSolve.apply(b, base, spec, inner, split, infos, *tensors)
        info = infos[0]
    else:
        x, info = condense(base, split, inner=inner).solve(b, spec)
    if return_info:
        events.record_solve("condensed_solve", info, method=spec.method,
                            backend="matfree", precond="condensed")
        return x, info
    return x


# ---------------------------------------------------------------------------
# Element-by-element (EbE) preconditioner
# ---------------------------------------------------------------------------

def ebe_preconditioner(op, *, theta: float = 0.25):
    """Element-by-element additive-Schwarz preconditioner from local
    factorizations — no global matrix.

    ``M⁻¹ = D^{-1/2} (Σ_e Pᵉ C_e⁻¹ Pᵉᵀ) D^{-1/2}`` with the regularized,
    diagonally scaled element matrices ``C_e = θI + s K_e s`` (``s =
    D^{-1/2}`` gathered per element), SPD whenever the element tensors are
    PSD, so Cholesky-factorized for ``spd`` kernels and CG-safe.  Each apply
    is a gather, :meth:`ElementFactors.solve` and the plan's vector Reduce
    (B2).  Dirichlet DoFs pass through untouched."""
    base = _base_op(op)
    k_e = masked_element_matrices(base)
    d = cached_diagonal(op)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    dinv_sqrt = torch.where(d.abs() > 0, 1.0 / d.abs(), one).sqrt()
    plan = base.plan
    cd = plan.cell_dofs
    s_e = dinv_sqrt[cd]
    c_e = theta * torch.eye(k_e.shape[-1], dtype=k_e.dtype, device=k_e.device) + (
        s_e[:, :, None] * k_e * s_e[:, None, :])
    fac = factorize(c_e, spd=base.is_spd())
    fm = base.free_mask

    def m(x):
        with annotate("tg.precond.ebe_apply"):
            y = reduce_vector(fac.solve((x * dinv_sqrt)[cd]), plan) * dinv_sqrt
            if fm is not None:
                mask = fm.to(x.dtype)
                y = mask * y + (1.0 - mask) * x
            return y

    return m


# ---------------------------------------------------------------------------
# Chebyshev polynomial preconditioner
# ---------------------------------------------------------------------------

def chebyshev_preconditioner(op, *, degree: int = 3, power_iters: int = 10,
                             eig_ratio: float = 30.0, safety: float = 1.05):
    """Chebyshev polynomial preconditioner on the Jacobi-scaled operator.

    ``λ_max(D⁻¹A)`` comes from ``power_iters`` power iterations run here,
    once, as a 0-d device tensor; each apply runs the degree-``degree``
    Chebyshev recurrence for ``A z = r`` on the window ``[λ_max/eig_ratio,
    λ_max]``: a fixed polynomial ``z = p(D⁻¹A) D⁻¹ r``, so a linear SPD
    preconditioner, CG-safe.  Costs ``degree`` applies of ``op.matvec``
    (the plain ``CSR.matvec`` on an assembled operator) per application."""
    d = cached_diagonal(op)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    dinv = torch.where(d.abs() > 0, 1.0 / d, one)
    matvec = op.matvec

    # deterministic start vector, not orthogonal to the dominant eigenvector
    n = d.shape[0]
    v = 1.0 + 0.5 * torch.cos(torch.arange(n, dtype=d.dtype, device=d.device))
    v = v / torch.linalg.vector_norm(v)
    for _ in range(power_iters):
        w = dinv * matvec(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    w = dinv * matvec(v)
    lam_max = torch.dot(v, w) / torch.dot(v, v) * safety
    lam_min = lam_max / eig_ratio
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta

    def m(r):
        # the classical Chebyshev iteration for A z = r from z₀ = 0
        with annotate("tg.precond.chebyshev_apply"):
            rho = 1.0 / sigma
            dz = dinv * r / theta
            z = dz
            res = r - matvec(dz)
            for _ in range(degree - 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                dz = rho_new * rho * dz + (2.0 * rho_new / delta) * (dinv * res)
                rho = rho_new
                z = z + dz
                res = res - matvec(dz)
            return z

    return m


register_preconditioner("ebe", ebe_preconditioner)
register_preconditioner("chebyshev", chebyshev_preconditioner)
