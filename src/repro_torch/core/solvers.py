"""Iterative sparse solvers + the differentiable solve (paper Eq. 11).

The torch port of ``repro.core.solvers``:

* :func:`cg`, :func:`bicgstab` — preconditioned Krylov solvers with the
  update order and stopping rule of the JAX package, as Python loops.  The
  stopping test reads the residual norm on the host, one synchronisation
  per iteration.  Both return ``(x, SolveInfo)``.  While telemetry is on
  and a profiler records, each operator application, preconditioner
  application and host read is a named profiler range
  (``tg.solve.matvec``, ``tg.solve.precond``, ``tg.sync``); that is
  checked once a solve, so otherwise the loop calls the bare callables.
* :func:`host_read` — a device scalar read on the host, the solve path's
  synchronisation point: a ``tg.sync`` range while a trace is taken.
* :class:`SolverSpec` — the solver knobs ``(method, tol, atol, maxiter,
  precond)`` as one frozen value; :func:`resolve_solver_spec` folds the
  legacy per-kwarg form into one (with a ``DeprecationWarning``).
* the preconditioner registry (:func:`register_preconditioner`) with
  ``identity``/``none`` and ``jacobi``; ``ebe`` and ``chebyshev`` register
  from :mod:`repro_torch.core.elemalg`, which :func:`make_preconditioner`
  imports at their first lookup.
* :func:`sparse_solve` — a ``torch.autograd.Function``: the backward pass
  solves the adjoint system ``Kᵀλ = ḡ`` with the same solver and returns
  the **sparse** cotangent ``∂/∂vals = −λ[rows]·x[cols]`` and ``∂/∂b = λ``.
* :func:`sparse_solve_batched` — :func:`sparse_solve` over a
  ``BatchedCSR`` family, one instance after another (each instance's
  iterations are its own, as in the reference's vmapped solve).
* :func:`matfree_solve` — the same adjoint solve for a matrix-free
  operator (CG + Jacobi by default): the backward pass solves ``Aᵀλ = ḡ``
  and takes the operator's cotangents as the vjp of its apply,
  ``∂/∂θ = −λᵀ (∂A/∂θ) x``; :func:`matfree_solve_batched` runs it over a
  ``MatFreeFamily``, instance by instance.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import torch

from ..telemetry import annotate, events, span
from ..telemetry.trace import recording
from .sparse import CSR, BatchedCSR, cached_diagonal

__all__ = [
    "cg",
    "bicgstab",
    "SolverSpec",
    "resolve_solver_spec",
    "register_preconditioner",
    "make_preconditioner",
    "jacobi_preconditioner",
    "sparse_solve",
    "sparse_solve_batched",
    "matfree_solve",
    "matfree_solve_batched",
    "SolveInfo",
    "host_read",
]


class SolveInfo(NamedTuple):
    """Per-solve diagnostics: iteration count, final residual norm, and the
    exit condition (``converged = ‖r‖ ≤ max(tol·‖b‖, atol)``)."""

    iters: int
    residual: float
    converged: bool


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Solver configuration ``(method, tol, atol, maxiter, precond)``.
    ``precond`` names a registered preconditioner or is a
    ``factory(op) -> m`` callable."""

    method: str = "bicgstab"
    tol: float = 1e-10
    atol: float = 1e-10
    maxiter: int = 10000
    precond: str | Callable = "jacobi"

    def replace(self, **kw) -> "SolverSpec":
        return dataclasses.replace(self, **kw)

    @property
    def precond_name(self) -> str:
        return self.precond if isinstance(self.precond, str) else getattr(
            self.precond, "__name__", "custom")


_LEGACY_POS = ("tol", "atol", "maxiter", "precond")


def resolve_solver_spec(spec, legacy_pos=(), *, method=None, tol=None,
                        atol=None, maxiter=None, precond=None,
                        default: SolverSpec | None = None,
                        where: str = "solve") -> SolverSpec:
    """Fold a ``spec=`` argument and/or legacy per-kwarg arguments into one
    :class:`SolverSpec`; any legacy use emits a ``DeprecationWarning``
    naming the entry point."""
    base_default = SolverSpec() if default is None else default
    if isinstance(spec, str):
        if method is not None:
            raise TypeError(f"{where}: got both a positional method string "
                            f"({spec!r}) and method={method!r}")
        method, spec = spec, None
    if spec is not None and not isinstance(spec, SolverSpec):
        raise TypeError(
            f"{where}: spec must be a SolverSpec (got {type(spec).__name__});"
            " build one with repro_torch.core.SolverSpec(method=..., tol=...)"
        )
    if len(legacy_pos) > len(_LEGACY_POS):
        raise TypeError(f"{where}: too many positional arguments")
    legacy = dict(zip(_LEGACY_POS, legacy_pos))
    for name, val in (("method", method), ("tol", tol), ("atol", atol),
                      ("maxiter", maxiter), ("precond", precond)):
        if val is not None:
            if name in legacy:
                raise TypeError(f"{where}: {name} given positionally and as a keyword")
            legacy[name] = val
    if not legacy:
        return spec if spec is not None else base_default
    warnings.warn(
        f"{where}: passing method/tol/atol/maxiter/precond individually is "
        f"deprecated — pass spec=SolverSpec({', '.join(f'{k}={v!r}' for k, v in legacy.items())})",
        DeprecationWarning, stacklevel=3,
    )
    base = spec if spec is not None else base_default
    return dataclasses.replace(base, **legacy)


# the paper's BiCGSTAB + Jacobi for assembled systems; CG + Jacobi for
# matrix-free operators (the SPD Galerkin default)
_SPARSE_DEFAULT = SolverSpec(method="bicgstab")
_MATFREE_DEFAULT = SolverSpec(method="cg")


# ---------------------------------------------------------------------------
# Preconditioner registry
# ---------------------------------------------------------------------------

def jacobi_preconditioner(a) -> Callable:
    """Diagonal (Jacobi) preconditioner from anything with ``.diagonal()``
    (memoized on the operator by :func:`cached_diagonal`)."""
    d = cached_diagonal(a)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    inv = torch.where(d.abs() > 0, 1.0 / d, one)
    return lambda x: inv * x


def _identity(x):
    return x


_PRECONDITIONERS: dict[str, Callable] = {}


def register_preconditioner(name: str, factory: Callable, *, overwrite: bool = False):
    """Register ``factory(op) -> m`` under ``name`` so any
    :class:`SolverSpec` can select it."""
    if name in _PRECONDITIONERS and not overwrite:
        raise ValueError(f"preconditioner {name!r} already registered; pass overwrite=True")
    _PRECONDITIONERS[name] = factory


register_preconditioner("identity", lambda op: _identity)
register_preconditioner("none", lambda op: _identity)
register_preconditioner("jacobi", jacobi_preconditioner)


def make_preconditioner(op, precond="jacobi") -> Callable:
    """Resolve a preconditioner name (or ``factory`` callable, or ``None``
    for identity) against ``op``.  Unknown names raise a ``KeyError``
    listing what is registered."""
    if precond is None:
        return _identity
    if callable(precond):
        return precond(op)
    factory = _PRECONDITIONERS.get(precond)
    if factory is None and precond in ("ebe", "chebyshev"):
        from . import elemalg  # noqa: F401  (registers ebe/chebyshev)
        factory = _PRECONDITIONERS.get(precond)
    if factory is None:
        raise KeyError(
            f"unknown preconditioner {precond!r}; registered: "
            f"{sorted(_PRECONDITIONERS)} — add one with "
            "repro_torch.core.register_preconditioner(name, factory)"
        )
    return factory(op)


def _as_matvec(a) -> Callable:
    return a if callable(a) else a.matvec


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x)


def host_read(x: torch.Tensor) -> float:
    """``float(x)`` of a device scalar: the host waits for the device here.
    A ``tg.sync`` range while telemetry is on and a profiler records."""
    with annotate("tg.sync", profiler_only=True):
        return float(x)


def _in_ranges(matvec, m):
    """The solve's operator, preconditioner and host read: wrapped in their
    ranges while telemetry is on and a profiler records, else the bare
    callables (and ``float``), so that an iteration pays nothing for the
    ranges while no trace is taken."""
    if not recording():
        return matvec, m, float
    return (annotate("tg.solve.matvec", profiler_only=True)(matvec),
            annotate("tg.solve.precond", profiler_only=True)(m), host_read)


# ---------------------------------------------------------------------------
# Conjugate gradients (SPD systems)
# ---------------------------------------------------------------------------

def cg(matvec, b, x0=None, *, tol=1e-10, atol=1e-10, maxiter=10000, m=_identity):
    matvec, m, read = _in_ranges(_as_matvec(matvec), m)
    x = torch.zeros_like(b) if x0 is None else x0
    target = max(tol * read(_norm(b)), atol)
    with annotate("tg.solve.cg"):
        r = b - matvec(x)
        z = m(r)
        p = z
        rz = torch.dot(r, z)
        it = 0
        while read(_norm(r)) > target and it < maxiter:
            ap = matvec(p)
            alpha = rz / torch.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = m(r)
            rz_new = torch.dot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            it += 1
    rnorm = read(_norm(r))
    return x, SolveInfo(it, rnorm, rnorm <= target)


# ---------------------------------------------------------------------------
# BiCGSTAB (general systems; the paper's default — van der Vorst 1992)
# ---------------------------------------------------------------------------

def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, torch.full_like(d, 1e-30), d)


def bicgstab(matvec, b, x0=None, *, tol=1e-10, atol=1e-10, maxiter=10000, m=_identity):
    matvec, m, read = _in_ranges(_as_matvec(matvec), m)
    x = torch.zeros_like(b) if x0 is None else x0
    target = max(tol * read(_norm(b)), atol)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    with annotate("tg.solve.bicgstab"):
        r = b - matvec(x)
        rhat = r
        rho, alpha, omega = one, one, one
        v = torch.zeros_like(b)
        p = torch.zeros_like(b)
        it = 0
        while read(_norm(r)) > target and it < maxiter:
            rho_new = torch.dot(rhat, r)
            beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
            p = r + beta * (p - omega * v)
            phat = m(p)
            v = matvec(phat)
            alpha = rho_new / _safe(torch.dot(rhat, v))
            s_vec = r - alpha * v
            shat = m(s_vec)
            t = matvec(shat)
            omega = torch.dot(t, s_vec) / _safe(torch.dot(t, t))
            x = x + alpha * phat + omega * shat
            r = s_vec - omega * t
            rho = rho_new
            it += 1
    rnorm = read(_norm(r))
    return x, SolveInfo(it, rnorm, rnorm <= target)


_METHODS = {"cg": cg, "bicgstab": bicgstab}


def _method(name: str) -> Callable:
    try:
        return _METHODS[name]
    except KeyError:
        raise KeyError(f"unknown solver method {name!r}; use one of {sorted(_METHODS)}") from None


# ---------------------------------------------------------------------------
# Differentiable sparse solve
# ---------------------------------------------------------------------------

def _solve_impl(a, b, spec: SolverSpec, transpose=False):
    """The Krylov solve of ``a`` (anything with ``matvec``, ``rmatvec`` and
    ``diagonal``), or of ``aᵀ``."""
    matvec = a.rmatvec if transpose else a.matvec
    m = make_preconditioner(a, spec.precond)
    return _method(spec.method)(matvec, b, tol=spec.tol, atol=spec.atol,
                               maxiter=spec.maxiter, m=m)


class _SparseSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, b, a: CSR, spec: SolverSpec, infos: list):
        a = a.with_vals(vals.detach())
        x, info = _solve_impl(a, b.detach(), spec)
        infos.append(info)
        ctx.a, ctx.spec = a, spec
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a, spec = ctx.a, ctx.spec
        # adjoint: Kᵀ λ = ḡ   (Eq. 11)
        lam, adj_info = _solve_impl(a, g.contiguous(), spec, transpose=True)
        events.record_solve("sparse_solve.adjoint", adj_info, method=spec.method,
                            precond=spec.precond_name, phase="adjoint")
        # ∂L/∂vals = −λ_r · x_c at each stored (r, c) — never densified
        dvals = -lam[a._dev("row_of_nnz")] * x[a._dev("indices")]
        return dvals, lam, None, None, None


def sparse_solve(a: CSR, b, spec: SolverSpec | None = None, *legacy,
                 method=None, tol=None, atol=None, maxiter=None, precond=None,
                 return_info=False):
    """x = A⁻¹ b, differentiable with respect to ``a.vals`` and ``b`` via
    the adjoint solve.  Solver knobs come in as one :class:`SolverSpec`
    (default BiCGSTAB + Jacobi at 1e-10).  ``return_info=True`` also
    returns the :class:`SolveInfo`."""
    spec = resolve_solver_spec(spec, legacy, method=method, tol=tol,
                               atol=atol, maxiter=maxiter, precond=precond,
                               default=_SPARSE_DEFAULT, where="sparse_solve")
    with span("sparse_solve", method=spec.method, backend="csr"):
        x, info = _solve_one(a, b, spec)
    if return_info:
        events.record_solve("sparse_solve", info, method=spec.method,
                            backend="csr", precond=spec.precond_name)
        return x, info
    return x


def _solve_one(a: CSR, b, spec: SolverSpec):
    infos: list[SolveInfo] = []
    x = _SparseSolve.apply(a.vals, b, a, spec, infos)
    return x, infos[0]


def _solve_each(solve_one, family, b, spec: SolverSpec, where: str, backend: str,
                return_info: bool):
    """``solve_one(family[i], b_i, spec)`` for each instance in turn, each
    with its own iteration count (the reference vmaps the same solve);
    ``b`` is ``(B, n)`` or ``(n,)`` shared.  Returns ``(B, n)``, plus a
    :class:`SolveInfo` of ``(B,)`` host tensors with ``return_info``."""
    xs, infos = [], []
    with span(where, method=spec.method, backend=backend):
        for i in range(family.batch):
            x, info = solve_one(family[i], b[i] if b.dim() == 2 else b, spec)
            xs.append(x)
            infos.append(info)
    info = SolveInfo(torch.tensor([i.iters for i in infos]),
                     torch.tensor([i.residual for i in infos], dtype=torch.float64),
                     torch.tensor([i.converged for i in infos]))
    x = torch.stack(xs) if xs else torch.zeros((0, family.shape[0]), dtype=b.dtype,
                                               device=b.device)
    if return_info:
        events.record_solve(where, info, method=spec.method, backend=backend,
                            precond=spec.precond_name)
        return x, info
    return x


def sparse_solve_batched(a: BatchedCSR, b, spec: SolverSpec | None = None,
                         return_info=False):
    """``X_b = A_b⁻¹ b_b`` over a :class:`~repro_torch.core.sparse.BatchedCSR`
    family: the differentiable :func:`sparse_solve` on each instance in
    turn, each with its own iteration count (the reference vmaps the same
    solve).  ``b`` is ``(B, n)`` per instance or ``(n,)`` shared; returns
    ``(B, n)`` (plus a :class:`SolveInfo` of ``(B,)`` host tensors with
    ``return_info=True``).  Gradients flow to ``a.vals`` and ``b``."""
    spec = resolve_solver_spec(spec, default=_SPARSE_DEFAULT,
                               where="sparse_solve_batched")
    return _solve_each(_solve_one, a, b, spec, "sparse_solve_batched", "csr", return_info)


# ---------------------------------------------------------------------------
# Differentiable matrix-free solve
# ---------------------------------------------------------------------------

class _MatFreeSolve(torch.autograd.Function):
    """The Krylov solve on the operator's detached tensors; the backward
    solves ``Aᵀλ = ḡ`` and pulls ``−λ`` back through one apply of an
    operator rebuilt from fresh leaves (so ``b̄ = λ`` and ``θ̄ = vjp(θ ↦
    A(θ)·x)(−λ)``)."""

    @staticmethod
    def forward(ctx, b, op, spec: SolverSpec, infos: list, *tensors):
        op = op.with_traced([t.detach() for t in tensors])
        x, info = _solve_impl(op, b.detach(), spec)
        infos.append(info)
        ctx.op, ctx.spec = op, spec
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        op, spec = ctx.op, ctx.spec
        lam, adj_info = _solve_impl(op, g.contiguous(), spec, transpose=True)
        events.record_solve("matfree_solve.adjoint", adj_info, method=spec.method,
                            precond=spec.precond_name, phase="adjoint")
        need = ctx.needs_input_grad[4:]
        grads = [None] * len(need)
        if any(need):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) for t, n in zip(op.traced(), need)]
                y = op.with_traced(leaves).matvec(x)
                got = iter(torch.autograd.grad(y, [t for t in leaves if t.requires_grad], -lam,
                                               allow_unused=True))
                grads = [next(got) if n else None for n in need]
        return (lam, None, None, None, *grads)


def _matfree_one(op, b, spec: SolverSpec):
    if isinstance(op, CSR):
        return _solve_one(op, b, spec)  # the assembled adjoint: sparse cotangent
    tensors = op.traced()
    if torch.is_grad_enabled() and (b.requires_grad or any(t.requires_grad for t in tensors)):
        infos: list[SolveInfo] = []
        x = _MatFreeSolve.apply(b, op, spec, infos, *tensors)
        return x, infos[0]
    return _solve_impl(op, b, spec)


def matfree_solve(op, b, spec: SolverSpec | None = None, *legacy, method=None, tol=None,
                  atol=None, maxiter=None, precond=None, return_info=False):
    """``x = A⁻¹ b`` for a matrix-free operator (anything with ``matvec``,
    ``rmatvec``, ``diagonal`` and ``traced``/``with_traced``),
    differentiable with respect to the operator's tensors (coefficients,
    scale factors, coordinates, context, element matrices) and ``b``.
    The backward pass solves ``Aᵀλ = ḡ`` with the same Krylov method and
    takes the operator's cotangents as one apply's vjp at ``−λ`` — no
    assembled matrix.  A :class:`CSR` goes through :func:`sparse_solve`'s
    adjoint.  Solver knobs come in as one :class:`SolverSpec` (default CG
    + Jacobi); ``return_info=True`` also returns the :class:`SolveInfo`."""
    spec = resolve_solver_spec(spec, legacy, method=method, tol=tol, atol=atol,
                               maxiter=maxiter, precond=precond,
                               default=_MATFREE_DEFAULT, where="matfree_solve")
    with span("matfree_solve", method=spec.method, backend="matfree"):
        x, info = _matfree_one(op, b, spec)
    if return_info:
        events.record_solve("matfree_solve", info, method=spec.method,
                            backend="matfree", precond=spec.precond_name)
        return x, info
    return x


def matfree_solve_batched(family, b, spec: SolverSpec | None = None, return_info=False):
    """``X_b = A_b⁻¹ b_b`` over a :class:`~repro_torch.core.MatFreeFamily`:
    the differentiable :func:`matfree_solve` on each instance in turn, each
    with its own iteration count (the reference vmaps the same solve).
    ``b`` is ``(B, n)`` or ``(n,)`` shared; returns ``(B, n)`` (plus a
    :class:`SolveInfo` of ``(B,)`` host tensors with ``return_info=True``).
    Gradients flow to the family's batched leaves and ``b``."""
    spec = resolve_solver_spec(spec, default=_MATFREE_DEFAULT,
                               where="matfree_solve_batched")
    return _solve_each(_matfree_one, family, b, spec, "matfree_solve_batched", "matfree",
                       return_info)
