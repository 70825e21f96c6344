"""Composable weak-form API: declarative terms over the Map-Reduce pipeline.

The torch port of ``repro.core.weakform``.  A :class:`WeakForm` is a sum
of :class:`Term` objects — each a (kernel, coefficient-spec) pair tagged
with an integration domain (volume cells by default, a
:class:`~repro_torch.core.boundary.FacetAssembler` for boundary terms) —
closed under ``+``, ``-`` and scalar scaling::

    from repro_torch.core import weakform as wf

    form = wf.diffusion(rho) + wf.advection(beta) + wf.mass(c) \
         + wf.robin(alpha, on=facets)
    K = asm.assemble(form)                    # ONE fused Map, ONE Reduce
    F = asm.assemble_rhs(wf.source(f) + wf.neumann(g, on=facets))

Volume terms share one Map and one Reduce; facet terms reduce through
their domain's facet routing and land in the volume CSR pattern through a
precomputed nnz injection.  :func:`lower` splits a form into a static
signature (term kinds, domains, and which coefficient slots are values or
static ``None``/callables) and the flat tuple of coefficient values, as
the JAX package does for its jit cache.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import forms

__all__ = [
    "Term",
    "WeakForm",
    "KERNELS",
    "lower",
    "diffusion",
    "anisotropic_diffusion",
    "advection",
    "mass",
    "elasticity",
    "robin",
    "source",
    "neumann",
    "reaction",
]

MATRIX = "matrix"
VECTOR = "vector"

TRACED = "traced"  # marker for a coefficient slot carried as a value


@dataclasses.dataclass(frozen=True)
class _Kernel:
    """arity + the local Map: ``fn(ctx, value_size, *coeffs) -> (E,k,k)|(E,k)``.

    ``symmetric`` declares ``K_e = K_eᵀ`` for every coefficient value (the
    matrix-free ``rmatvec`` then reuses the forward action); ``spd``
    declares it symmetric positive (semi-)definite."""

    arity: str
    fn: Callable
    symmetric: bool = False
    spd: bool = False


def _source_kernel(ctx, vs, f):
    return forms.load(ctx, f) if vs == 1 else forms.vector_load(ctx, f, vs)


KERNELS: dict[str, _Kernel] = {
    "diffusion": _Kernel(MATRIX, lambda ctx, vs, rho: forms.diffusion(ctx, rho),
                         symmetric=True, spd=True),
    "anisotropic_diffusion": _Kernel(
        MATRIX, lambda ctx, vs, a: forms.anisotropic_diffusion(ctx, a)
    ),
    "advection": _Kernel(MATRIX, lambda ctx, vs, beta: forms.advection(ctx, beta)),
    "mass": _Kernel(MATRIX, lambda ctx, vs, c: forms.mass(ctx, c), symmetric=True, spd=True),
    "elasticity": _Kernel(
        MATRIX, lambda ctx, vs, lam, mu, scale: forms.elasticity(ctx, lam, mu, scale=scale),
        symmetric=True, spd=True,
    ),
    "source": _Kernel(VECTOR, _source_kernel),
    "reaction": _Kernel(VECTOR, lambda ctx, vs, u, fn: forms.nonlinear_reaction(ctx, u, fn)),
}


@dataclasses.dataclass(frozen=True, eq=False)
class Term:
    """One (kernel, coefficient-spec) pair on one integration domain, times
    a scalar ``scale``: ``domain is None`` integrates over the mesh cells, a
    ``FacetAssembler`` over its boundary facets."""

    kind: str
    coeffs: tuple
    domain: object = None
    scale: object = 1.0

    @property
    def arity(self) -> str:
        return KERNELS[self.kind].arity

    def scaled(self, s) -> "Term":
        return dataclasses.replace(self, scale=s * self.scale)


@dataclasses.dataclass(frozen=True, eq=False)
class WeakForm:
    """A sum of terms, closed under ``+``, ``-`` and scalar scaling."""

    terms: tuple[Term, ...] = ()

    def __add__(self, other):
        other = _as_form(other)
        if other is NotImplemented:
            return NotImplemented
        return WeakForm(self.terms + other.terms)

    def __radd__(self, other):
        if isinstance(other, (int, float)) and other == 0:
            return self  # sum([...]) support
        return self.__add__(other)

    def __sub__(self, other):
        other = _as_form(other)
        if other is NotImplemented:
            return NotImplemented
        return self + (-1.0) * other

    def __mul__(self, s):
        if isinstance(s, (WeakForm, Term)):
            return NotImplemented  # forms scale by scalars; use + to combine
        return WeakForm(tuple(t.scaled(s) for t in self.terms))

    __rmul__ = __mul__

    def __neg__(self):
        return (-1.0) * self


def _as_form(obj) -> WeakForm:
    if isinstance(obj, WeakForm):
        return obj
    if isinstance(obj, Term):
        return WeakForm((obj,))
    return NotImplemented


def lower(form, arity: str):
    """Split a form into its static signature and its coefficient values.

    Returns ``(spec, leaves)``: ``spec`` is a tuple of ``(kind, domain,
    coeff_descriptors)`` per term — each slot (coefficients + trailing
    scale) marked :data:`TRACED` or ``("static", obj)`` for ``None`` and
    callables — and ``leaves`` the flat tuple of values in slot order.
    """
    form = _as_form(form)
    if form is NotImplemented:
        raise TypeError(f"expected a WeakForm or Term, got {type(form).__name__}")
    if not form.terms:
        raise ValueError("cannot assemble an empty WeakForm")
    spec, leaves = [], []
    for t in form.terms:
        if t.arity != arity:
            raise TypeError(
                f"term '{t.kind}' is a {t.arity} form; "
                f"{'assemble' if arity == MATRIX else 'assemble_rhs'} takes "
                f"{arity} forms only"
            )
        desc = []
        for c in (*t.coeffs, t.scale):
            if c is None or callable(c):
                desc.append(("static", c))
            else:
                desc.append(TRACED)
                leaves.append(c)
        spec.append((t.kind, t.domain, tuple(desc)))
    return tuple(spec), tuple(leaves)


# ---------------------------------------------------------------------------
# term constructors (the user-facing vocabulary)
# ---------------------------------------------------------------------------

def diffusion(rho=None) -> WeakForm:
    """∫ ρ ∇u·∇v — scalar (or ``None`` → unit) coefficient."""
    return WeakForm((Term("diffusion", (rho,)),))


def anisotropic_diffusion(a) -> WeakForm:
    """∫ (A∇u)·∇v — tensor coefficient: ``(d,d)`` constant, ``(E,d,d)``
    per-element, ``(E,Q,d,d)`` per-quadrature, or a callable of x."""
    return WeakForm((Term("anisotropic_diffusion", (a,)),))


def advection(beta) -> WeakForm:
    """∫ (β·∇u) v — nonsymmetric; β is a ``(d,)`` constant, ``(E,Q,d)``
    tensor, or a callable of x."""
    return WeakForm((Term("advection", (beta,)),))


def mass(c=None) -> WeakForm:
    """∫ c u v (reaction / L² term)."""
    return WeakForm((Term("mass", (c,)),))


def elasticity(lam, mu, scale=None) -> WeakForm:
    """∫ σ(u):ε(v) with Lamé (λ, μ); ``scale`` is the per-element SIMP
    interpolation E(ρ)."""
    return WeakForm((Term("elasticity", (lam, mu, scale)),))


def robin(alpha=None, *, on) -> WeakForm:
    """∫_Γ α u v over the facets of ``on`` (a FacetAssembler) — reduces into
    the volume CSR pattern."""
    if on is None:
        raise ValueError("robin(...) needs on=<FacetAssembler>")
    return WeakForm((Term("mass", (alpha,), domain=on),))


def source(f=None) -> WeakForm:
    """∫ f v — volume load (vector-valued on vector spaces)."""
    return WeakForm((Term("source", (f,)),))


def neumann(g=None, *, on) -> WeakForm:
    """∫_Γ g v over the facets of ``on`` — boundary load."""
    if on is None:
        raise ValueError("neumann(...) needs on=<FacetAssembler>")
    return WeakForm((Term("source", (g,), domain=on),))


def reaction(u_nodal, fn: Callable) -> WeakForm:
    """Semi-linear load ∫ fn(u) v with nodal coefficients ``u_nodal``
    (``fn`` acts pointwise on the quadrature values of u)."""
    return WeakForm((Term("reaction", (u_nodal, fn)),))
