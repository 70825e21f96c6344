"""Weak-form library consumed by the Batch-Map stage.

The torch port of ``repro.core.forms``.  Each form is a function ``form(ctx, **coeffs) -> K_local | F_local``
written as dense tensor contractions over a :class:`FormContext` — the
batched geometry tensors of Alg. 1 (Eq. 7 / Eq. A.12–A.14 of the paper).
Coefficients may be tensors that require grad: the contractions are
differentiable.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "FormContext",
    "eval_coefficient",
    "eval_tensor_coefficient",
    "diffusion",
    "anisotropic_diffusion",
    "advection",
    "mass",
    "elasticity",
    "load",
    "vector_load",
]


@dataclasses.dataclass(frozen=True)
class FormContext:
    """Batched geometry at quadrature points (the paper's 𝒢, 𝒥, 𝒳̂, Ŵ)."""

    w: torch.Tensor                   # (Q,) reference weights
    phi: torch.Tensor                 # (Q, k) basis values
    detj: torch.Tensor | None         # (E, Q) |det J| (surface measure for facets)
    grad: torch.Tensor | None         # (E, Q, k, d) physical basis gradients 𝒢
    xq: torch.Tensor                  # (E, Q, d) physical quadrature points
    scalar_cell_dofs: torch.Tensor | None = None  # (E, k_scalar) for nodal coeffs

    @property
    def wdet(self) -> torch.Tensor:
        """(E, Q) combined quadrature × measure weights ŵ_q |det J|."""
        return self.w[None, :] * self.detj


def _as_tensor(coef, ctx: FormContext) -> torch.Tensor:
    if isinstance(coef, torch.Tensor):
        return coef.to(device=ctx.xq.device)
    return torch.as_tensor(coef, dtype=ctx.xq.dtype, device=ctx.xq.device)


def eval_coefficient(coef, ctx: FormContext, vector_size: int | None = None):
    """Evaluate a coefficient at quadrature points → (E, Q) or (E, Q, c).

    Accepted encodings:
      * ``None``                → 1.0
      * python/0-d scalar      → constant
      * callable               → ``coef(xq)`` with ``xq: (E, Q, d)``
      * tensor ``(E,)``        → element-wise constant (SIMP densities)
      * tensor ``(E, Q)``      → per-quadrature values
      * tensor ``(N_scalar,)`` → nodal field, interpolated with the basis
      * tensor ``(c,)`` with ``vector_size == c`` → constant vector
    """
    e, q = ctx.xq.shape[:2]
    if coef is None:
        return torch.ones((e, q), dtype=ctx.xq.dtype, device=ctx.xq.device)
    if callable(coef):
        return _as_tensor(coef(ctx.xq), ctx)
    coef = _as_tensor(coef, ctx)
    if coef.dim() == 0:
        return coef.expand(e, q)
    if vector_size is not None and coef.dim() == 1 and coef.shape[0] == vector_size:
        return coef[None, None, :].expand(e, q, vector_size)
    if coef.dim() == 1 and coef.shape[0] == e:
        return coef[:, None].expand(e, q)
    if coef.dim() == 1:
        # nodal field: interpolate u_q = Σ_a φ_a(x̂_q) u_{g_e(a)}
        if ctx.scalar_cell_dofs is None:
            raise ValueError("a nodal coefficient needs the context's cell dofs")
        return torch.einsum("qa,ea->eq", ctx.phi, coef[ctx.scalar_cell_dofs])
    if tuple(coef.shape[:2]) == (e, q):
        return coef
    raise ValueError(f"un-interpretable coefficient shape {tuple(coef.shape)}")


def eval_tensor_coefficient(coef, ctx: FormContext, d: int):
    """Evaluate a (d, d) tensor coefficient at quadrature points → (E, Q, d, d).

    Accepted encodings: ``None`` → identity, ``(d, d)`` constant,
    ``(E, d, d)`` per-element, ``(E, Q, d, d)`` per-quadrature, or a
    callable of x returning ``(E, Q, d, d)``.
    """
    e, q = ctx.xq.shape[:2]
    if coef is None:
        eye = torch.eye(d, dtype=ctx.xq.dtype, device=ctx.xq.device)
        return eye.expand(e, q, d, d)
    if callable(coef):
        coef = coef(ctx.xq)
    coef = _as_tensor(coef, ctx)
    if tuple(coef.shape) == (d, d):
        return coef.expand(e, q, d, d)
    if tuple(coef.shape) == (e, d, d):
        return coef[:, None].expand(e, q, d, d)
    if tuple(coef.shape) == (e, q, d, d):
        return coef
    raise ValueError(f"un-interpretable tensor coefficient shape {tuple(coef.shape)}")


# ---------------------------------------------------------------------------
# Bilinear forms → (E, k, k)
# ---------------------------------------------------------------------------

def diffusion(ctx: FormContext, rho=None) -> torch.Tensor:
    """∫ ρ ∇φ_b · ∇φ_a  — Eq. (A.12), the paper's flagship contraction."""
    rho_q = eval_coefficient(rho, ctx)
    return torch.einsum("eq,eqai,eqbi->eab", ctx.wdet * rho_q, ctx.grad, ctx.grad)


def anisotropic_diffusion(ctx: FormContext, a=None) -> torch.Tensor:
    """∫ (A∇u)·∇v with a (d, d) tensor coefficient A; A = I reduces to
    :func:`diffusion`."""
    d = ctx.grad.shape[-1]
    a_q = eval_tensor_coefficient(a, ctx, d)
    return torch.einsum("eq,eqai,eqij,eqbj->eab", ctx.wdet, ctx.grad, a_q, ctx.grad)


def advection(ctx: FormContext, beta) -> torch.Tensor:
    """∫ (β·∇u) v — the (nonsymmetric) advection bilinear form:
    K_ab = Σ_q ŵ|detJ| φ_a (β·𝒢_b)."""
    d = ctx.grad.shape[-1]
    b_q = eval_coefficient(beta, ctx, vector_size=d)      # (E, Q, d)
    return torch.einsum("eq,qa,eqi,eqbi->eab", ctx.wdet, ctx.phi, b_q, ctx.grad)


def mass(ctx: FormContext, c=None) -> torch.Tensor:
    """∫ c φ_b φ_a (also the Robin boundary form on facet contexts)."""
    c_q = eval_coefficient(c, ctx)
    return torch.einsum("eq,qa,qb->eab", ctx.wdet * c_q, ctx.phi, ctx.phi)


def elasticity(ctx: FormContext, lam, mu, scale=None) -> torch.Tensor:
    """Isotropic linear elasticity ∫ σ(u):ε(v) with Lamé (λ, μ).

    ``ctx.grad`` is the *scalar* basis gradient (E, Q, nv, d); the local
    matrix is over interleaved vector DoFs (a·d + i), the FunctionSpace
    ordering.  ``scale`` is an optional per-element factor (the SIMP
    stiffness interpolation E(ρ))."""
    g = ctx.grad
    e, q, nv, d = g.shape
    w = ctx.wdet * eval_coefficient(scale, ctx)
    t_lam = torch.einsum("eq,eqai,eqbj->eaibj", w, g, g)
    t_mu1 = torch.einsum("eq,eqaj,eqbi->eaibj", w, g, g)
    gdotg = torch.einsum("eq,eqak,eqbk->eab", w, g, g)
    eye = torch.eye(d, dtype=g.dtype, device=g.device)
    t_mu2 = torch.einsum("eab,ij->eaibj", gdotg, eye)
    k_local = lam * t_lam + mu * (t_mu1 + t_mu2)
    return k_local.reshape(e, nv * d, nv * d)


# ---------------------------------------------------------------------------
# Linear forms → (E, k)
# ---------------------------------------------------------------------------

def load(ctx: FormContext, f=None) -> torch.Tensor:
    """∫ f φ_a — Eq. (A.11) (also the Neumann boundary load on facets)."""
    f_q = eval_coefficient(f, ctx)
    return torch.einsum("eq,qa->ea", ctx.wdet * f_q, ctx.phi)


def vector_load(ctx: FormContext, f, d: int) -> torch.Tensor:
    """∫ f · v for vector-valued v; ``f`` is a constant (d,) vector, a
    callable returning (E, Q, d), or an (E, Q, d) tensor."""
    f_q = eval_coefficient(f, ctx, vector_size=d)      # (E, Q, d)
    e, nv = ctx.wdet.shape[0], ctx.phi.shape[1]
    return torch.einsum("eq,eqi,qa->eai", ctx.wdet, f_q, ctx.phi).reshape(e, nv * d)
