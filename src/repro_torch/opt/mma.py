"""Compact Method of Moving Asymptotes (Svanberg 1987) — single constraint.

The torch port of ``repro.opt.mma``.  The paper optimizes with MMA
(§B.4.1).  This is the standard MMA approximation with adaptive asymptotes
and a dual bisection for the single volume constraint; adequate for
compliance minimization (monotone negative objective sensitivities).  The
bisection is a fixed count of ``torch.where`` steps on the device.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MMAState", "mma_update"]


@dataclasses.dataclass
class MMAState:
    low: torch.Tensor
    upp: torch.Tensor
    x_prev1: torch.Tensor | None = None
    x_prev2: torch.Tensor | None = None


def mma_update(x, dfdx, g_constraint, dgdx, state: MMAState,
               move=0.1, x_min=1e-3, x_max=1.0,
               asy_init=0.5, asy_incr=1.2, asy_decr=0.7):
    """One MMA iteration for min f(x) s.t. g(x) ≤ 0, x∈[x_min, x_max].

    dfdx: objective sensitivity (≤0 for compliance); dgdx: constraint
    sensitivity (constant 1/n for mean-volume); ``g_constraint`` a float or
    a 0-d tensor.  Returns (x_new, state).
    """
    rng = x_max - x_min

    # asymptote update
    if state.x_prev1 is None or state.x_prev2 is None:
        low = x - asy_init * rng
        upp = x + asy_init * rng
    else:
        osc = (x - state.x_prev1) * (state.x_prev1 - state.x_prev2)
        factor = torch.where(osc > 0, asy_incr,
                             torch.where(osc < 0, asy_decr, torch.ones_like(osc)))
        low = x - factor * (state.x_prev1 - state.low)
        upp = x + factor * (state.upp - state.x_prev1)
        low = torch.clamp(low, x - 10 * rng, x - 0.01 * rng)
        upp = torch.clamp(upp, x + 0.01 * rng, x + 10 * rng)

    alpha = torch.clamp(torch.maximum(low + 0.1 * (x - low), x - move * rng), min=x_min)
    beta = torch.clamp(torch.minimum(upp - 0.1 * (upp - x), x + move * rng), max=x_max)

    # MMA approximation coefficients: f ≈ Σ p/(upp−x) + q/(x−low)
    df_pos = torch.clamp(dfdx, min=0.0)
    df_neg = torch.clamp(-dfdx, min=0.0)
    p0 = (upp - x) ** 2 * (1.001 * df_pos + 0.001 * df_neg + 1e-5 / rng)
    q0 = (x - low) ** 2 * (0.001 * df_pos + 1.001 * df_neg + 1e-5 / rng)
    dg_pos = torch.clamp(dgdx, min=0.0)
    dg_neg = torch.clamp(-dgdx, min=0.0)
    p1 = (upp - x) ** 2 * dg_pos
    q1 = (x - low) ** 2 * dg_neg
    # constant so the approximate constraint matches g at x
    r1 = g_constraint - torch.sum(p1 / (upp - x) + q1 / (x - low))

    def x_of_lambda(lam):
        p = p0 + lam * p1
        q = q0 + lam * q1
        # stationary point of p/(upp−x)+q/(x−low): x* = (low√p + upp√q)/(√p+√q)
        sp, sq = torch.sqrt(p), torch.sqrt(q)
        xs = (low * sp + upp * sq) / (sp + sq + 1e-30)
        return torch.clamp(xs, alpha, beta)

    def g_of_lambda(lam):
        xs = x_of_lambda(lam)
        return r1 + torch.sum(p1 / (upp - xs) + q1 / (xs - low))

    # dual bisection on λ ≥ 0
    l1 = torch.zeros((), dtype=x.dtype, device=x.device)
    l2 = torch.full((), 1e6, dtype=x.dtype, device=x.device)
    for _ in range(80):
        lmid = 0.5 * (l1 + l2)
        viol = g_of_lambda(lmid) > 0
        l1, l2 = torch.where(viol, lmid, l1), torch.where(viol, l2, lmid)
    x_new = x_of_lambda(0.5 * (l1 + l2))

    new_state = MMAState(low=low, upp=upp, x_prev1=x, x_prev2=state.x_prev1)
    return x_new, new_state
