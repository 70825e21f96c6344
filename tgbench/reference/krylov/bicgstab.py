"""Textbook Jacobi-preconditioned BiCGSTAB (van der Vorst 1992) in plain
PyTorch, in whatever dtype its operands have; it serves the control (the
reference put in the program's place at a lower precision).  Stops when
the residual norm is at most ``max(tol·‖b‖, atol)`` or after ``maxiter``
iterations."""

import torch


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v))


def solve(apply, b, inv_diag, x0=None, *, tol, atol, maxiter):
    """``(x, iterations, converged)``."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    target = max(tol * _norm(b), atol)
    r = b - apply(x)
    r_hat = r.clone()
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    it = 0
    while _norm(r) > target and it < maxiter:
        rho_next = torch.dot(r_hat, r)
        p = r + (rho_next / rho) * (alpha / omega) * (p - omega * v)
        p_hat = inv_diag * p
        v = apply(p_hat)
        alpha = rho_next / torch.dot(r_hat, v)
        s = r - alpha * v
        s_hat = inv_diag * s
        t = apply(s_hat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x += alpha * p_hat + omega * s_hat
        r = s - omega * t
        rho = rho_next
        it += 1
    return x, it, _norm(r) <= target
