"""Textbook Jacobi-preconditioned CG in plain PyTorch, in whatever dtype
its operands have; it serves the control (the reference put in the
program's place at a lower precision).  Stops when the residual norm is at
most ``max(tol·‖b‖, atol)`` or after ``maxiter`` iterations."""

import torch


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v))


def solve(apply, b, inv_diag, x0=None, *, tol, atol, maxiter):
    """``(x, iterations, converged)``."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    target = max(tol * _norm(b), atol)
    r = b - apply(x)
    z = inv_diag * r
    p = z.clone()
    rz = torch.dot(r, z)
    it = 0
    while _norm(r) > target and it < maxiter:
        q = apply(p)
        alpha = rz / torch.dot(p, q)
        x += alpha * p
        r -= alpha * q
        z = inv_diag * r
        rz_next = torch.dot(r, z)
        p = z + (rz_next / rz) * p
        rz = rz_next
        it += 1
    return x, it, _norm(r) <= target
