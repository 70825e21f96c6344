"""Optimizers for PILS training: Adam and a compact L-BFGS.

The torch port of ``repro.pils.training``: plain functions on parameter
trees (nested dicts/lists/tuples of tensors, or one tensor), with the
reference's own update formulas, not ``torch.optim``.  Matches the
paper's schedule "N iterations of ADAM, followed by M iterations of
L-BFGS" (Table 1).  :func:`fit_family` trains a whole *family* of problem
instances against a :class:`~repro_torch.pils.losses.BatchedGalerkinResidualLoss`
— per-sample matrices from one batched assembly, one joint update
(Eq. B.22).  Rates in it/s synchronise the device before each clock read.
"""

from __future__ import annotations

import time

import torch

__all__ = ["adam_init", "adam_update", "train_adam", "fit_family", "lbfgs_minimize"]


# -- parameter trees ----------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _tree_map(fn, tree, *rest):
    cols = zip(_leaves(tree), *(_leaves(r) for r in rest))
    return _unflatten(tree, [fn(*c) for c in cols])


def _sync(tree) -> None:
    """Wait for the device work on the tree's leaves (before a clock read)."""
    devs = {x.device for x in _leaves(tree) if isinstance(x, torch.Tensor)}
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _value_and_grad(loss_fn):
    """``params ↦ (loss, grads)``: the loss on detached leaves that require
    grad, and ``torch.autograd.grad`` of it (zeros for unused leaves)."""

    def vg(params):
        leaves = [x.detach().requires_grad_(True) for x in _leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_unflatten(params, leaves))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        return loss.detach(), _unflatten(params, grads)

    return vg


# -- Adam ---------------------------------------------------------------------

def adam_init(params):
    first = _leaves(params)[0]
    return {"m": _tree_map(torch.zeros_like, params),
            "v": _tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.float64, device=first.device)}


def adam_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    with torch.no_grad():
        t = state["t"] + 1.0
        m = _tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = _tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        mhat_scale = 1.0 / (1 - b1**t)
        vhat_scale = 1.0 / (1 - b2**t)
        new_params = _tree_map(
            lambda p, m_, v_: p - lr * (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale) + eps),
            params, m, v,
        )
    return new_params, {"m": m, "v": v, "t": t}


def train_adam(loss_fn, params, steps: int, lr=1e-3, log_every=0, decay=None):
    """Generic Adam loop; returns (params, history, it/s)."""
    state = adam_init(params)
    val_grad = _value_and_grad(loss_fn)
    hist = []
    _sync(params)
    t0 = time.perf_counter()
    for i in range(steps):
        cur_lr = lr if decay is None else decay(i, lr)
        loss, grads = val_grad(params)
        params, state = adam_update(params, grads, state, cur_lr)
        if log_every and i % log_every == 0:
            hist.append(float(loss))
    _sync(params)
    its = steps / (time.perf_counter() - t0)
    return params, hist, its


def fit_family(asm, bc, rho_batch, f=1.0, f_batch=None, steps: int = 500,
               lr: float = 1e-2, log_every: int = 0, u0_batch=None):
    """Train B per-instance coefficient vectors U_b against the batched
    Galerkin residual of a coefficient family (Eq. B.22's amortization
    pattern, directly on the DoF coefficients).

    The B system matrices K(ρ_b) are assembled in **one** batched call
    (shared static pattern: one batched B1 and one batched B2 launch for P1
    diffusion on a CUDA plan), and the ``(B, num_dofs)`` prediction batch
    is a single tensor — so the whole family trains in one Adam update per
    step.  Returns ``(u_batch, history, iterations/s, loss_object)``.
    """
    from .losses import BatchedGalerkinResidualLoss

    loss = BatchedGalerkinResidualLoss(asm, bc, rho_batch, f=f, f_batch=f_batch)
    if u0_batch is None:
        u0_batch = torch.zeros((loss.batch, asm.space.num_dofs), dtype=torch.float64,
                               device=asm.device)
    u_batch, hist, its = train_adam(loss, u0_batch, steps, lr=lr, log_every=log_every)
    return u_batch, hist, its, loss


# ---------------------------------------------------------------------------
# L-BFGS (two-loop recursion + backtracking Armijo line search)
# ---------------------------------------------------------------------------

def _tree_dot(a, b):
    return sum(torch.dot(x.reshape(-1), y.reshape(-1)) for x, y in zip(_leaves(a), _leaves(b)))


def _tree_axpy(alpha, x, y):
    return _tree_map(lambda a, b: alpha * a + b, x, y)


def lbfgs_minimize(loss_fn, params, steps: int = 200, history: int = 10,
                   c1: float = 1e-4, max_ls: int = 20):
    """Compact L-BFGS; Python-level loop over autograd value-and-grad.

    Good enough to reproduce the paper's "+200 L-BFGS" refinement stage;
    returns (params, losses, it/s).
    """
    val_grad = _value_and_grad(loss_fn)
    s_hist, y_hist, rho_hist = [], [], []
    f0, g = val_grad(params)
    losses = [float(f0)]
    t0 = time.perf_counter()
    n_done = 0
    with torch.no_grad():
        for it in range(steps):
            # two-loop recursion
            q = _tree_map(lambda x: -x, g)
            alphas = []
            for s, y, rho in zip(reversed(s_hist), reversed(y_hist), reversed(rho_hist)):
                a = rho * _tree_dot(s, q)
                q = _tree_axpy(-a, y, q)
                alphas.append(a)
            if y_hist:
                gamma = _tree_dot(s_hist[-1], y_hist[-1]) / _tree_dot(y_hist[-1], y_hist[-1])
                q = _tree_map(lambda x: gamma * x, q)
            for (s, y, rho), a in zip(zip(s_hist, y_hist, rho_hist), reversed(alphas)):
                b = rho * _tree_dot(y, q)
                q = _tree_axpy(a - b, s, q)

            d = q
            gtd = _tree_dot(g, d)
            if gtd >= 0:  # not a descent direction → reset memory, steepest descent
                d = _tree_map(lambda x: -x, g)
                gtd = _tree_dot(g, d)
                s_hist, y_hist, rho_hist = [], [], []

            # backtracking Armijo
            step = 1.0
            f_cur = losses[-1]
            ok = False
            for _ in range(max_ls):
                trial = _tree_axpy(step, d, params)
                f_new, g_new = val_grad(trial)
                if bool(torch.isfinite(f_new)) and float(f_new) <= f_cur + c1 * step * float(gtd):
                    ok = True
                    break
                step *= 0.5
            if not ok:
                break
            s = _tree_map(lambda a, b: a - b, trial, params)
            yv = _tree_map(lambda a, b: a - b, g_new, g)
            sy = float(_tree_dot(s, yv))
            if sy > 1e-12:
                s_hist.append(s)
                y_hist.append(yv)
                rho_hist.append(1.0 / sy)
                if len(s_hist) > history:
                    s_hist.pop(0)
                    y_hist.pop(0)
                    rho_hist.pop(0)
            params, g = trial, g_new
            losses.append(float(f_new))
            n_done = it + 1
    _sync(params)
    its = max(n_done, 1) / (time.perf_counter() - t0)
    return params, losses, its
