"""Optimizers for the LM stack: AdamW + Adafactor (factored second moment),
the torch port of ``repro.optim.optimizers``.

State is described with the same P-spec system as parameters and mirrors
the parameter tree with a small dict at each leaf:
  * AdamW:     m, v  — same shape as the parameter.
  * Adafactor: for rank≥2 params the second moment is factored into row/col
    accumulators (O(n+m) memory); 1-D params keep a full v.  No momentum.

Updates run in place under ``torch.no_grad()`` — the port's analogue of the
reference's donated state buffers.  The learning rate and the step are
host floats, so an update never reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models.layers import P, flatten_with_paths, tree_leaves, tree_map

__all__ = [
    "adamw_init_specs",
    "adafactor_init_specs",
    "make_optimizer",
    "cosine_schedule",
    "Optimizer",
]


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)`` → the float32 learning rate as a host float, in the
    reference's float32 arithmetic; the cosine itself is the correctly
    rounded float32 value, which XLA's float32 ``cos`` misses by one ulp on
    about 1 % of arguments."""
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        warm = f32(base_lr) * step / f32(max(warmup, 1))
        prog = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)), f32(0), f32(1))
        cos = f32(0.5 * base_lr) * (f32(1) + f32(np.cos(np.float64(f32(np.pi) * prog))))
        return float(warm if step < warmup else cos)

    return lr


def _pow(b: float, step: float) -> float:
    """1 − bˢᵗᵉᵖ in float32, as the reference's bias corrections."""
    return float(np.float32(1) - np.float32(b) ** np.float32(step))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init_specs(param_specs):
    def one(s: P):
        return {
            "m": P(s.shape, s.axes, "zeros", dtype=torch.float32),
            "v": P(s.shape, s.axes, "zeros", dtype=torch.float32),
        }

    return tree_map(one, param_specs)


def _adamw_update(p, g, st, lr, b1, b2, eps, wd, step):
    g = g.float()
    m, v = st["m"], st["v"]
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    mh = m / _pow(b1, step)
    vh = v / _pow(b2, step)
    upd = mh / (torch.sqrt(vh) + eps) + wd * p.float()
    p.sub_((lr * upd).to(p.dtype))


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored v, no momentum
# ---------------------------------------------------------------------------

def adafactor_init_specs(param_specs):
    def one(s: P):
        if len(s.shape) >= 2:
            return {
                "vr": P(s.shape[:-1], s.axes[:-1], "zeros", dtype=torch.float32),
                "vc": P(s.shape[:-2] + s.shape[-1:], s.axes[:-2] + s.axes[-1:], "zeros",
                        dtype=torch.float32),
            }
        return {"v": P(s.shape, s.axes, "zeros", dtype=torch.float32)}

    return tree_map(one, param_specs)


def _adafactor_update(p, g, st, lr, b2, eps, wd, step):
    g = g.float()
    if "vr" in st:
        vr, vc = st["vr"], st["vc"]
        vr.mul_(b2).add_((1 - b2) * torch.mean(g * g, dim=-1))
        vc.mul_(b2).add_((1 - b2) * torch.mean(g * g, dim=-2))
        # factored precond: v ≈ vr vc / mean(vr)
        denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
        vhat = vr[..., :, None] * vc[..., None, :] / denom[..., None]
    else:
        vhat = st["v"].mul_(b2).add_((1 - b2) * g * g)
    # bias correction on the 2nd moment
    vhat = vhat / _pow(b2, step)
    upd = g / (torch.sqrt(vhat) + eps)
    # update clipping (RMS ≤ 1) — Adafactor's stabilizer
    rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
    upd = upd / torch.clamp(rms, min=1.0)
    upd = upd + wd * p.float()
    p.sub_((lr * upd).to(p.dtype))


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init_specs_fn: Callable
    update_leaf: Callable

    def init_specs(self, param_specs):
        return self.init_specs_fn(param_specs)

    def update(self, params, grads, state, lr, step, wd=0.01):
        """Tree-wide update in place; ``step`` is 1-based, ``lr`` and
        ``step`` host numbers.  ``state`` mirrors ``params`` with a small
        dict at each leaf; ``grads`` has ``params``' structure, or is the
        list of its leaves in order.  Returns ``(params, state)``, the same
        objects."""
        flat = flatten_with_paths(params)
        g_leaves = tree_leaves(grads)
        if len(flat) != len(g_leaves):
            raise ValueError(f"{len(g_leaves)} gradients for {len(flat)} parameters")
        lr, step = float(lr), float(step)
        with torch.no_grad():
            for (path, p), g in zip(flat, g_leaves):
                st = state
                for key in path:
                    st = st[key]
                self.update_leaf(p, g, st, lr, step=step, wd=wd)
        return params, state


def make_optimizer(name: str, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    if name == "adamw":
        return Optimizer(
            "adamw",
            adamw_init_specs,
            lambda p, g, st, lr, step, wd: _adamw_update(p, g, st, lr, b1, b2, eps, wd, step),
        )
    if name == "adafactor":
        return Optimizer(
            "adafactor",
            adafactor_init_specs,
            lambda p, g, st, lr, step, wd: _adafactor_update(p, g, st, lr, 0.999, 1e-30, wd, step),
        )
    raise ValueError(name)
