"""Stage-I Batch-Map for P1 simplex stiffness: the wrapper of the CUDA
kernel ``csrc/local_assembly.cu`` (the port of the Pallas kernel
``repro.kernels.local_assembly.local_stiffness_p1``).

The wrapper takes one coefficient per element, ``rho (E,)``, or a batch of
them on shared coordinates, ``rho (B, E)``: one launch assembles the B
instances (the batched family of ``assemble_batched``).

Gradients.  Where grad is enabled and ``coords`` or ``rho`` requires it,
the call goes through an :class:`torch.autograd.Function` whose forward is
the same kernel (or, on the CPU, the same plain version) and whose backward
is the vjp of the plain version :func:`local_stiffness_p1_ref` in plain
torch on the same device, as the JAX package has no backward kernel.
Otherwise the wrapper launches directly, with no autograd node.
"""

from __future__ import annotations

import torch

from . import _cuda
from .ref import local_stiffness_p1_ref

__all__ = ["local_stiffness_p1"]


def _local_stiffness_p1(coords: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    if coords.device.type == "cpu" and rho.device.type == "cpu":
        return local_stiffness_p1_ref(coords, rho)
    dtype = _cuda.check_operands("local_stiffness_p1", {"coords": coords, "rho": rho})
    e, k, d = coords.shape
    batch = rho.shape[0] if rho.dim() == 2 else 1
    out = torch.empty((*rho.shape, k, k), dtype=dtype, device=coords.device)
    if e and batch:
        _cuda.launch("local_stiffness_p1", "local_assembly",
                     _cuda.symbol("tg_local_stiffness_p1", dtype), coords, rho, out, e, d,
                     batch)
    return out


class _P1Stiffness(torch.autograd.Function):
    """B1 around the kernel, with the backward of the plain version."""

    @staticmethod
    def forward(ctx, coords, rho):
        ctx.save_for_backward(coords, rho)
        return _local_stiffness_p1(coords, rho)

    @staticmethod
    def backward(ctx, g_out):
        coords, rho = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            c = coords.detach().requires_grad_(need[0])
            r = rho.detach().requires_grad_(need[1])
            inputs = [t for t, n in ((c, need[0]), (r, need[1])) if n]
            grads = iter(torch.autograd.grad(local_stiffness_p1_ref(c, r), inputs, g_out))
        return (next(grads) if need[0] else None), (next(grads) if need[1] else None)


def local_stiffness_p1(coords: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """coords (E, k, d) array-of-structs, rho (E,) → K_local (E, k, k), or
    rho (B, E) → (B, E, k, k), with k = d + 1 and d ∈ {2, 3}.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable in ``coords`` and ``rho`` (module docstring)."""
    if coords.dim() != 3:
        raise ValueError(f"coords must be (E, k, d), got {tuple(coords.shape)}")
    e, k, d = coords.shape
    if d not in (2, 3) or k != d + 1:
        raise ValueError(f"P1 simplices need k = d + 1 with d in (2, 3), got k={k}, d={d}")
    if rho.dim() not in (1, 2) or rho.shape[-1] != e:
        raise ValueError(f"rho must be ({e},) or (B, {e}), got {tuple(rho.shape)}")
    if torch.is_grad_enabled() and (coords.requires_grad or rho.requires_grad):
        return _P1Stiffness.apply(coords, rho)
    return _local_stiffness_p1(coords, rho)
