"""The matrix-free P1 diffusion action with its gather: the wrapper of the
CUDA kernel ``csrc/matfree_p1.cu``.

It replaces no Pallas kernel: the JAX package applies the action with
``jnp.einsum`` (``repro.core.operator``), and so does the port's einsum
path, which stays the path of every apply that records an autograd graph.
This kernel has no backward: :class:`~repro_torch.core.MatFreeOperator`
calls it only where no graph is needed.
"""

from __future__ import annotations

import torch

from . import _cuda
from .ref import matfree_p1_diffusion_ref

__all__ = ["matfree_p1_diffusion"]

_SHAPES = ((4, 3), (3, 2))  # (k, d): tetrahedra, triangles


def matfree_p1_diffusion(x: torch.Tensor, cell_dofs: torch.Tensor, grad: torch.Tensor,
                         detj: torch.Tensor, w: torch.Tensor, rho=None,
                         scale=1.0) -> torch.Tensor:
    """x (n,), cell_dofs (E, k) int64, grad (E, Q, k, d), detj (E, Q),
    w (Q,) → y (E, k) with ``y_e = c_e · G_e (G_eᵀ x_e)``, ``G_e =
    grad[e, 0]`` and ``c_e = s · Σ_q w_q detj_eq ρ_eq``
    (:func:`~repro_torch.kernels.ref.matfree_p1_diffusion_ref`), for
    (k, d) ∈ {(4, 3), (3, 2)}.  ``rho`` is ``None``, a number or a tensor
    that broadcasts to (E, Q); ``scale`` a number or a one-element tensor.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which reads ``detj`` and ``rho`` through their strides, so a per-cell
    ρ expanded over Q is read once an element.  The entries of
    ``cell_dofs`` must index ``x``."""
    if grad.dim() != 4 or tuple(grad.shape[2:]) not in _SHAPES:
        raise ValueError(f"grad must be (E, Q, k, d) with (k, d) in {_SHAPES}, "
                         f"got {tuple(grad.shape)}")
    e, q, k, d = grad.shape
    if (tuple(cell_dofs.shape) != (e, k) or tuple(detj.shape) != (e, q)
            or tuple(w.shape) != (q,) or x.dim() != 1):
        raise ValueError(f"expected x (n,), cell_dofs ({e}, {k}), detj ({e}, {q}), w ({q},); "
                         f"got {tuple(x.shape)}, {tuple(cell_dofs.shape)}, "
                         f"{tuple(detj.shape)}, {tuple(w.shape)}")
    if isinstance(rho, torch.Tensor):
        rho = rho.broadcast_to((e, q))
    if isinstance(scale, torch.Tensor) and scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got shape {tuple(scale.shape)}")
    tensors = {"x": x, "cell_dofs": cell_dofs, "grad": grad, "detj": detj, "w": w,
               "rho": rho, "scale": scale}
    tensors = {name: t for name, t in tensors.items() if isinstance(t, torch.Tensor)}
    if all(t.device.type == "cpu" for t in tensors.values()):
        return matfree_p1_diffusion_ref(x, cell_dofs, grad, detj, w, rho, scale)
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("matfree_p1_diffusion: operands must share one CUDA device, got "
                         + ", ".join(f"{n} on {t.device}" for n, t in tensors.items()))
    dtype = grad.dtype
    floats = {n: t.dtype for n, t in tensors.items() if n != "cell_dofs"}
    if dtype not in (torch.float32, torch.float64) or set(floats.values()) != {dtype}:
        raise TypeError(f"matfree_p1_diffusion: floating operands must all be float32 or all "
                        f"float64, got {floats}")
    if cell_dofs.dtype != torch.int64:
        raise TypeError(f"matfree_p1_diffusion: cell_dofs must be int64, got {cell_dofs.dtype}")
    g = grad[:, 0]  # each element's block: k*d values in a run, a-major or i-major
    if (g.stride(1), g.stride(2)) not in ((d, 1), (1, k)):
        g = g.contiguous()
    factor = 1.0
    for f in (rho, scale):
        if f is not None and not isinstance(f, torch.Tensor):
            factor *= float(f)
    rho_t = rho if isinstance(rho, torch.Tensor) else None
    scale_t = scale.reshape(()) if isinstance(scale, torch.Tensor) else None
    r_e, r_q = (rho_t.stride(0), rho_t.stride(1)) if rho_t is not None else (0, 0)
    out = torch.empty((e, k), dtype=dtype, device=grad.device)
    if e:
        _cuda.launch("matfree_p1_diffusion", "matfree_p1",
                     _cuda.symbol("tg_matfree_p1_diffusion", dtype),
                     x.contiguous(), cell_dofs.contiguous(), g, detj, w.contiguous(), rho_t,
                     scale_t, out, e, d, q, *g.stride(), *detj.stride(), r_e, r_q, factor)
    return out
