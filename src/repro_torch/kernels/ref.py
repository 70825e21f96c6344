"""Plain PyTorch versions of the CUDA kernels — the twins of
``repro.kernels.ref``.  The kernel wrappers use them for tensors on the
CPU, and the tests and the chip smoke test hold each kernel against them."""

from __future__ import annotations

import torch

__all__ = [
    "local_stiffness_p1_ref",
    "matfree_p1_diffusion_ref",
    "seg_reduce_ref",
    "seg_reduce_ordered_ref",
    "spmv_ell_ref",
    "galerkin_residual_ell_ref",
    "spmv_ell_stream_ref",
    "galerkin_residual_ell_stream_ref",
]


def local_stiffness_p1_ref(coords: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Batched P1 simplex stiffness: coords (E, k, d) with k = d+1,
    rho (E,) → (E, k, k), or rho (B, E) → (B, E, k, k) on the shared
    coordinates.  K_e = |e| ρ_e G Gᵀ with constant gradients."""
    e, k, d = coords.shape
    assert k == d + 1
    jac = (coords[:, 1:, :] - coords[:, :1, :]).transpose(1, 2)  # J columns = edges
    det = torch.linalg.det(jac)
    jinv = torch.linalg.inv_ex(jac).inverse  # no singularity check: no host sync
    gradhat = torch.cat(
        [-torch.ones((1, d), dtype=coords.dtype, device=coords.device),
         torch.eye(d, dtype=coords.dtype, device=coords.device)], dim=0
    )                                                              # (k, d)
    g = torch.einsum("eji,aj->eai", jinv, gradhat)                 # J^{-T} ĝ
    w = 1.0 / {1: 1.0, 2: 2.0, 3: 6.0}[d]                          # reference simplex volume
    scale = w * det.abs() * rho                                    # ([B,] E)
    return torch.einsum("...e,eai,ebi->...eab", scale, g, g)


def matfree_p1_diffusion_ref(x: torch.Tensor, cell_dofs: torch.Tensor, grad: torch.Tensor,
                             detj: torch.Tensor, w: torch.Tensor, rho=None,
                             scale=1.0) -> torch.Tensor:
    """The matrix-free P1 diffusion action with its gather: x (n,),
    cell_dofs (E, k), grad (E, Q, k, d) with k = d + 1, detj (E, Q), w (Q,)
    → y (E, k) with

        y_e = c_e · G_e (G_eᵀ x_e),   c_e = s · Σ_q w_q |detJ_eq| ρ_eq,

    G_e = grad[e, 0] (affine geometry: every quadrature point holds the
    same gradients) and x_e = x[cell_dofs[e]].  ``rho`` is ``None`` (1), a
    number, or a tensor that broadcasts to (E, Q); ``scale`` a number or
    a one-element tensor; s is their product."""
    g = grad[:, 0]
    wd = w * detj
    c = (wd * rho if isinstance(rho, torch.Tensor) else wd).sum(-1)
    factor = 1.0
    for f in (rho, scale):
        if f is not None and not isinstance(f, torch.Tensor):
            factor *= f
    c = c * factor
    if isinstance(scale, torch.Tensor):
        c = c * scale.reshape(())
    t = torch.einsum("eai,ea->ei", g, x[cell_dofs])
    return c[:, None] * torch.einsum("eai,ei->ea", g, t)


def seg_reduce_ref(src: torch.Tensor, rows: torch.Tensor, n_rows: int,
                   batch: bool = False) -> torch.Tensor:
    """Sparse-Reduce: ``out[rows[i]] += src.flat[i]`` (``rows`` is the
    routing's unsorted segment id of each local slot); with ``batch``,
    ``src (B, ...)`` reduces instance by instance onto ``(B, n_rows)``."""
    v = src.reshape(src.shape[0], -1) if batch else src.reshape(-1)
    out = torch.zeros((*v.shape[:-1], n_rows), dtype=v.dtype, device=v.device)
    return out.index_add_(-1, rows, v)


def seg_reduce_ordered_ref(src: torch.Tensor, slots: torch.Tensor, ptr: torch.Tensor,
                           batch: bool = False) -> torch.Tensor:
    """Sparse-Reduce on a segment table in the kernel's order: row ``n`` is
    ``0 + src[slots[ptr[n]]] + src[slots[ptr[n] + 1]] + ...``, one add at a
    time from the left, so a kernel that sums each row in slot order gives
    these values bit for bit; with ``batch``, ``src (B, ...)`` reduces
    instance by instance onto ``(B, rows)``."""
    v = src.reshape(src.shape[0], -1) if batch else src.reshape(-1)
    slots, ptr = slots.long(), ptr.long()
    start, count = ptr[:-1], ptr[1:] - ptr[:-1]
    out = torch.zeros((*v.shape[:-1], start.shape[0]), dtype=v.dtype, device=v.device)
    for k in range(int(count.max()) if count.numel() else 0):
        live = torch.nonzero(count > k).squeeze(1)
        out[..., live] += v[..., slots[start[live] + k]]
    return out


def spmv_ell_ref(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV: vals/cols (N, L), x (N,) → (N,)."""
    return (vals * x[cols.long()]).sum(dim=1)


def galerkin_residual_ell_ref(vals, cols, u, f) -> torch.Tensor:
    """Fused residual r = K u − f on the ELL operator."""
    return spmv_ell_ref(vals, cols, u) - f


def spmv_ell_stream_ref(vals, cols_local, starts, x, block_n: int, x_len: int) -> torch.Tensor:
    """Streaming-plan SpMV, walking the plan: row r of block b = r // block_n
    gathers ``x_pad[starts[b] + cols_local[r]]``, with x zero-padded to
    ``x_len`` (so a wrong start or rebase shows in y)."""
    n = vals.shape[0]
    x_pad = torch.cat([x, x.new_zeros(x_len - n)])
    row_start = starts.long().repeat_interleave(block_n)[:n, None]
    return (vals * x_pad[row_start + cols_local[:n].long()]).sum(dim=1)


def galerkin_residual_ell_stream_ref(vals, cols_local, starts, u, f, block_n: int,
                                     x_len: int) -> torch.Tensor:
    """Fused residual r = K u − f on the streaming plan."""
    return spmv_ell_stream_ref(vals, cols_local, starts, u, block_n, x_len) - f
