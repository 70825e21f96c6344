"""Plain PyTorch versions of the CUDA kernels — the twins of
``repro.kernels.ref``.  The kernel wrappers use them for tensors on the
CPU, and the tests and the chip smoke test hold each kernel against them."""

from __future__ import annotations

import torch

__all__ = [
    "local_stiffness_p1_ref",
    "seg_reduce_ref",
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


def seg_reduce_ref(src: torch.Tensor, rows: torch.Tensor, n_rows: int,
                   batch: bool = False) -> torch.Tensor:
    """Sparse-Reduce: ``out[rows[i]] += src.flat[i]`` (``rows`` is the
    routing's unsorted segment id of each local slot); with ``batch``,
    ``src (B, ...)`` reduces instance by instance onto ``(B, n_rows)``."""
    v = src.reshape(src.shape[0], -1) if batch else src.reshape(-1)
    out = torch.zeros((*v.shape[:-1], n_rows), dtype=v.dtype, device=v.device)
    return out.index_add_(-1, rows, v)


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
