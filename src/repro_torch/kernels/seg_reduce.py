"""Stage-II Sparse-Reduce as a padded gather-sum: the wrapper of the CUDA
kernel ``csrc/seg_reduce.cu`` (the port of the Pallas kernel
``repro.kernels.seg_reduce.seg_reduce``), and the host builder of its index
table.

FEM gives a bound: each global entry receives at most ``L`` local
contributions.  The sorted segment layout of a routing is repacked into a
padded ``(rows, L)`` int32 table whose pad slots hold a sentinel ``n_src``
(one past the last local slot), which turns the Reduce into a regular,
deterministic gather-sum::

    out[n] = Σ_l  vec(K_local)[idx[n, l]]      (sentinel slots skipped)
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .ref import seg_reduce_ref

__all__ = ["ReduceTable", "build_padded_reduce", "padded_table", "seg_reduce"]


def padded_table(perm: np.ndarray, rows_sorted: np.ndarray, n_rows: int) -> np.ndarray:
    """``(n_rows, L)`` int32 table: row ``n`` lists the local slots
    ``perm[i]`` with ``rows_sorted[i] == n`` in their sorted order, padded
    with the sentinel ``len(perm)``.  ``rows_sorted`` must be non-decreasing
    (a stable sort of the routing keys)."""
    n_src = perm.shape[0]
    if n_src >= 2 ** 31:
        raise ValueError(f"{n_src} local slots overflow the int32 reduce table")
    counts = np.bincount(rows_sorted, minlength=n_rows)
    width = int(counts.max()) if counts.size else 1
    start = np.cumsum(counts) - counts
    slot = np.arange(n_src, dtype=np.int64) - start[rows_sorted]
    idx = np.full((n_rows, width), n_src, dtype=np.int32)
    idx[rows_sorted, slot] = perm
    return idx


def build_padded_reduce(routing) -> np.ndarray:
    """``(nnz, L)`` indices into vec(K_local) with pad → index E·k² (the
    sentinel) — equal to ``repro.kernels.seg_reduce.build_padded_reduce``,
    without its Python loop over every local slot."""
    return padded_table(routing.perm, routing.seg_ids, routing.nnz)


class ReduceTable:
    """One Sparse-Reduce (``n_src`` local slots onto ``n_rows`` global
    entries) for a device: the padded int32 table of the CUDA kernel
    (staged at construction on a CUDA device) and the per-slot row ids of
    the plain version and of the gradient (staged at first use)."""

    def __init__(self, perm, rows_sorted, rows_unsorted, n_rows: int, device):
        self.n_rows = int(n_rows)
        self.n_src = int(perm.shape[0])
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._rows_host = rows_unsorted
        self._rows = None
        self.idx = None
        if self.device.type == "cuda":
            self.idx = torch.from_numpy(padded_table(perm, rows_sorted, self.n_rows)).to(device)

    @classmethod
    def for_matrix(cls, routing, device) -> "ReduceTable":
        return cls(routing.perm, routing.seg_ids, routing.seg_ids_unsorted, routing.nnz, device)

    @classmethod
    def for_vector(cls, routing, device) -> "ReduceTable":
        """Rows are the global dofs (untouched dofs get no contributions)."""
        t = routing.touched
        return cls(routing.perm, t[routing.seg_ids], t[routing.seg_ids_unsorted],
                   routing.num_dofs, device)

    @property
    def rows(self) -> torch.Tensor:
        """Global row of each local slot, ``(n_src,)`` int64 on the device."""
        if self._rows is None:
            self._rows = torch.from_numpy(np.ascontiguousarray(self._rows_host)).to(self.device)
        return self._rows


def _seg_reduce(src: torch.Tensor, table: ReduceTable) -> torch.Tensor:
    if src.device.type == "cpu":
        return seg_reduce_ref(src, table.rows, table.n_rows)
    dtype = _cuda.check_operands("seg_reduce", {"local_vals": src, "idx": table.idx})
    out = torch.empty(table.n_rows, dtype=dtype, device=src.device)
    if table.n_rows:
        _cuda.launch("seg_reduce", "seg_reduce", _cuda.symbol("tg_seg_reduce", dtype),
                     src, table.idx, out, table.n_rows, table.idx.shape[1], table.n_src)
    return out


class _SegReduce(torch.autograd.Function):
    """The Reduce with its adjoint: the gradient of a local slot is the
    output gradient of its row (a gather)."""

    @staticmethod
    def forward(ctx, src, table):
        ctx.table = table
        return _seg_reduce(src, table)

    @staticmethod
    def backward(ctx, grad_out):
        return grad_out[ctx.table.rows], None


def seg_reduce(local_vals: torch.Tensor, table: ReduceTable) -> torch.Tensor:
    """local_vals (E, ka, kb), (E, k) or flat → (table.n_rows,) global values.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable with respect to ``local_vals``."""
    if local_vals.numel() != table.n_src:
        raise ValueError(f"seg_reduce: {local_vals.numel()} local values for a table "
                         f"over {table.n_src} slots")
    if local_vals.device != table.device:
        raise ValueError(f"seg_reduce: values on {local_vals.device}, table on {table.device}")
    src = local_vals.reshape(-1)
    if src.requires_grad:
        return _SegReduce.apply(src, table)
    return _seg_reduce(src, table)
