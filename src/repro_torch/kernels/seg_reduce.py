"""Stage-II Sparse-Reduce as a segment-table gather-sum: the wrapper of the
CUDA kernel ``csrc/seg_reduce.cu`` (the port of the Pallas kernel
``repro.kernels.seg_reduce.seg_reduce``), and the host builders of its
tables.

A routing's sorted segment layout is a CSR-style segment table: the slot
list ``slots`` (the routing's ``perm``, int32) holds the local positions of
every contribution, grouped by global row in increasing order within a row,
and ``ptr`` (``rows + 1`` int32 offsets) where each row's group starts.  The
Reduce is then a deterministic gather-sum in slot order::

    out[n] = Σ_{k = ptr[n]}^{ptr[n+1]-1}  vec(K_local)[slots[k]]

The kernel takes the rows in runs (:func:`reduce_runs`), one CTA a run.
With ``batch=True`` the source carries a leading batch axis, ``(B, ...)``
with ``n_src`` values per instance, and one launch reduces every instance
on the shared table onto ``(B, rows)``.

:func:`padded_table` and :func:`build_padded_reduce` give the JAX package's
padded ``(rows, L)`` layout of the same table, which its Pallas kernel
reads; the port keeps them as the counterpart of that builder.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .ref import seg_reduce_ref

__all__ = ["ReduceTable", "build_padded_reduce", "padded_table", "reduce_runs", "seg_reduce",
           "segment_table"]


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


def segment_table(perm: np.ndarray, rows_sorted: np.ndarray,
                  n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """The segment table of a routing: ``(slots, ptr)``, int32, where row
    ``n``'s local slots are ``slots[ptr[n]:ptr[n+1]]`` — the slots
    ``perm[i]`` with ``rows_sorted[i] == n``, in their sorted order (the
    rows of :func:`padded_table` without their sentinels).
    ``rows_sorted`` must be non-decreasing (a stable sort of the routing
    keys)."""
    n_src = perm.shape[0]
    if max(n_src, n_rows) >= 2 ** 31:
        raise ValueError(f"{n_src} local slots onto {n_rows} rows overflow the int32 "
                         "segment table")
    if rows_sorted.size and ((rows_sorted[1:] < rows_sorted[:-1]).any() or rows_sorted[0] < 0
                             or rows_sorted[-1] >= n_rows):
        raise ValueError(f"segment_table: rows_sorted must be non-decreasing row ids in "
                         f"[0, {n_rows})")
    ptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows_sorted, minlength=n_rows), out=ptr[1:])
    return np.ascontiguousarray(perm, dtype=np.int32), ptr


def reduce_runs(ptr: np.ndarray, max_rows: int, max_slots: int) -> np.ndarray:
    """Cut the rows of a segment table into runs, one CTA of the kernel
    each: int32 row offsets ``runs`` (``runs[0] = 0``, ``runs[-1] = n_rows``,
    increasing), each run as long as it can be with at most ``max_rows``
    rows and ``max_slots`` slots.  A row with more than ``max_slots`` slots
    is a run of its own (the kernel sums such a run from global memory)."""
    n_rows = ptr.shape[0] - 1
    runs, r = [0], 0
    while r < n_rows:
        # rows r + 1 .. r + max_rows as run ends: take the last within max_slots
        ends = ptr[r + 1:r + max_rows + 1]
        r += max(1, int(np.searchsorted(ends, int(ptr[r]) + max_slots, side="right")))
        runs.append(r)
    return np.asarray(runs, dtype=np.int32)


def build_padded_reduce(routing) -> np.ndarray:
    """``(nnz, L)`` indices into vec(K_local) with pad → index E·k² (the
    sentinel) — equal to ``repro.kernels.seg_reduce.build_padded_reduce``,
    without its Python loop over every local slot."""
    return padded_table(routing.perm, routing.seg_ids, routing.nnz)


class ReduceTable:
    """One Sparse-Reduce (``n_src`` local slots onto ``n_rows`` global
    entries) for a device.  On a CUDA device it stages the kernel's segment
    table at construction: ``slots`` and ``ptr`` (:func:`segment_table`) and
    the run offsets ``runs`` (:func:`reduce_runs` at the kernel's stage);
    the per-slot row ids of the plain version and of the gradient are
    staged at first use."""

    def __init__(self, perm, rows_sorted, rows_unsorted, n_rows: int, device):
        self.n_rows = int(n_rows)
        self.n_src = int(perm.shape[0])
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._rows_host = rows_unsorted
        self._rows = None
        self.slots = self.ptr = self.runs = None
        if self.device.type == "cuda":
            slots, ptr = segment_table(perm, rows_sorted, self.n_rows)
            stage = [_cuda.query("seg_reduce", f"tg_seg_reduce_stage_{cap}", self.device)
                     for cap in ("rows", "slots")]
            self.slots, self.ptr, self.runs = (torch.from_numpy(a).to(self.device)
                                               for a in (slots, ptr, reduce_runs(ptr, *stage)))

    @classmethod
    def for_matrix(cls, routing, device) -> "ReduceTable":
        return cls(routing.perm, routing.seg_ids, routing.seg_ids_unsorted, routing.nnz, device)

    @classmethod
    def for_vector(cls, routing, device) -> "ReduceTable":
        """Rows are the global dofs (untouched dofs get no contributions)."""
        t = routing.touched
        return cls(routing.perm, t[routing.seg_ids], t[routing.seg_ids_unsorted],
                   routing.num_dofs, device)

    @classmethod
    def for_slot_range(cls, rows_unsorted: np.ndarray, lo: int, hi: int, n_rows: int,
                       device) -> "ReduceTable":
        """The Reduce of the local slots ``lo .. hi-1`` alone onto all
        ``n_rows`` rows (a rank's element block × its slots), from each
        slot's global row ``rows_unsorted``: the slots stably sorted by
        row, so each row sums its slots in increasing slot order, as the
        whole routing's table does."""
        rows = rows_unsorted[lo:hi]
        perm = np.argsort(rows, kind="stable")
        return cls(perm, rows[perm], rows, n_rows, device)

    def drop_mirrors(self) -> None:
        """Release the lazily staged row ids (staged again at next use)."""
        self._rows = None

    @property
    def rows(self) -> torch.Tensor:
        """Global row of each local slot, ``(n_src,)`` int64 on the device."""
        if self._rows is None:
            self._rows = torch.from_numpy(np.ascontiguousarray(self._rows_host)).to(self.device)
        return self._rows


def _seg_reduce(src: torch.Tensor, table: ReduceTable) -> torch.Tensor:
    """``src`` is ``(n_src,)`` or ``(B, n_src)``."""
    batched = src.dim() == 2
    if src.device.type == "cpu":
        return seg_reduce_ref(src, table.rows, table.n_rows, batch=batched)
    dtype = _cuda.check_operands("seg_reduce", {"local_vals": src, "slots": table.slots})
    out = torch.empty((*src.shape[:-1], table.n_rows), dtype=dtype, device=src.device)
    if out.numel():
        _cuda.launch("seg_reduce", "seg_reduce", _cuda.symbol("tg_seg_reduce", dtype),
                     src, table.slots, table.ptr, table.runs, out, table.runs.shape[0] - 1,
                     table.n_rows, table.n_src, src.shape[0] if batched else 1)
    return out


class _SegReduce(torch.autograd.Function):
    """The Reduce with its adjoint: the gradient of a local slot is the
    output gradient of its row (a gather), instance by instance."""

    @staticmethod
    def forward(ctx, src, table):
        ctx.table = table
        return _seg_reduce(src, table)

    @staticmethod
    def backward(ctx, grad_out):
        return grad_out[..., ctx.table.rows], None


def seg_reduce(local_vals: torch.Tensor, table: ReduceTable, batch: bool = False) -> torch.Tensor:
    """local_vals (E, ka, kb), (E, k) or flat → (table.n_rows,) global
    values; with ``batch``, local_vals (B, ...) → (B, table.n_rows).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable with respect to ``local_vals``."""
    n_inst = (local_vals.shape[0] if local_vals.dim() else -1) if batch else 1
    if local_vals.numel() != n_inst * table.n_src:
        raise ValueError(f"seg_reduce: {tuple(local_vals.shape)} local values for a table "
                         f"over {table.n_src} slots (batch={batch})")
    if local_vals.device != table.device:
        raise ValueError(f"seg_reduce: values on {local_vals.device}, table on {table.device}")
    src = local_vals.reshape(n_inst, table.n_src) if batch else local_vals.reshape(-1)
    if src.requires_grad:
        return _SegReduce.apply(src, table)
    return _seg_reduce(src, table)
