"""Stage-II precompute: topology-aware routing for the Sparse-Reduce.

The torch port's copy of ``repro.core.routing``.  The paper's routing
matrices ``S_mat ∈ {0,1}^{N_nnz × Ek²}`` and ``S_vec ∈ {0,1}^{N × Ek}`` have
exactly one nonzero per column — they are *functions* from local slots to
global slots.  Set-up (numpy, once per mesh topology) lexsorts the ``Ek²``
COO coordinates, extracts the unique CSR sparsity pattern, and stores the
permutation ``perm`` plus the sorted segment ids ``seg_ids``.

The arrays stay on the host as numpy; the assembly plan stages what its
device needs once (:class:`repro_torch.kernels.seg_reduce.ReduceTable`,
:class:`repro_torch.core.sparse.CSRPattern`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .sparse import CSRPattern

__all__ = ["MatrixRouting", "VectorRouting", "build_matrix_routing", "build_vector_routing"]


@dataclasses.dataclass(frozen=True, eq=False)
class MatrixRouting:
    """Precomputed Sparse-Reduce for stiffness-matrix assembly."""

    num_dofs: int
    nnz: int
    indptr: np.ndarray       # (num_dofs + 1,) CSR row pointers
    indices: np.ndarray      # (nnz,) CSR column indices
    perm: np.ndarray         # (E*ka*kb,) sort permutation of local slots
    seg_ids: np.ndarray      # (E*ka*kb,) sorted segment ids (into nnz)
    seg_ids_unsorted: np.ndarray  # (E*ka*kb,) segment id of each local slot
    row_of_nnz: np.ndarray   # (nnz,) row index of each stored entry
    diag_pos: np.ndarray     # (num_dofs,) position of (i,i) in vals, -1 if absent

    @functools.cached_property
    def pattern(self) -> CSRPattern:
        """The CSR sparsity pattern every matrix of this routing shares."""
        return CSRPattern(self.indptr, self.indices, (self.num_dofs, self.num_dofs),
                          row_of_nnz=self.row_of_nnz, diag_pos=self.diag_pos)


@dataclasses.dataclass(frozen=True, eq=False)
class VectorRouting:
    """Precomputed Sparse-Reduce for load-vector assembly."""

    num_dofs: int
    perm: np.ndarray
    seg_ids: np.ndarray
    seg_ids_unsorted: np.ndarray
    touched: np.ndarray      # (n_touched,) global dofs receiving contributions


def _segments(key: np.ndarray):
    """Stable sort of ``key``: ``(perm, sorted_key, new_segment_mask)``."""
    perm = np.argsort(key, kind="stable")
    sorted_key = key[perm]
    new_seg = np.empty(sorted_key.shape[0], dtype=bool)
    new_seg[:1] = True
    new_seg[1:] = sorted_key[1:] != sorted_key[:-1]
    return perm, sorted_key, new_seg


def build_matrix_routing(
    row_dofs: np.ndarray, col_dofs: np.ndarray | None, num_dofs: int
) -> MatrixRouting:
    """Routing for local matrices with rows ``row_dofs: (E, ka)`` and columns
    ``col_dofs: (E, kb)`` (defaults to ``row_dofs`` — Galerkin)."""
    row_dofs = np.asarray(row_dofs, dtype=np.int64)
    col_dofs = row_dofs if col_dofs is None else np.asarray(col_dofs, dtype=np.int64)
    e, ka = row_dofs.shape
    kb = col_dofs.shape[1]

    rows = np.broadcast_to(row_dofs[:, :, None], (e, ka, kb)).ravel()
    cols = np.broadcast_to(col_dofs[:, None, :], (e, ka, kb)).ravel()
    perm, sorted_key, new_seg = _segments(rows * num_dofs + cols)
    seg_ids = np.cumsum(new_seg) - 1
    nnz = int(seg_ids[-1]) + 1 if seg_ids.size else 0

    uniq_key = sorted_key[new_seg]
    uniq_rows = uniq_key // num_dofs
    uniq_cols = uniq_key % num_dofs
    indptr = np.zeros(num_dofs + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(uniq_rows, minlength=num_dofs))

    seg_unsorted = np.empty_like(seg_ids)
    seg_unsorted[perm] = seg_ids

    diag_pos = -np.ones(num_dofs, dtype=np.int64)
    is_diag = uniq_rows == uniq_cols
    diag_pos[uniq_rows[is_diag]] = np.nonzero(is_diag)[0]

    return MatrixRouting(
        num_dofs=num_dofs,
        nnz=nnz,
        indptr=indptr,
        indices=uniq_cols,
        perm=perm,
        seg_ids=seg_ids,
        seg_ids_unsorted=seg_unsorted,
        row_of_nnz=uniq_rows,
        diag_pos=diag_pos,
    )


def build_vector_routing(row_dofs: np.ndarray, num_dofs: int) -> VectorRouting:
    """Routing for local vectors ``(E, k)`` onto a global ``(num_dofs,)``."""
    rows = np.asarray(row_dofs, dtype=np.int64).ravel()
    perm, srt, new_seg = _segments(rows)
    # segment ids index *touched* dofs
    seg_ids = np.cumsum(new_seg) - 1
    seg_unsorted = np.empty_like(seg_ids)
    seg_unsorted[perm] = seg_ids
    return VectorRouting(
        num_dofs=num_dofs,
        perm=perm,
        seg_ids=seg_ids,
        seg_ids_unsorted=seg_unsorted,
        touched=srt[new_seg],
    )
