"""Sparse containers (CSR / ELL) on torch tensors, with SpMV.

The torch port of ``repro.core.sparse``.  The CSR *pattern* is static host
numpy held by one :class:`CSRPattern` that every matrix of a plan shares;
it stages its index arrays and its ELL layout to each device once.  Only
``vals`` is a tensor that changes from assembly to assembly (and that
autograd sees): the sparse operator enters a gradient through one dense
value vector.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..telemetry import annotate

__all__ = ["BatchedCSR", "CSR", "CSRPattern", "ELL", "cached_diagonal",
           "clear_device_mirrors", "csr_to_ell", "ell_layout"]

_PATTERNS: "weakref.WeakSet[CSRPattern]" = weakref.WeakSet()


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class CSRPattern:
    """A static CSR sparsity pattern: host arrays, their per-device
    mirrors, the derived ELL layout and its streaming SpMV plans (each
    computed once)."""

    def __init__(self, indptr, indices, shape, row_of_nnz=None, diag_pos=None):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.shape = (int(shape[0]), int(shape[1]))
        counts = np.diff(self.indptr)
        if row_of_nnz is None:
            row_of_nnz = np.repeat(np.arange(self.shape[0], dtype=np.int64), counts)
        self.row_of_nnz = np.asarray(row_of_nnz, dtype=np.int64)
        if diag_pos is None:
            diag_pos = -np.ones(self.shape[0], dtype=np.int64)
            on_diag = np.nonzero(self.row_of_nnz == self.indices)[0]
            diag_pos[self.row_of_nnz[on_diag]] = on_diag
        self.diag_pos = np.asarray(diag_pos, dtype=np.int64)
        self._staged: dict[torch.device, dict[str, torch.Tensor]] = {}
        self._ell = None
        self._stream = None
        _PATTERNS.add(self)

    def drop_mirrors(self) -> None:
        """Release the device mirrors, the ELL layout and the streaming
        plans (each is built again at its next use)."""
        self._staged = {}
        self._ell = None
        self._stream = None

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def staged(self, device, name: str) -> torch.Tensor:
        """The int64 device mirror of ``indices``/``row_of_nnz``/``diag_pos``
        or the ELL ``cols`` (int32) / ``flat_pos`` tables."""
        device = torch.device(device)
        per_dev = self._staged.setdefault(device, {})
        t = per_dev.get(name)
        if t is None:
            if name in ("cols", "flat_pos"):
                cols, flat_pos, _ = self.ell_layout()
                host = cols if name == "cols" else flat_pos
            else:
                host = getattr(self, name)
            t = per_dev[name] = _to_device(host, device)
        return t

    def ell_layout(self) -> tuple[np.ndarray, np.ndarray, int]:
        """Static ELL layout ``(cols, flat_pos, L)``: ``cols (n, L)`` int32
        with padded slots pointing back at their own row (their values are
        zero — the SpMV kernels rely on it), and ``flat_pos (nnz,)`` the slot
        of each stored entry in the flattened ``(n·L,)`` value table."""
        if self._ell is None:
            n = self.shape[0]
            counts = np.diff(self.indptr)
            L = int(counts.max()) if counts.size else 1
            cols = np.repeat(np.arange(n, dtype=np.int32)[:, None], L, axis=1)
            slot = np.arange(self.nnz, dtype=np.int64) - self.indptr[self.row_of_nnz]
            cols[self.row_of_nnz, slot] = self.indices
            self._ell = (cols, self.row_of_nnz * L + slot, L)
        return self._ell

    def stream_plans(self):
        """The streaming SpMV plans of the ELL layout
        (:class:`repro_torch.kernels.spmv_ell.StreamPlans`): one plan per
        ``block_n``, each staging its tables to a device once."""
        if self._stream is None:
            from ..kernels.spmv_ell import StreamPlans

            self._stream = StreamPlans(self.ell_layout()[0])
        return self._stream


@dataclasses.dataclass
class CSR:
    vals: torch.Tensor           # (nnz,)
    pattern: CSRPattern

    @classmethod
    def from_arrays(cls, vals, indptr, indices, shape, row_of_nnz=None,
                    diag_pos=None) -> "CSR":
        return cls(vals, CSRPattern(indptr, indices, shape, row_of_nnz, diag_pos))

    # -- the pattern, as the JAX container names it -------------------------
    @property
    def indptr(self) -> np.ndarray:
        return self.pattern.indptr

    @property
    def indices(self) -> np.ndarray:
        return self.pattern.indices

    @property
    def row_of_nnz(self) -> np.ndarray:
        return self.pattern.row_of_nnz

    @property
    def diag_pos(self) -> np.ndarray:
        return self.pattern.diag_pos

    @property
    def shape(self) -> tuple[int, int]:
        return self.pattern.shape

    @property
    def nnz(self) -> int:
        return self.pattern.nnz

    def with_vals(self, vals: torch.Tensor) -> "CSR":
        return CSR(vals, self.pattern)

    def _dev(self, name: str) -> torch.Tensor:
        return self.pattern.staged(self.vals.device, name)

    # -- ops ---------------------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x via gather + index-add over rows, on the last axis of
        ``x`` (any leading axes, e.g. a trajectory's time axis)."""
        contrib = self.vals * x[..., self._dev("indices")]
        out = torch.zeros((*x.shape[:-1], self.shape[0]), dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add(-1, self._dev("row_of_nnz"), contrib)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A.T @ x (scatter over columns)."""
        contrib = self.vals * x[self._dev("row_of_nnz")]
        out = torch.zeros(self.shape[1], dtype=contrib.dtype, device=contrib.device)
        return out.index_add(0, self._dev("indices"), contrib)

    def diagonal(self) -> torch.Tensor:
        dp = self._dev("diag_pos")
        zero = torch.zeros((), dtype=self.vals.dtype, device=self.vals.device)
        return torch.where(dp >= 0, self.vals[dp.clamp(min=0)], zero)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype, device=self.vals.device)
        out[self._dev("row_of_nnz"), self._dev("indices")] = self.vals
        return out

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.vals.detach().cpu().numpy(), self.indices, self.indptr),
            shape=self.shape,
        )


@dataclasses.dataclass
class BatchedCSR:
    """B same-pattern sparse operators: one shared :class:`CSRPattern` and
    ``(B, nnz)`` values — what ``assemble_batched`` produces over a family
    of coefficient sets or geometries.  The pattern accessors are
    :class:`CSR`'s, so condensers and other transforms of the values apply
    unchanged (masks broadcast over the batch axis); indexing gives one
    instance as a :class:`CSR`."""

    vals: torch.Tensor           # (B, nnz)
    pattern: CSRPattern

    indptr = CSR.indptr
    indices = CSR.indices
    row_of_nnz = CSR.row_of_nnz
    diag_pos = CSR.diag_pos
    shape = CSR.shape
    nnz = CSR.nnz
    _dev = CSR._dev

    @classmethod
    def stack(cls, csrs) -> "BatchedCSR":
        """Stack same-pattern :class:`CSR` instances along a new batch axis.
        Patterns must match in content, not only in nnz: two meshes can
        share an nnz by coincidence."""
        csrs = list(csrs)
        first = csrs[0]
        for c in csrs[1:]:
            same = c.shape == first.shape and (
                c.pattern is first.pattern
                or (np.array_equal(c.indices, first.indices)
                    and np.array_equal(c.indptr, first.indptr)))
            if not same:
                raise ValueError(
                    "BatchedCSR.stack: CSR sparsity patterns differ — all instances "
                    "must share one (mesh topology × space) pattern")
        return cls(torch.stack([c.vals for c in csrs]), first.pattern)

    @property
    def batch(self) -> int:
        return int(self.vals.shape[0])

    def with_vals(self, vals: torch.Tensor) -> "BatchedCSR":
        return BatchedCSR(vals, self.pattern)

    def as_csr(self) -> CSR:
        """Reinterpret as a single :class:`CSR` on this pattern — valid when
        ``vals`` is one instance's ``(nnz,)`` values."""
        return CSR(self.vals, self.pattern)

    def __getitem__(self, b):
        """Integer index → one instance as a :class:`CSR`; slice → the
        sub-family as a :class:`BatchedCSR`."""
        if isinstance(b, (int, np.integer)):
            return CSR(self.vals[b], self.pattern)
        if isinstance(b, slice):
            return BatchedCSR(self.vals[b], self.pattern)
        raise TypeError(f"BatchedCSR indices must be int or slice, got {type(b).__name__}")

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Y_b = A_b @ x_b for ``x (B, n)``; an ``(n,)`` x is shared by every
        instance."""
        xb = x[..., self._dev("indices")]
        contrib = self.vals * (xb if x.dim() == 2 else xb[None])
        out = torch.zeros((self.batch, self.shape[0]), dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add(1, self._dev("row_of_nnz"), contrib)

    def diagonal(self) -> torch.Tensor:
        dp = self._dev("diag_pos")
        zero = torch.zeros((), dtype=self.vals.dtype, device=self.vals.device)
        return torch.where(dp >= 0, self.vals[:, dp.clamp(min=0)], zero)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.batch, *self.shape), dtype=self.vals.dtype,
                          device=self.vals.device)
        out[:, self._dev("row_of_nnz"), self._dev("indices")] = self.vals
        return out


@dataclasses.dataclass
class ELL:
    """ELLPACK: fixed nnz-per-row padded layout — the layout of the SpMV
    kernels (bounded valence of FEM meshes).  ``cols_dev`` is the staged
    int32 column table on ``vals.device``; ``pattern`` the CSR pattern it
    was derived from (which caches the streaming plans)."""

    vals: torch.Tensor       # (n, L), zero-padded
    cols: np.ndarray         # (n, L) int32, padded with the row index
    shape: tuple[int, int]
    cols_dev: torch.Tensor   # (n, L) int32 on vals.device
    pattern: CSRPattern

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels.spmv_ell import spmv_ell

        return spmv_ell(self.vals, self.cols_dev, x)


def clear_device_mirrors() -> None:
    """Release every live pattern's device mirrors, ELL layout and
    streaming plans — part of
    :func:`repro_torch.core.clear_assembly_caches`."""
    for pattern in list(_PATTERNS):
        pattern.drop_mirrors()


def ell_layout(csr: CSR) -> tuple[np.ndarray, np.ndarray, int]:
    """Static ELL layout of a CSR pattern (see :meth:`CSRPattern.ell_layout`)."""
    return csr.pattern.ell_layout()


def csr_to_ell(csr: CSR) -> ELL:
    """The values of ``csr`` in the pattern's ELL layout (the layout is
    built once a pattern, the values filled at each call); a
    ``tg.ell.values`` range while a trace is taken."""
    with annotate("tg.ell.values", profiler_only=True):
        cols, _, L = csr.pattern.ell_layout()
        n = csr.shape[0]
        vals = torch.zeros(n * L, dtype=csr.vals.dtype, device=csr.vals.device)
        vals = vals.index_put((csr._dev("flat_pos"),), csr.vals)
        return ELL(vals.reshape(n, L), cols, csr.shape, csr._dev("cols"), csr.pattern)


def cached_diagonal(op) -> torch.Tensor:
    """``op.diagonal()`` memoized on the operator object itself, keyed by
    the tensors it is computed from: ``vals`` of an assembled operator, the
    geometry and coefficient tensors (``traced()``) of a matrix-free one.
    Repeated Jacobi solves against one operator take the diagonal once.
    Tensors that require grad are never cached: the diagonal then belongs
    to that autograd graph."""
    vals = getattr(op, "vals", None)
    key = (vals,) if vals is not None else tuple(op.traced()) if hasattr(op, "traced") else ()
    if any(t.requires_grad for t in key):
        return op.diagonal()
    hit = getattr(op, "_diag_cache", None)
    if hit is not None and len(hit[0]) == len(key) and all(a is b for a, b in zip(hit[0], key)):
        return hit[1]
    d = op.diagonal()
    object.__setattr__(op, "_diag_cache", (key, d))
    return d
