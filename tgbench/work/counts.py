"""Bytes and operations of each layer's work: the yardstick of the roofline
shares.

Every count is of the work, not of an implementation: each input the work
needs is read once and each output written once, whatever a kernel reads
again, at 8 bytes a float64 and 4 an int32 index.  ``least_s`` turns a
count into the least time the card needs for it.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Work", "least_s", "map_work", "reduce_work", "krylov_work", "action_work"]

F64, I32 = 8, 4


@dataclasses.dataclass(frozen=True)
class Work:
    nbytes: float
    flops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.nbytes + other.nbytes, self.flops + other.flops)

    def __mul__(self, k: float) -> "Work":
        return Work(self.nbytes * k, self.flops * k)


def least_s(work: Work, bytes_per_s: float, flops_per_s: float) -> float:
    """The larger of bytes / bandwidth and operations / peak rate."""
    return max(work.nbytes / bytes_per_s, work.flops / flops_per_s)


# -- Map: per element, the vertex coordinates (4 × 3) and the coefficient
#    are read and the local matrix or vector is written; the counts of a
#    Map kind are ``work/map/<kind>.py`` (BYTES and FLOPS a cell) ---------

COORDS = 12 * F64
# operations an element: the 3×3 Jacobian, its inverse and determinant
# (~45), the four gradients (~27)
GEOMETRY_FLOPS = 72


def map_work(kind: str, cells: int) -> Work:
    """One Map of ``kind`` over ``cells`` elements."""
    from tgbench.plugins import load

    counts = load("work/map", kind)
    return Work(counts.BYTES * cells, counts.FLOPS * cells)


def reduce_work(n_src: int, rows: int, batch: int = 1) -> Work:
    """B2's work: the source read and the output written once per instance
    (8 B each), one int32 slot index per contribution and one int32 offset
    per row; one addition per contribution."""
    return Work(F64 * batch * (n_src + rows) + I32 * n_src + I32 * (rows + 1),
                batch * n_src)


# -- Krylov: per iteration, each operator application reads the operator's
#    values and column indices once; each state vector is read once and
#    written once; the Jacobi diagonal is read once; the counts of a method
#    are ``work/krylov/<method>.py`` ---------------------------------------


def krylov_work(method: str, nnz: int, n: int, iterations: int) -> Work:
    """A Krylov loop of ``iterations`` on an operator of ``nnz`` stored
    values and ``n`` rows: every iteration's operator reads and vectors,
    plus the start (one operator application, the residual and the search
    vector written)."""
    from tgbench.plugins import load

    m = load("work/krylov", method)
    applies, state, read_only = m.APPLIES, m.STATE, m.READ_ONLY
    op = Work((F64 + I32) * nnz + F64 * n, 2 * nnz)
    per_iter = op * applies + Work(F64 * n * (2 * state + read_only), 10 * n * applies)
    start = op + Work(F64 * n * 3, 3 * n)
    return per_iter * iterations + start


def action_work(cells: int, nodes: int = 4, dim: int = 3) -> Work:
    """One matrix-free P1 diffusion action (``tg.matfree.action``): per
    element the basis gradients (nodes × dim), the element measure and the
    coefficient, and the gathered x_e are read, y_e is written;
    y_e = ρ|T| G (Gᵀ x_e)."""
    nbytes = F64 * (nodes * dim + 2 + 2 * nodes)
    flops = 2 * nodes * dim * 2 + dim + 1
    return Work(nbytes * cells, flops * cells)
