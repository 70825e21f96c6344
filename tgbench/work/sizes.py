"""Sizes of a P1 problem, from the benchmark's own mesh arrays."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Sizes", "p1_sizes"]

_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])


@dataclasses.dataclass(frozen=True)
class Sizes:
    cells: int          # E
    vertices: int
    value_size: int     # 1 scalar, 3 elasticity
    dofs: int           # N
    nnz: int            # stored values of the global matrix (its pattern)

    @property
    def local(self) -> int:
        """DoFs of one element, k."""
        return 4 * self.value_size


def p1_sizes(cells: np.ndarray, num_vertices: int, value_size: int) -> Sizes:
    """A vertex couples with itself and each vertex it shares an edge with;
    a vector space couples every component pair."""
    e = np.sort(cells[:, _EDGES].reshape(-1, 2), axis=1)
    n_edges = np.unique(e[:, 0] * np.int64(num_vertices) + e[:, 1]).shape[0]
    scalar_nnz = num_vertices + 2 * n_edges
    return Sizes(cells.shape[0], num_vertices, value_size, num_vertices * value_size,
                 scalar_nnz * value_size ** 2)
