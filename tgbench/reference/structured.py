"""Structured tetrahedral meshes of boxes (numpy), shared by the frozen
generators in ``reference/meshes/``.

Vertex and cell order: a C-ordered (i, j, k) grid of vertices; each cube
split into six tetrahedra along its main diagonal (Kuhn), cubes in C order;
vertices no cell uses are dropped.  The benchmark builds every mesh from
these and hands the same arrays to the program and to the reference, so
the reference never takes a mesh that the program made.
"""

from __future__ import annotations

import numpy as np

__all__ = ["box"]

# corner c of a cube sits at offsets (c & 1, (c >> 1) & 1, c >> 2)
KUHN = np.array([[0, 1, 3, 7], [0, 1, 7, 5], [0, 5, 7, 4],
               [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7]])


def box(n: int, keep=None) -> tuple[np.ndarray, np.ndarray]:
    """``(points, cells)`` of [0,1]³ in n³ cubes, the cubes ``keep(i, j, k)``
    selects (all by default)."""
    axis = np.linspace(0.0, 1.0, n + 1)
    points = np.stack([g.ravel() for g in np.meshgrid(axis, axis, axis, indexing="ij")], -1)
    i, j, k = (g.ravel() for g in np.meshgrid(*(np.arange(n),) * 3, indexing="ij"))
    if keep is not None:
        mask = keep(i, j, k)
        i, j, k = i[mask], j[mask], k[mask]

    def vid(a, b, c):
        return (a * (n + 1) + b) * (n + 1) + c

    corners = np.stack([vid(i + (c & 1), j + ((c >> 1) & 1), k + (c >> 2)) for c in range(8)], 1)
    cells = corners[:, KUHN].reshape(-1, 4)
    used = np.unique(cells)
    remap = np.full(points.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    return points[used], remap[cells]
