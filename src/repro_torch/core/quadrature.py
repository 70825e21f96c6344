"""Quadrature rules on reference elements.

All rules are returned as ``(points, weights)`` numpy arrays with
``points.shape == (Q, d)`` and ``weights.shape == (Q,)``.  Weights include the
reference-element measure, i.e. ``sum(w) == |ref element|`` (1/2 for the unit
triangle, 1/6 for the unit tetrahedron, 1 for the unit interval/square/cube).

These are *setup-time* objects (numpy) — they are staged once into the
assembly plan as constants of the Batch-Map, matching the paper's
precomputed ``(ŵ_q, x̂_q)`` (Alg. 1).  A copy of ``repro.core.quadrature``,
so the torch port never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gauss_legendre_interval",
    "triangle_rule",
    "tetrahedron_rule",
    "quad_rule",
    "hex_rule",
]


def gauss_legendre_interval(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre rule on [0, 1] exact for polynomials of degree ``order``."""
    npts = order // 2 + 1
    x, w = np.polynomial.legendre.leggauss(npts)
    # map [-1, 1] -> [0, 1]
    x = 0.5 * (x + 1.0)
    w = 0.5 * w
    return x[:, None].astype(np.float64), w.astype(np.float64)


# --- Simplex rules (Dunavant / Keast style, standard references) -----------

_TRI_RULES: dict[int, tuple[list[list[float]], list[float]]] = {
    # order: (barycentric-ish points on unit triangle, weights summing to 1/2)
    1: ([[1 / 3, 1 / 3]], [0.5]),
    2: (
        [[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]],
        [1 / 6, 1 / 6, 1 / 6],
    ),
    3: (
        [[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]],
        [-27 / 96, 25 / 96, 25 / 96, 25 / 96],
    ),
    4: (
        [
            [0.445948490915965, 0.445948490915965],
            [0.445948490915965, 0.108103018168070],
            [0.108103018168070, 0.445948490915965],
            [0.091576213509771, 0.091576213509771],
            [0.091576213509771, 0.816847572980459],
            [0.816847572980459, 0.091576213509771],
        ],
        [
            0.111690794839005,
            0.111690794839005,
            0.111690794839005,
            0.054975871827661,
            0.054975871827661,
            0.054975871827661,
        ],
    ),
}

_TET_RULES: dict[int, tuple[list[list[float]], list[float]]] = {
    1: ([[0.25, 0.25, 0.25]], [1 / 6]),
    2: (
        [
            [0.138196601125011, 0.138196601125011, 0.138196601125011],
            [0.585410196624969, 0.138196601125011, 0.138196601125011],
            [0.138196601125011, 0.585410196624969, 0.138196601125011],
            [0.138196601125011, 0.138196601125011, 0.585410196624969],
        ],
        [1 / 24, 1 / 24, 1 / 24, 1 / 24],
    ),
    3: (
        [
            [0.25, 0.25, 0.25],
            [0.5, 1 / 6, 1 / 6],
            [1 / 6, 0.5, 1 / 6],
            [1 / 6, 1 / 6, 0.5],
            [1 / 6, 1 / 6, 1 / 6],
        ],
        [-4 / 30, 0.075, 0.075, 0.075, 0.075],
    ),
}


def triangle_rule(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature on the unit triangle {x>=0, y>=0, x+y<=1}."""
    order = min(max(order, 1), 4)
    pts, w = _TRI_RULES[order]
    return np.asarray(pts, dtype=np.float64), np.asarray(w, dtype=np.float64)


def tetrahedron_rule(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature on the unit tetrahedron."""
    order = min(max(order, 1), 3)
    pts, w = _TET_RULES[order]
    return np.asarray(pts, dtype=np.float64), np.asarray(w, dtype=np.float64)


def quad_rule(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Tensor-product Gauss rule on the unit square [0,1]^2."""
    x, w = gauss_legendre_interval(order)
    x = x[:, 0]
    X, Y = np.meshgrid(x, x, indexing="ij")
    W = np.outer(w, w)
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    return pts, W.ravel()


def hex_rule(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Tensor-product Gauss rule on the unit cube [0,1]^3."""
    x, w = gauss_legendre_interval(order)
    x = x[:, 0]
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    W = np.einsum("i,j,k->ijk", w, w, w)
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    return pts, W.ravel()
