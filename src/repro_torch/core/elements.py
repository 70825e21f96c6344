"""Reference elements: basis functions and gradients on the reference cell.

A :class:`ReferenceElement` provides, for a quadrature rule ``(Q, d)``:

* ``tabulate(points) -> (Q, k)``       basis values          (``B̂`` in Alg. 1)
* ``tabulate_grad(points) -> (Q, k, d)`` reference gradients  (``∇B̂``)

All tabulation happens at setup time in numpy; the resulting dense tables are
constants of the Batch-Map.  A copy of ``repro.core.elements``, so the torch
port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import quadrature

__all__ = ["ReferenceElement", "get_element"]


@dataclasses.dataclass(frozen=True)
class ReferenceElement:
    name: str
    dim: int           # spatial dimension d
    num_dofs: int      # local DoFs k
    cell: str          # 'simplex' | 'tensor'
    degree: int

    # ------------------------------------------------------------------
    def tabulate(self, pts: np.ndarray) -> np.ndarray:
        return _TABULATE[self.name](np.asarray(pts, dtype=np.float64))

    def tabulate_grad(self, pts: np.ndarray) -> np.ndarray:
        return _TABULATE_GRAD[self.name](np.asarray(pts, dtype=np.float64))

    def default_rule(self, order: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Quadrature exact for the mass-matrix degree of this element."""
        order = order if order is not None else 2 * self.degree
        if self.cell == "simplex":
            if self.dim == 1:
                return quadrature.gauss_legendre_interval(order)
            if self.dim == 2:
                return quadrature.triangle_rule(order)
            return quadrature.tetrahedron_rule(order)
        if self.dim == 2:
            return quadrature.quad_rule(order)
        return quadrature.hex_rule(order)


# --- P1 line (used for boundary facets of triangles) ------------------------

def _p1_line(p):
    x = p[:, 0]
    return np.stack([1 - x, x], axis=-1)


def _p1_line_grad(p):
    q = p.shape[0]
    g = np.zeros((q, 2, 1))
    g[:, 0, 0] = -1.0
    g[:, 1, 0] = 1.0
    return g


# --- P1 triangle -------------------------------------------------------------

def _p1_tri(p):
    x, y = p[:, 0], p[:, 1]
    return np.stack([1 - x - y, x, y], axis=-1)


def _p1_tri_grad(p):
    q = p.shape[0]
    g = np.zeros((q, 3, 2))
    g[:, 0] = [-1.0, -1.0]
    g[:, 1] = [1.0, 0.0]
    g[:, 2] = [0.0, 1.0]
    return g


# --- P2 triangle -------------------------------------------------------------
# DoF order: 3 vertices, then midpoints of edges (01), (12), (20).

def _p2_tri(p):
    x, y = p[:, 0], p[:, 1]
    lam0, lam1, lam2 = 1 - x - y, x, y
    return np.stack(
        [
            lam0 * (2 * lam0 - 1),
            lam1 * (2 * lam1 - 1),
            lam2 * (2 * lam2 - 1),
            4 * lam0 * lam1,
            4 * lam1 * lam2,
            4 * lam2 * lam0,
        ],
        axis=-1,
    )


def _p2_tri_grad(p):
    x, y = p[:, 0], p[:, 1]
    lam0 = 1 - x - y
    d0 = np.array([-1.0, -1.0])
    d1 = np.array([1.0, 0.0])
    d2 = np.array([0.0, 1.0])
    q = p.shape[0]
    g = np.zeros((q, 6, 2))
    g[:, 0] = (4 * lam0 - 1)[:, None] * d0
    g[:, 1] = (4 * x - 1)[:, None] * d1
    g[:, 2] = (4 * y - 1)[:, None] * d2
    g[:, 3] = 4 * (lam0[:, None] * d1 + x[:, None] * d0)
    g[:, 4] = 4 * (x[:, None] * d2 + y[:, None] * d1)
    g[:, 5] = 4 * (y[:, None] * d0 + lam0[:, None] * d2)
    return g


# --- P1 tetrahedron ----------------------------------------------------------

def _p1_tet(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return np.stack([1 - x - y - z, x, y, z], axis=-1)


def _p1_tet_grad(p):
    q = p.shape[0]
    g = np.zeros((q, 4, 3))
    g[:, 0] = [-1.0, -1.0, -1.0]
    g[:, 1] = [1.0, 0.0, 0.0]
    g[:, 2] = [0.0, 1.0, 0.0]
    g[:, 3] = [0.0, 0.0, 1.0]
    return g


# --- Q1 quad -----------------------------------------------------------------
# DoF order: (0,0), (1,0), (1,1), (0,1)  (counter-clockwise).

def _q1_quad(p):
    x, y = p[:, 0], p[:, 1]
    return np.stack(
        [(1 - x) * (1 - y), x * (1 - y), x * y, (1 - x) * y], axis=-1
    )


def _q1_quad_grad(p):
    x, y = p[:, 0], p[:, 1]
    q = p.shape[0]
    g = np.zeros((q, 4, 2))
    g[:, 0, 0] = -(1 - y); g[:, 0, 1] = -(1 - x)
    g[:, 1, 0] = (1 - y);  g[:, 1, 1] = -x
    g[:, 2, 0] = y;        g[:, 2, 1] = x
    g[:, 3, 0] = -y;       g[:, 3, 1] = (1 - x)
    return g


# --- Q1 hex ------------------------------------------------------------------
# DoF order: standard lexicographic corners of the unit cube.

_HEX_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.float64,
)


def _q1_hex(p):
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    cx, cy, cz = _HEX_CORNERS[:, 0], _HEX_CORNERS[:, 1], _HEX_CORNERS[:, 2]
    fx = cx * x + (1 - cx) * (1 - x)
    fy = cy * y + (1 - cy) * (1 - y)
    fz = cz * z + (1 - cz) * (1 - z)
    return fx * fy * fz


def _q1_hex_grad(p):
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    cx, cy, cz = _HEX_CORNERS[:, 0], _HEX_CORNERS[:, 1], _HEX_CORNERS[:, 2]
    fx = cx * x + (1 - cx) * (1 - x)
    fy = cy * y + (1 - cy) * (1 - y)
    fz = cz * z + (1 - cz) * (1 - z)
    dfx = 2 * cx - 1.0
    dfy = 2 * cy - 1.0
    dfz = 2 * cz - 1.0
    g = np.stack([dfx * fy * fz, fx * dfy * fz, fx * fy * dfz], axis=-1)
    return g


_TABULATE = {
    "P1_line": _p1_line,
    "P1_tri": _p1_tri,
    "P2_tri": _p2_tri,
    "P1_tet": _p1_tet,
    "Q1_quad": _q1_quad,
    "Q1_hex": _q1_hex,
}
_TABULATE_GRAD = {
    "P1_line": _p1_line_grad,
    "P1_tri": _p1_tri_grad,
    "P2_tri": _p2_tri_grad,
    "P1_tet": _p1_tet_grad,
    "Q1_quad": _q1_quad_grad,
    "Q1_hex": _q1_hex_grad,
}

_ELEMENTS = {
    "P1_line": ReferenceElement("P1_line", 1, 2, "simplex", 1),
    "P1_tri": ReferenceElement("P1_tri", 2, 3, "simplex", 1),
    "P2_tri": ReferenceElement("P2_tri", 2, 6, "simplex", 2),
    "P1_tet": ReferenceElement("P1_tet", 3, 4, "simplex", 1),
    "Q1_quad": ReferenceElement("Q1_quad", 2, 4, "tensor", 1),
    "Q1_hex": ReferenceElement("Q1_hex", 3, 8, "tensor", 1),
}


def get_element(name: str) -> ReferenceElement:
    return _ELEMENTS[name]
