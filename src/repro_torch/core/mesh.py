"""Mesh containers and structured generators (numpy, setup-time).

The torch port's copy of ``repro.core.mesh``.  A :class:`Mesh` stores
vertices + cells; a :class:`FunctionSpace` derives the DoF layout
(``cell_dofs: (E, k)`` — the local→global map ``g_e`` of the paper) for a
chosen reference element.

The generators are vectorised (no per-cell Python loop), because the port
meshes at sizes where such loops would dominate set-up, e.g.
``unit_cube_tet(64)`` has 1.57 M tetrahedra.  They return the *same*
``points``/``cells`` arrays, in the same order, as the loop-based JAX
reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .elements import ReferenceElement, get_element

__all__ = [
    "Mesh",
    "FunctionSpace",
    "element_for_mesh",
    "unit_square_tri",
    "rectangle_tri",
    "rectangle_quad",
    "unit_cube_tet",
    "box_hex",
    "unit_cube_hex",
    "hollow_cube_tet",
    "l_shape_tri",
    "disk_tri",
    "annulus_sector_tri",
]


# ---------------------------------------------------------------------------
# Mesh container
# ---------------------------------------------------------------------------

_FACET_LOCAL = {
    # local vertex indices of each facet, per cell type
    "tri": np.array([[0, 1], [1, 2], [2, 0]]),
    "quad": np.array([[0, 1], [1, 2], [2, 3], [3, 0]]),
    "tet": np.array([[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]]),
    # Q1 hex corner order matches elements._HEX_CORNERS (z=0 quad then z=1)
    "hex": np.array(
        [
            [0, 3, 2, 1],  # z = 0 (outward −z)
            [4, 5, 6, 7],  # z = 1
            [0, 1, 5, 4],  # y = 0
            [3, 7, 6, 2],  # y = 1
            [0, 4, 7, 3],  # x = 0
            [1, 2, 6, 5],  # x = 1
        ]
    ),
}


def _row_keys(rows: np.ndarray, base: int):
    """Encode each row of non-negative ints ``< base`` as one int64 key that
    sorts like the row does lexicographically, or ``None`` when the key
    would overflow int64 (callers then fall back to ``np.unique(axis=0)``)."""
    if base ** rows.shape[1] >= 2 ** 62:
        return None
    key = np.zeros(rows.shape[0], dtype=np.int64)
    for c in range(rows.shape[1]):
        key = key * base + rows[:, c]
    return key


@dataclasses.dataclass
class Mesh:
    points: np.ndarray          # (n_vertices, d)
    cells: np.ndarray           # (E, verts_per_cell), int
    cell_type: str              # 'tri' | 'quad' | 'tet' | 'hex'

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64)
        self.cells = np.asarray(self.cells, dtype=np.int64)

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    # -- topology -----------------------------------------------------------
    def boundary_facets(self) -> np.ndarray:
        """Facets that appear in exactly one cell, as ``(F, nv)`` vertex
        indices with the outward orientation of the generating cell."""
        loc = _FACET_LOCAL[self.cell_type]
        flat = self.cells[:, loc].reshape(-1, loc.shape[1])   # (E*nf, nv)
        srt = np.sort(flat, axis=1)
        key = _row_keys(srt, self.num_vertices)
        if key is None:
            _, inv, counts = np.unique(srt, axis=0, return_inverse=True,
                                       return_counts=True)
        else:
            _, inv, counts = np.unique(key, return_inverse=True,
                                       return_counts=True)
        return flat[counts[inv.ravel()] == 1]

    def cell_volumes(self) -> np.ndarray:
        x = self.points[self.cells]
        if self.cell_type == "tri":
            a = x[:, 1] - x[:, 0]
            b = x[:, 2] - x[:, 0]
            return 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
        if self.cell_type == "tet":
            a = x[:, 1] - x[:, 0]
            b = x[:, 2] - x[:, 0]
            c = x[:, 3] - x[:, 0]
            return np.abs(np.einsum("ei,ei->e", a, np.cross(b, c))) / 6.0
        if self.cell_type == "quad":
            a = x[:, 1] - x[:, 0]
            b = x[:, 3] - x[:, 0]
            return np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
        if self.cell_type == "hex":
            # exact for parallelepipeds (all structured generators here)
            a = x[:, 1] - x[:, 0]
            b = x[:, 3] - x[:, 0]
            c = x[:, 4] - x[:, 0]
            return np.abs(np.einsum("ei,ei->e", a, np.cross(b, c)))
        raise ValueError(self.cell_type)


# ---------------------------------------------------------------------------
# Function spaces (DoF layouts)
# ---------------------------------------------------------------------------

_P2_EDGES = np.array([[0, 1], [1, 2], [2, 0]])


def _edge_numbering(cells: np.ndarray, edge_local: np.ndarray, n_vertices: int):
    """Globally number unique edges, in lexicographic (a, b) order; returns
    ``(uniq_edges (n_edges, 2), cell_edges (E, ne))``."""
    flat = np.sort(cells[:, edge_local].reshape(-1, 2), axis=1)
    key = _row_keys(flat, n_vertices)
    if key is None:
        uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    else:
        ukey, inv = np.unique(key, return_inverse=True)
        uniq = np.stack([ukey // n_vertices, ukey % n_vertices], axis=1)
    return uniq, inv.reshape(cells.shape[0], edge_local.shape[0])


@dataclasses.dataclass
class FunctionSpace:
    """Scalar Lagrange space on a mesh.

    Vector-valued problems use the same scalar space with ``value_size``
    components; global DoF = ``node * value_size + comp``.
    """

    mesh: Mesh
    element: ReferenceElement
    value_size: int = 1

    def __post_init__(self):
        m, el = self.mesh, self.element
        if el.name in ("P1_tri", "P1_tet", "Q1_quad", "Q1_hex"):
            self.scalar_dofs = m.num_vertices
            scalar_cell_dofs = m.cells
            self.dof_points = m.points
        elif el.name == "P2_tri":
            uniq_edges, cell_edges = _edge_numbering(m.cells, _P2_EDGES, m.num_vertices)
            self.scalar_dofs = m.num_vertices + uniq_edges.shape[0]
            scalar_cell_dofs = np.concatenate(
                [m.cells, m.num_vertices + cell_edges], axis=1
            )
            mid = 0.5 * (m.points[uniq_edges[:, 0]] + m.points[uniq_edges[:, 1]])
            self.dof_points = np.concatenate([m.points, mid], axis=0)
        else:
            raise NotImplementedError(el.name)

        v = self.value_size
        if v == 1:
            self.cell_dofs = scalar_cell_dofs
        else:
            # interleaved components: dof = scalar_dof * v + comp
            base = scalar_cell_dofs[:, :, None] * v + np.arange(v)[None, None, :]
            self.cell_dofs = base.reshape(m.num_cells, -1)
        self.num_dofs = self.scalar_dofs * v
        self.local_dofs = self.cell_dofs.shape[1]

    # -- boundary DoFs --------------------------------------------------------
    def boundary_dofs(self, predicate=None) -> np.ndarray:
        """Scalar boundary DoFs (vertex + P2 edge DoFs) filtered by predicate
        on DoF coordinates; expanded across components for vector spaces."""
        facets = self.mesh.boundary_facets()
        dofs = [np.unique(facets)]
        if self.element.name == "P2_tri":
            nv = self.mesh.num_vertices
            uniq_edges, _ = _edge_numbering(self.mesh.cells, _P2_EDGES, nv)
            fs = np.sort(facets, axis=1)
            on_b = np.nonzero(np.isin(uniq_edges[:, 0] * nv + uniq_edges[:, 1],
                                      fs[:, 0] * nv + fs[:, 1]))[0]
            dofs.append(nv + on_b)
        scalar = np.unique(np.concatenate(dofs))
        if predicate is not None:
            scalar = scalar[predicate(self.dof_points[scalar])]
        if self.value_size == 1:
            return scalar
        return (scalar[:, None] * self.value_size + np.arange(self.value_size)).ravel()


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def _grid_points(*axes) -> np.ndarray:
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def _grid_index(*sizes):
    """Flattened ``(i, j[, k])`` index arrays over a C-ordered grid (last
    axis fastest), the order of the reference's nested loops."""
    return [g.ravel() for g in np.meshgrid(*(np.arange(s) for s in sizes), indexing="ij")]


def rectangle_tri(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0) -> Mesh:
    """Structured crossed triangulation of [0,lx]x[0,ly]."""
    pts = _grid_points(np.linspace(0.0, lx, nx + 1), np.linspace(0.0, ly, ny + 1))
    i, j = _grid_index(nx, ny)
    v00 = i * (ny + 1) + j
    v10 = v00 + (ny + 1)
    v01, v11 = v00 + 1, v10 + 1
    even = ((i + j) % 2 == 0)[:, None]
    first = np.where(even, np.stack([v00, v10, v11], 1), np.stack([v00, v10, v01], 1))
    second = np.where(even, np.stack([v00, v11, v01], 1), np.stack([v10, v11, v01], 1))
    cells = np.stack([first, second], axis=1).reshape(-1, 3)
    return Mesh(pts, cells, "tri")


def unit_square_tri(n: int) -> Mesh:
    return rectangle_tri(n, n)


def rectangle_quad(nx: int, ny: int, lx: float, ly: float) -> Mesh:
    pts = _grid_points(np.linspace(0.0, lx, nx + 1), np.linspace(0.0, ly, ny + 1))
    i, j = _grid_index(nx, ny)
    v00 = i * (ny + 1) + j
    v10 = v00 + (ny + 1)
    return Mesh(pts, np.stack([v00, v10, v10 + 1, v00 + 1], axis=1), "quad")


_CUBE_TETS = np.array(
    # 6-tet (Kuhn) subdivision of the unit cube; corner c has offsets
    # (x, y, z) = (c & 1, (c >> 1) & 1, c >> 2)
    [
        [0, 1, 3, 7],
        [0, 1, 7, 5],
        [0, 5, 7, 4],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
    ]
)


def _box_tet(ni, nj, nk, keep=None, lx=1.0, ly=1.0, lz=1.0) -> Mesh:
    """``keep(i, j, k)`` takes index arrays and returns a boolean mask of
    the cubes to subdivide (``None`` keeps all)."""
    pts = _grid_points(np.linspace(0, lx, ni + 1), np.linspace(0, ly, nj + 1),
                       np.linspace(0, lz, nk + 1))
    i, j, k = _grid_index(ni, nj, nk)
    if keep is not None:
        mask = np.asarray(keep(i, j, k), dtype=bool)
        i, j, k = i[mask], j[mask], k[mask]

    def vid(a, b, c):
        return (a * (nj + 1) + b) * (nk + 1) + c

    corners = np.stack(
        [
            vid(i, j, k), vid(i + 1, j, k), vid(i, j + 1, k),
            vid(i + 1, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
            vid(i, j + 1, k + 1), vid(i + 1, j + 1, k + 1),
        ],
        axis=1,
    )
    cells = corners[:, _CUBE_TETS].reshape(-1, 4)
    # drop unused vertices (hollow meshes)
    used = np.unique(cells)
    remap = -np.ones(pts.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    return Mesh(pts[used], remap[cells], "tet")


def unit_cube_tet(n: int) -> Mesh:
    return _box_tet(n, n, n)


def box_hex(nx: int, ny: int, nz: int, lx: float = 1.0, ly: float = 1.0,
            lz: float = 1.0) -> Mesh:
    """Structured trilinear hexahedral box mesh (Q1_hex cells, corner order
    matching :data:`repro_torch.core.elements._HEX_CORNERS`)."""
    pts = _grid_points(np.linspace(0, lx, nx + 1), np.linspace(0, ly, ny + 1),
                       np.linspace(0, lz, nz + 1))
    i, j, k = _grid_index(nx, ny, nz)

    def vid(a, b, c):
        return (a * (ny + 1) + b) * (nz + 1) + c

    cells = np.stack(
        [
            vid(i, j, k), vid(i + 1, j, k),
            vid(i + 1, j + 1, k), vid(i, j + 1, k),
            vid(i, j, k + 1), vid(i + 1, j, k + 1),
            vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1),
        ],
        axis=1,
    )
    return Mesh(pts, cells, "hex")


def unit_cube_hex(n: int) -> Mesh:
    return box_hex(n, n, n)


def hollow_cube_tet(n: int) -> Mesh:
    """[0,1]^3 minus the open box (0.25, 0.75)^3 (paper SM B.1.1)."""
    lo = int(round(0.25 * n))
    hi = int(round(0.75 * n))

    def keep(i, j, k):
        def inside(a):
            return (lo <= a) & (a < hi)

        return ~(inside(i) & inside(j) & inside(k))

    return _box_tet(n, n, n, keep=keep)


def l_shape_tri(n: int) -> Mesh:
    """L-shaped domain [0,1]^2 minus (0.5,1)x(0.5,1)."""
    m = rectangle_tri(n, n)
    cx = m.points[m.cells].mean(axis=1)
    keep = ~((cx[:, 0] > 0.5) & (cx[:, 1] > 0.5))
    cells = m.cells[keep]
    used = np.unique(cells)
    remap = -np.ones(m.num_vertices, dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    return Mesh(m.points[used], remap[cells], "tri")


def disk_tri(n_r: int, center=(0.5, 0.5), radius: float = 0.5) -> Mesh:
    """Structured polar triangulation of a disk (paper's circular domain)."""
    pts = [np.array([center], dtype=np.float64)]
    starts = []
    n_pts = 1
    for r_i in range(1, n_r + 1):
        r = radius * r_i / n_r
        n_theta = 6 * r_i
        th = 2 * np.pi * np.arange(n_theta) / n_theta
        pts.append(np.stack([center[0] + r * np.cos(th), center[1] + r * np.sin(th)], axis=-1))
        starts.append(n_pts)
        n_pts += n_theta

    # innermost ring to the center
    t = np.arange(6)
    cells = [np.stack([np.zeros_like(t), starts[0] + t, starts[0] + (t + 1) % 6], axis=1)]
    # ring-to-ring strips, matching each outer vertex to the nearest inner one
    for ri in range(1, n_r):
        s0, n0 = starts[ri - 1], 6 * ri
        s1, n1 = starts[ri], 6 * (ri + 1)
        t = np.arange(n1)
        a1, b1 = s1 + t, s1 + (t + 1) % n1
        t0 = np.round(t * n0 / n1).astype(np.int64) % n0
        t0n = np.round((t + 1) * n0 / n1).astype(np.int64) % n0
        a0, b0 = s0 + t0, s0 + t0n
        pair = np.stack([np.stack([a0, a1, b1], 1), np.stack([a0, b1, b0], 1)], axis=1)
        valid = np.stack([np.ones(n1, dtype=bool), t0 != t0n], axis=1)
        cells.append(pair[valid])
    return Mesh(np.concatenate(pts), np.concatenate(cells), "tri")


def annulus_sector_tri(
    n_r: int, n_t: int, r0: float = 0.4, r1: float = 1.0, angle: float = 1.5 * np.pi
) -> Mesh:
    """Non-convex 'boomerang'-style domain: a 270° annulus sector."""
    rr = np.linspace(r0, r1, n_r + 1)
    tt = np.linspace(0.0, angle, n_t + 1)
    R, T = np.meshgrid(rr, tt, indexing="ij")
    pts = np.stack([R.ravel() * np.cos(T.ravel()), R.ravel() * np.sin(T.ravel())], -1)
    i, j = _grid_index(n_r, n_t)
    v00 = i * (n_t + 1) + j
    v10 = v00 + (n_t + 1)
    v01, v11 = v00 + 1, v10 + 1
    cells = np.stack([np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)],
                     axis=1).reshape(-1, 3)
    return Mesh(pts, cells, "tri")


def element_for_mesh(mesh: Mesh, degree: int = 1) -> ReferenceElement:
    if mesh.cell_type == "tri":
        return get_element("P1_tri" if degree == 1 else "P2_tri")
    if mesh.cell_type == "tet":
        return get_element("P1_tet")
    if mesh.cell_type == "quad":
        return get_element("Q1_quad")
    if mesh.cell_type == "hex":
        return get_element("Q1_hex")
    raise ValueError(mesh.cell_type)
