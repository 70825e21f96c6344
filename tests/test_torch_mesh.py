"""Torch port parity: meshes, function spaces, routing and the vectorised
host builders (reduce table, ELL layout) against the JAX package."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 on)
from repro.core import mesh as jmesh  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core.sparse import CSR as JCSR  # noqa: E402
from repro.core.sparse import ell_layout as jax_ell_layout  # noqa: E402
from repro.kernels.seg_reduce import build_padded_reduce as jax_build_padded_reduce  # noqa: E402

from repro_torch.core import mesh as tmesh  # noqa: E402
from repro_torch.core import routing as trouting  # noqa: E402
from repro_torch.kernels.seg_reduce import (  # noqa: E402
    ReduceTable,
    build_padded_reduce,
    padded_table,
)

MESHES = [
    ("unit_square_tri", (8,)),
    ("rectangle_tri", (5, 3, 2.0, 1.0)),
    ("unit_cube_tet", (4,)),
    ("disk_tri", (4,)),
    ("rectangle_quad", (3, 2, 1.0, 2.0)),
    ("box_hex", (2, 3, 2)),
    ("hollow_cube_tet", (4,)),
    ("l_shape_tri", (6,)),
    ("annulus_sector_tri", (3, 5)),
]

SPACES = [  # (generator, args, degree)
    ("unit_square_tri", (8,), 1),
    ("unit_square_tri", (4,), 2),
    ("unit_cube_tet", (4,), 1),
    ("disk_tri", (4,), 1),
    ("disk_tri", (3,), 2),
    ("rectangle_quad", (3, 2, 1.0, 2.0), 1),
    ("box_hex", (2, 2, 2), 1),
]


def _pair(name, args):
    return getattr(jmesh, name)(*args), getattr(tmesh, name)(*args)


def _spaces(name, args, degree, value_size=1):
    mj, mt = _pair(name, args)
    sj = jmesh.FunctionSpace(mj, jmesh.element_for_mesh(mj, degree), value_size)
    st = tmesh.FunctionSpace(mt, tmesh.element_for_mesh(mt, degree), value_size)
    return sj, st


@pytest.mark.parametrize("name,args", MESHES)
def test_generator_matches_jax(name, args):
    mj, mt = _pair(name, args)
    np.testing.assert_array_equal(mt.points, mj.points)
    np.testing.assert_array_equal(mt.cells, mj.cells)
    assert mt.cells.dtype == np.int64 and mt.cell_type == mj.cell_type
    np.testing.assert_array_equal(mt.boundary_facets(), mj.boundary_facets())
    np.testing.assert_allclose(mt.cell_volumes(), mj.cell_volumes(), rtol=0, atol=0)


def test_boundary_facets_without_int_keys(monkeypatch):
    """The np.unique(axis=0) fallback (keys that would overflow int64)
    gives the same facets as the int64-key path."""
    mj, mt = _pair("box_hex", (3, 2, 2))
    monkeypatch.setattr(tmesh, "_row_keys", lambda rows, base: None)
    np.testing.assert_array_equal(mt.boundary_facets(), mj.boundary_facets())
    sj, st = _spaces("unit_square_tri", (4,), 2)
    np.testing.assert_array_equal(st.cell_dofs, sj.cell_dofs)
    np.testing.assert_array_equal(st.boundary_dofs(), sj.boundary_dofs())


@pytest.mark.parametrize("name,args,degree", SPACES)
def test_function_space_matches_jax(name, args, degree):
    sj, st = _spaces(name, args, degree)
    assert st.num_dofs == sj.num_dofs and st.local_dofs == sj.local_dofs
    np.testing.assert_array_equal(st.cell_dofs, sj.cell_dofs)
    np.testing.assert_array_equal(st.dof_points, sj.dof_points)
    np.testing.assert_array_equal(st.boundary_dofs(), sj.boundary_dofs())

    def pred(x):
        return x[:, 0] < 0.5

    np.testing.assert_array_equal(st.boundary_dofs(pred), sj.boundary_dofs(pred))


def test_vector_space_matches_jax():
    sj, st = _spaces("unit_square_tri", (4,), 1, value_size=2)
    np.testing.assert_array_equal(st.cell_dofs, sj.cell_dofs)
    np.testing.assert_array_equal(st.boundary_dofs(), sj.boundary_dofs())


@pytest.mark.parametrize("name,args,degree", SPACES)
def test_routing_matches_jax(name, args, degree):
    sj, st = _spaces(name, args, degree)
    rj = jrouting.build_matrix_routing(sj.cell_dofs, None, sj.num_dofs)
    rt = trouting.build_matrix_routing(st.cell_dofs, None, st.num_dofs)
    assert rt.nnz == rj.nnz and rt.num_dofs == rj.num_dofs
    for field in ("indptr", "indices", "perm", "seg_ids", "seg_ids_unsorted",
                  "row_of_nnz", "diag_pos"):
        np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field), err_msg=field)
    vj = jrouting.build_vector_routing(sj.cell_dofs, sj.num_dofs)
    vt = trouting.build_vector_routing(st.cell_dofs, st.num_dofs)
    for field in ("perm", "seg_ids", "seg_ids_unsorted", "touched"):
        np.testing.assert_array_equal(getattr(vt, field), getattr(vj, field), err_msg=field)


@pytest.mark.parametrize("name,args,degree", SPACES[:4])
def test_padded_reduce_matches_jax_loop(name, args, degree):
    sj, st = _spaces(name, args, degree)
    rj = jrouting.build_matrix_routing(sj.cell_dofs, None, sj.num_dofs)
    rt = trouting.build_matrix_routing(st.cell_dofs, None, st.num_dofs)
    got = build_padded_reduce(rt)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_build_padded_reduce(rj))


def test_vector_reduce_table_rows():
    """The vector table is laid out over global dofs: row n lists the local
    slots of dof n, so its gather-sum equals the routing's scatter."""
    _, st = _spaces("disk_tri", (3,), 2)
    vt = trouting.build_vector_routing(st.cell_dofs, st.num_dofs)
    table = ReduceTable.for_vector(vt, "cpu")
    idx = padded_table(vt.perm, vt.touched[vt.seg_ids], st.num_dofs)
    src = torch.as_tensor(np.random.default_rng(0).normal(size=vt.perm.shape[0]),
                          dtype=torch.float64)
    gathered = torch.cat([src, src.new_zeros(1)])[torch.as_tensor(idx).long()].sum(1)
    want = np.zeros(st.num_dofs)
    np.add.at(want, st.cell_dofs.ravel(), src.numpy())
    np.testing.assert_allclose(gathered.numpy(), want, atol=1e-13)
    np.testing.assert_array_equal(table.rows.numpy(), st.cell_dofs.ravel())


@pytest.mark.parametrize("name,args,degree", SPACES)
def test_ell_layout_matches_jax(name, args, degree):
    sj, st = _spaces(name, args, degree)
    rj = jrouting.build_matrix_routing(sj.cell_dofs, None, sj.num_dofs)
    rt = trouting.build_matrix_routing(st.cell_dofs, None, st.num_dofs)
    jcsr = JCSR(jnp.zeros(rj.nnz), rj.indptr, rj.indices, rj.row_of_nnz,
                (rj.num_dofs, rj.num_dofs), rj.diag_pos)
    cols_j, pos_j, l_j = jax_ell_layout(jcsr)
    cols_t, pos_t, l_t = rt.pattern.ell_layout()
    assert l_t == l_j and cols_t.dtype == np.int32
    np.testing.assert_array_equal(cols_t, cols_j)
    np.testing.assert_array_equal(pos_t, pos_j)
    # padded slots point back at their own row
    pad = np.ones(cols_t.shape, dtype=bool)
    pad.reshape(-1)[pos_t] = False
    rows = np.broadcast_to(np.arange(cols_t.shape[0])[:, None], cols_t.shape)
    np.testing.assert_array_equal(cols_t[pad], rows[pad])
