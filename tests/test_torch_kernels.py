"""Torch port parity: each kernel's plain PyTorch version against the JAX
Pallas kernel (interpret mode) and ``repro/kernels/ref.py``; the wrappers'
operand checks; and, on a CUDA machine, each CUDA kernel against its plain
version."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 on)
from repro.core import FunctionSpace as JSpace, GalerkinAssembler as JAsm  # noqa: E402
from repro.core import unit_cube_tet as j_cube, unit_square_tri as j_square  # noqa: E402
from repro.core.assembly import reduce_matrix as j_reduce_matrix  # noqa: E402
from repro.core.assembly import reduce_vector as j_reduce_vector  # noqa: E402
from repro.core.mesh import element_for_mesh as j_element  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.local_assembly import local_stiffness_p1 as j_local_stiffness  # noqa: E402
from repro.kernels.seg_reduce import build_padded_reduce as j_padded  # noqa: E402
from repro.kernels.seg_reduce import seg_reduce as j_seg_reduce  # noqa: E402
from repro.kernels.spmv_ell import galerkin_residual_ell as j_residual  # noqa: E402
from repro.kernels.spmv_ell import spmv_ell as j_spmv  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import routing as trouting  # noqa: E402
from repro_torch.core import mesh as tmesh  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    ReduceTable,
    galerkin_residual_ell,
    local_stiffness_p1,
    seg_reduce,
    spmv_ell,
)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.seg_reduce import padded_table  # noqa: E402

DTYPES = [(np.float32, torch.float32, 2e-4), (np.float64, torch.float64, 1e-12)]
SIZES = [1, 7, 129, 700]


def _simplices(rng, e, d, dtype):
    ident = np.concatenate([np.zeros((1, d)), np.eye(d)], axis=0)
    return (rng.normal(size=(e, 1, d)) + ident[None]
            + 0.15 * rng.normal(size=(e, d + 1, d))).astype(dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain versions vs the JAX kernels and oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("np_dt,t_dt,tol", DTYPES)
@pytest.mark.parametrize("e", SIZES)
@pytest.mark.parametrize("d", [2, 3])
def test_local_stiffness_matches_jax(d, e, np_dt, t_dt, tol):
    rng = np.random.default_rng(e * d)
    coords = _simplices(rng, e, d, np_dt)
    rho = rng.uniform(0.5, 2.0, size=e).astype(np_dt)
    got = local_stiffness_p1(torch.as_tensor(coords), torch.as_tensor(rho))
    assert got.dtype == t_dt and tuple(got.shape) == (e, d + 1, d + 1)
    wants = [jref.local_stiffness_p1_ref(jnp.asarray(coords), jnp.asarray(rho))]
    if e == 129:  # the interpret-mode Pallas kernel compiles per shape: one ragged size
        wants.append(j_local_stiffness(jnp.asarray(coords), jnp.asarray(rho), interpret=True))
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("np_dt,t_dt,tol", DTYPES)
@pytest.mark.parametrize("mesh_name,n", [("unit_square_tri", 8), ("unit_cube_tet", 3)])
def test_seg_reduce_matches_jax(mesh_name, n, np_dt, t_dt, tol):
    jm = {"unit_square_tri": j_square, "unit_cube_tet": j_cube}[mesh_name](n)
    tm = getattr(tmesh, mesh_name)(n)
    jasm = JAsm(JSpace(jm, j_element(jm)))
    tspace = tmesh.FunctionSpace(tm, tmesh.element_for_mesh(tm))
    rt = trouting.build_matrix_routing(tspace.cell_dofs, None, tspace.num_dofs)
    k = tspace.local_dofs
    k_local = np.random.default_rng(n).normal(size=(tm.num_cells, k, k)).astype(np_dt)
    got = seg_reduce(torch.as_tensor(k_local), ReduceTable.for_matrix(rt, "cpu"))
    assert got.dtype == t_dt
    want_kernel = j_seg_reduce(jnp.asarray(k_local), j_padded(jasm.mat_routing),
                               interpret=True, block_n=512)
    want_ref = j_reduce_matrix(jnp.asarray(k_local), jasm.mat_routing)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)

    vt = trouting.build_vector_routing(tspace.cell_dofs, tspace.num_dofs)
    f_local = k_local[:, 0, :]
    got_v = seg_reduce(torch.as_tensor(np.ascontiguousarray(f_local)),
                       ReduceTable.for_vector(vt, "cpu"))
    want_v = j_reduce_vector(jnp.asarray(f_local), jasm.vec_routing)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=tol, rtol=tol)


@pytest.mark.parametrize("rows", SIZES)
def test_padded_table_gather_equals_plain_reduce(rows):
    """The padded table (the JAX kernel's layout) gives the sums of the
    plain version: out[n] = Σ_l src[idx[n, l]] over non-sentinel slots."""
    rng = np.random.default_rng(rows)
    row_of_slot = rng.integers(0, rows, size=3 * rows + 2)
    perm = np.argsort(row_of_slot, kind="stable")
    idx = padded_table(perm, row_of_slot[perm], rows)
    src = torch.as_tensor(rng.normal(size=row_of_slot.shape[0]), dtype=torch.float64)
    ext = torch.cat([src, src.new_zeros(1)])
    gathered = ext[torch.as_tensor(idx).long()].sum(dim=1)
    table = ReduceTable(perm, row_of_slot[perm], row_of_slot, rows, "cpu")
    np.testing.assert_allclose(gathered.numpy(), seg_reduce(src, table).numpy(), atol=1e-12)
    assert (idx <= row_of_slot.shape[0]).all() and idx.dtype == np.int32


@pytest.mark.parametrize("np_dt,t_dt,tol", DTYPES)
# widths past 32: the vector P1 tetrahedron (45) and Q1 hexahedron (81)
# stencils, and each side of the kernel's hand-overs in either dtype
@pytest.mark.parametrize("n,width", [(1, 1), (7, 5), (129, 15), (700, 9), (97, 33), (129, 45),
                                     (65, 81), (33, 48), (40, 64), (31, 85), (45, 86), (17, 128),
                                     (9, 129), (50, 201)])
def test_spmv_and_residual_match_jax(n, width, np_dt, t_dt, tol):
    rng = np.random.default_rng(n + width)
    vals = rng.normal(size=(n, width)).astype(np_dt)
    cols = rng.integers(0, n, size=(n, width)).astype(np.int32)
    x = rng.normal(size=n).astype(np_dt)
    f = rng.normal(size=n).astype(np_dt)
    tv, tc, tx, tf = map(torch.as_tensor, (vals, cols, x, f))
    got = spmv_ell(tv, tc, tx)
    got_r = galerkin_residual_ell(tv, tc, tx, tf)
    assert got.dtype == t_dt and got_r.dtype == t_dt
    jv, jc, jx, jf = map(jnp.asarray, (vals, cols, x, f))
    for want in (j_spmv(jv, jc, jx, interpret=True), jref.spmv_ell_ref(jv, jc, jx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    for want in (j_residual(jv, cols, jx, jf, interpret=True),
                 jref.galerkin_residual_ell_ref(jv, jc, jx, jf)):
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("n,width,seed", [(2, 1, 0), (97, 3, 1), (256, 6, 2), (400, 4, 3),
                                          (97, 45, 4), (65, 81, 5), (33, 86, 6), (40, 128, 7),
                                          (20, 201, 8)])
def test_ell_padding_invariant(n, width, seed):
    """Zero-valued slots add nothing whatever valid column they name, so
    self-referencing padded columns never alias real entries."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, width))
    cols = np.sort(rng.integers(0, n, size=(n, width)))
    mask = rng.uniform(size=(n, width)) < 0.4
    vals_z = torch.as_tensor(np.where(mask, 0.0, vals))
    cols_alias = np.where(mask, np.repeat(np.arange(n)[:, None], width, axis=1), cols)
    x = torch.as_tensor(rng.normal(size=n))
    f = torch.as_tensor(rng.normal(size=n))
    want = tref.spmv_ell_ref(vals_z, torch.as_tensor(cols), x)
    cols_alias = torch.as_tensor(cols_alias, dtype=torch.int32)
    np.testing.assert_allclose(spmv_ell(vals_z, cols_alias, x).numpy(), want.numpy(), atol=1e-12)
    np.testing.assert_allclose(galerkin_residual_ell(vals_z, cols_alias, x, f).numpy(),
                               (want - f).numpy(), atol=1e-12)


# ---------------------------------------------------------------------------
# the wrappers check their operands and never fall back off the CPU
# ---------------------------------------------------------------------------

def test_wrappers_reject_bad_operands():
    v = torch.zeros((4, 3), dtype=torch.float64)
    x = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(TypeError):
        spmv_ell(v, torch.zeros((4, 3), dtype=torch.int64), x)
    with pytest.raises(ValueError):
        spmv_ell(v, torch.zeros((4, 2), dtype=torch.int32), x)
    with pytest.raises(ValueError):
        galerkin_residual_ell(v, torch.zeros((4, 3), dtype=torch.int32), x, x[:3])
    with pytest.raises(ValueError):
        local_stiffness_p1(torch.zeros((5, 3, 3), dtype=torch.float64),
                           torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError):
        local_stiffness_p1(torch.zeros((5, 4, 3), dtype=torch.float64),
                           torch.zeros(4, dtype=torch.float64))
    table = ReduceTable(np.arange(6), np.array([0, 0, 1, 1, 2, 2]),
                        np.array([0, 0, 1, 1, 2, 2]), 3, "cpu")
    with pytest.raises(ValueError):
        seg_reduce(torch.zeros(5, dtype=torch.float64), table)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU goes to the kernel path, which validates it and
    raises here — it is never silently computed by the plain version."""
    meta = torch.device("meta")
    v = torch.zeros((4, 3), dtype=torch.float64, device=meta)
    c = torch.zeros((4, 3), dtype=torch.int32, device=meta)
    x = torch.zeros(4, dtype=torch.float64, device=meta)
    before = dict(kernels.LAUNCHES)
    for call in (lambda: spmv_ell(v, c, x), lambda: galerkin_residual_ell(v, c, x, x),
                 lambda: local_stiffness_p1(torch.zeros((4, 3, 2), dtype=torch.float64,
                                                        device=meta), x)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    with pytest.raises(ValueError, match="CUDA device"):
        spmv_ell(torch.zeros((4, 3), dtype=torch.float64),
                 torch.zeros((4, 3), dtype=torch.int32), x)
    assert kernels.LAUNCHES == before


def test_plain_versions_do_not_count_launches():
    kernels.reset_launches()
    spmv_ell(torch.zeros((3, 2), dtype=torch.float64), torch.zeros((3, 2), dtype=torch.int32),
             torch.zeros(3, dtype=torch.float64))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (run on a CUDA machine)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("np_dt,t_dt,tol", DTYPES)
@pytest.mark.parametrize("e", SIZES)
def test_cuda_kernels_match_plain(cuda, e, np_dt, t_dt, tol):
    rng = np.random.default_rng(e)
    kernels.reset_launches()
    for d in (2, 3):
        coords = torch.as_tensor(_simplices(rng, e, d, np_dt), device=cuda)
        rho = torch.as_tensor(rng.uniform(0.5, 2.0, e).astype(np_dt), device=cuda)
        want = tref.local_stiffness_p1_ref(coords, rho)
        got = local_stiffness_p1(coords, rho)
        torch.testing.assert_close(got, want, atol=tol * max(1.0, float(want.abs().max())),
                                   rtol=0)
    rows = rng.integers(0, e, size=3 * e + 1)
    perm = np.argsort(rows, kind="stable")
    table = ReduceTable(perm, rows[perm], rows, e, cuda)
    src = torch.as_tensor(rng.normal(size=rows.shape[0]).astype(np_dt), device=cuda)
    torch.testing.assert_close(seg_reduce(src, table), tref.seg_reduce_ref(src, table.rows, e),
                               atol=tol * 10, rtol=tol)
    for width in (1, 15, 40):
        vals = torch.as_tensor(rng.normal(size=(e, width)).astype(np_dt), device=cuda)
        cols = torch.as_tensor(rng.integers(0, e, size=(e, width)), dtype=torch.int32,
                               device=cuda)
        x = torch.as_tensor(rng.normal(size=e).astype(np_dt), device=cuda)
        want = tref.spmv_ell_ref(vals, cols, x)
        torch.testing.assert_close(spmv_ell(vals, cols, x), want, atol=tol * 10, rtol=tol)
        torch.testing.assert_close(galerkin_residual_ell(vals, cols, x, x), want - x,
                                   atol=tol * 10, rtol=tol)
    assert kernels.LAUNCHES == {"local_stiffness_p1": 2, "seg_reduce": 1, "spmv_ell": 3,
                                "galerkin_residual_ell": 3, "spmv_ell_stream": 0,
                                "galerkin_residual_ell_stream": 0}
