"""Torch port parity for the Sparse-Reduce's segment table (B2): the slot
list and row offsets the CUDA kernel reads against the JAX package's padded
table, the ordered plain sum against the JAX kernel and the plain version,
and the host's cut of the rows into the kernel's runs.  The ``cuda`` test
holds the kernel bit for bit against the ordered sum on a card."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.fem import ElasticityProblem as JElasticity  # noqa: E402
from repro.kernels.seg_reduce import build_padded_reduce as j_padded  # noqa: E402
from repro.kernels.seg_reduce import seg_reduce as j_seg_reduce  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch.fem import ElasticityProblem  # noqa: E402
from repro_torch.kernels import ReduceTable, seg_reduce  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.seg_reduce import reduce_runs, segment_table  # noqa: E402

# the kernel's stage (csrc/seg_reduce.cu: kThreads rows, kStage slots)
STAGE_ROWS, STAGE_SLOTS = 256, 2048
SOURCES = ["cube_tet4_matrix", "cube_tet4_vector", "disk_facets_matrix", "disk_facets_vector",
           "elasticity_tet3"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _space(pkg, mesh, value_size=1):
    el = (jc.mesh.element_for_mesh if pkg is jc else tc.element_for_mesh)(mesh)
    return pkg.FunctionSpace(mesh, el, value_size=value_size)


def _routings(source):
    """(JAX, port) routings of one Reduce table and the row each JAX padded
    row lands on in the port's table (the identity for matrix tables, the
    touched dofs for vector tables)."""
    if source == "elasticity_tet3":
        aj = JElasticity(jc.unit_cube_tet(3)).asm
        at = ElasticityProblem(tc.unit_cube_tet(3), device="cpu").asm
        return aj.mat_routing, at.mat_routing, "matrix"
    if source.startswith("cube_tet4"):
        aj = jc.GalerkinAssembler(_space(jc, jc.unit_cube_tet(4)))
        at = tc.GalerkinAssembler(_space(tc, tc.unit_cube_tet(4)), device="cpu")
    else:  # boundary facets of disk_tri(6)
        mj, mt = jc.disk_tri(6), tc.disk_tri(6)
        aj = jc.FacetAssembler(_space(jc, mj), mj.boundary_facets())
        at = tc.FacetAssembler(_space(tc, mt), mt.boundary_facets(), device="cpu")
    kind = source.rsplit("_", 1)[1]
    if kind == "matrix":
        return aj.mat_routing, at.mat_routing, kind
    return aj.vec_routing, at.vec_routing, kind


@pytest.mark.parametrize("source", SOURCES)
def test_segment_table_is_the_padded_table_without_sentinels(source):
    """Row by row, the segment table lists the JAX padded table's slots
    with the sentinels dropped and their order kept."""
    rj, rt, kind = _routings(source)
    if kind == "matrix":
        padded = j_padded(rj)
        slots, ptr = segment_table(rt.perm, rt.seg_ids, rt.nnz)
        rows = np.arange(rt.nnz)
    else:
        # the JAX builder over the touched dofs (its vector routing has no nnz)
        padded = j_padded(types.SimpleNamespace(perm=rj.perm, seg_ids=rj.seg_ids,
                                                nnz=rj.touched.shape[0]))
        slots, ptr = segment_table(rt.perm, rt.touched[rt.seg_ids], rt.num_dofs)
        rows = rt.touched
        assert (np.diff(rows) > 0).all()
    assert slots.dtype == np.int32 and ptr.dtype == np.int32
    assert ptr[0] == 0 and ptr[-1] == slots.shape[0] == rt.perm.shape[0]
    real = padded != rt.perm.shape[0]
    counts = np.zeros(ptr.shape[0] - 1, dtype=np.int64)
    counts[rows] = real.sum(axis=1)
    np.testing.assert_array_equal(np.diff(ptr), counts)
    np.testing.assert_array_equal(slots, padded[real])  # row-major: rows, then slot order


def test_segment_table_rejects_unsorted_or_out_of_range_rows():
    perm = np.arange(4)
    with pytest.raises(ValueError, match="non-decreasing"):
        segment_table(perm, np.array([0, 2, 1, 2]), 3)
    with pytest.raises(ValueError, match="non-decreasing"):
        segment_table(perm, np.array([0, 1, 2, 3]), 3)
    slots, ptr = segment_table(np.arange(0), np.arange(0), 2)
    assert slots.shape == (0,) and ptr.tolist() == [0, 0, 0]


def _ordered_sum_loop(src, slots, ptr):
    """One add at a time from the left, row by row, in numpy scalars."""
    out = np.zeros(ptr.shape[0] - 1, dtype=src.dtype)
    for n in range(out.shape[0]):
        acc = src.dtype.type(0)
        for k in range(ptr[n], ptr[n + 1]):
            acc = acc + src[slots[k]]
        out[n] = acc
    return out


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("kind", ["matrix", "vector"])
def test_ordered_ref_matches_jax_kernel_and_plain_version(kind, batch):
    """``seg_reduce_ordered_ref`` on the segment table against the JAX
    Pallas kernel (interpret mode) on the padded table and the plain
    version, 1e-12, instance by instance; and bit for bit against a
    sequential sum in slot order."""
    rj, rt, _ = _routings(f"cube_tet4_{kind}")
    if kind == "matrix":
        padded, (slots, ptr) = j_padded(rj), segment_table(rt.perm, rt.seg_ids, rt.nnz)
        table = ReduceTable.for_matrix(rt, "cpu")
    else:
        padded = j_padded(types.SimpleNamespace(perm=rj.perm, seg_ids=rj.seg_ids,
                                                nnz=rj.touched.shape[0]))
        slots, ptr = segment_table(rt.perm, rt.touched[rt.seg_ids], rt.num_dofs)
        table = ReduceTable.for_vector(rt, "cpu")
    rng = np.random.default_rng(19)
    src = rng.normal(size=(batch or 1, rt.perm.shape[0]))
    src_t = torch.as_tensor(src if batch else src[0])
    got = tref.seg_reduce_ordered_ref(src_t, torch.as_tensor(slots), torch.as_tensor(ptr),
                                      batch=batch is not None).reshape(batch or 1, -1).numpy()
    plain = tref.seg_reduce_ref(src_t, table.rows, table.n_rows, batch=batch is not None)
    np.testing.assert_allclose(got, plain.reshape(batch or 1, -1).numpy(), atol=1e-12, rtol=0)
    for b in range(batch or 1):
        want = np.asarray(j_seg_reduce(jnp.asarray(src[b]), padded, interpret=True,
                                       block_n=512))
        if kind == "vector":
            np.testing.assert_allclose(got[b][rt.touched], want, atol=1e-12, rtol=0)
            untouched = np.setdiff1d(np.arange(rt.num_dofs), rt.touched)
            assert (got[b][untouched] == 0).all()
        else:
            np.testing.assert_allclose(got[b], want, atol=1e-12, rtol=0)
        np.testing.assert_array_equal(got[b], _ordered_sum_loop(src[b], slots, ptr))


def _check_runs(runs, ptr, max_rows, max_slots):
    n_rows = ptr.shape[0] - 1
    assert runs.dtype == np.int32
    assert runs[0] == 0 and runs[-1] == n_rows
    assert (np.diff(runs) > 0).all()  # in order, every row in exactly one run
    ptr = ptr.astype(np.int64)
    rows, slots = np.diff(runs), ptr[runs[1:]] - ptr[runs[:-1]]
    assert (rows <= max_rows).all()
    # a run past the stage is one row, which the kernel sums from global memory
    assert ((slots <= max_slots) | (rows == 1)).all()
    # each run as long as the caps allow: one more row would pass one
    nxt = runs[1:-1]
    assert ((rows[:-1] == max_rows) | (ptr[nxt + 1] - ptr[runs[:-2]] > max_slots)).all()
    return slots


@pytest.mark.parametrize("max_rows,max_slots", [(STAGE_ROWS, STAGE_SLOTS), (4, 10), (1, 1)])
@pytest.mark.parametrize("layout", ["uniform", "empty_rows", "long_rows"])
def test_runs_cover_the_rows_in_order_within_the_stage(layout, max_rows, max_slots):
    rng = np.random.default_rng(len(layout) + max_rows)
    n_rows = 3_001
    counts = rng.integers(0, 30, size=n_rows)
    if layout == "empty_rows":
        counts[rng.uniform(size=n_rows) < 0.6] = 0
        counts[1_000:1_700] = 0
    elif layout == "long_rows":
        counts[[0, 17, 1_000, n_rows - 1]] = [1_000, STAGE_SLOTS, STAGE_SLOTS + 1, 4_133]
    ptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    slots = _check_runs(reduce_runs(ptr, max_rows, max_slots), ptr, max_rows, max_slots)
    assert (slots > max_slots).any() == bool((counts > max_slots).any())


def test_runs_of_empty_tables():
    assert reduce_runs(np.zeros(1, dtype=np.int32), STAGE_ROWS, STAGE_SLOTS).tolist() == [0]
    assert reduce_runs(np.zeros(600, dtype=np.int32), STAGE_ROWS,
                       STAGE_SLOTS).tolist() == [0, 256, 512, 599]


@pytest.mark.parametrize("source", SOURCES)
def test_repo_tables_fit_the_stage(source):
    """The repo's tables need no run past the kernel's stage."""
    _, rt, kind = _routings(source)
    if kind == "matrix":
        _, ptr = segment_table(rt.perm, rt.seg_ids, rt.nnz)
    else:
        _, ptr = segment_table(rt.perm, rt.touched[rt.seg_ids], rt.num_dofs)
    slots = _check_runs(reduce_runs(ptr, STAGE_ROWS, STAGE_SLOTS), ptr, STAGE_ROWS, STAGE_SLOTS)
    assert (slots <= STAGE_SLOTS).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("long", [0, 1_000, STAGE_SLOTS + 1, 4_133])
def test_cuda_kernel_is_bit_equal_to_ordered_ref(cuda, long, dtype):
    rng = np.random.default_rng(long)
    n = 1_003
    rows = rng.integers(0, 400, size=3_001)
    rows = rng.permutation(np.concatenate([rows, np.full(long, 200)]))
    perm = np.argsort(rows, kind="stable")
    table = ReduceTable(perm, rows[perm], rows, n, cuda)
    slots, ptr = segment_table(perm, rows[perm], n)
    slots, ptr = torch.as_tensor(slots, device=cuda), torch.as_tensor(ptr, device=cuda)
    for batch in (None, 1, 3):
        shape = rows.shape if batch is None else (batch, rows.shape[0])
        src = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
        got = seg_reduce(src, table, batch=batch is not None)
        want = tref.seg_reduce_ordered_ref(src, slots, ptr, batch=batch is not None)
        assert torch.equal(got, want)
