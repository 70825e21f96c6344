"""Torch port parity for the streaming ELL SpMV (B5) and fused residual
(B6): the plan against the JAX ``_StreamPlan``, the plain versions against
the Pallas kernels (interpret mode), a numpy replay of the CUDA kernel's
schedule (CTA runs, x-ring, window slides and reloads), the shared-memory
footprint and feasibility check, the autotune hook, the ``ell_stream``
solve, and, on a CUDA machine, each CUDA kernel against its plain
version."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402  (x64 on)
from repro.fem import PoissonProblem as JPoisson  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.spmv_ell import _StreamPlan as JStreamPlan  # noqa: E402
from repro.kernels.spmv_ell import galerkin_residual_ell_stream as j_residual_stream  # noqa: E402
from repro.kernels.spmv_ell import spmv_ell_stream as j_spmv_stream  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import kernels, telemetry  # noqa: E402
from repro_torch.fem import AdvectionDiffusionProblem, PoissonProblem  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    StreamPlan,
    StreamPlans,
    autotune_ell_stream,
    autotune_stream,
    check_stream_fits,
    ell_matvec_stream,
    ell_residual_stream,
    galerkin_residual_ell_stream,
    spmv_ell_stream,
    stream_runs,
    stream_smem_bytes,
)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.spmv_ell import MAX_BUFFERS, N_BUFFERS, TILE_ROWS  # noqa: E402

# the JAX package's streaming sweep (tests/test_kernels.py): N ragged against
# block_n, L = 1, N < block_n, an exact multiple, one block plus one row
SWEEP = [(1000, 7, 256), (300, 1, 128), (100, 5, 4096), (4096, 9, 1024), (129, 3, 128)]
H100_SMEM_OPTIN = 232_448  # bytes a block may opt in to on an H100


def _fem_cols(mesh_fn, n):
    m = mesh_fn(n)
    k = tc.GalerkinAssembler(tc.FunctionSpace(m, tc.element_for_mesh(m)), device="cpu") \
        .assemble(tc.weakform.diffusion())
    return k, k.pattern.ell_layout()[0]


def _sweep_inputs(n, l, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, l))
    cols = np.sort(rng.integers(0, n, size=(n, l)))  # FEM-like locality
    return vals, cols.astype(np.int32), rng.normal(size=n), rng.normal(size=n)


@pytest.mark.parametrize("n,l,block_n", SWEEP + [("fem", None, 128), ("fem", None, 256)])
def test_stream_plan_equals_jax(n, l, block_n):
    if n == "fem":
        _, cols = _fem_cols(tc.unit_square_tri, 15)
    else:
        cols = _sweep_inputs(n, l, n + l)[1]
    got, want = StreamPlan(cols, block_n), JStreamPlan(cols, block_n)
    np.testing.assert_array_equal(got.cols_local, want.cols_local)
    np.testing.assert_array_equal(got.starts, want.starts)
    assert (got.window, got.x_len, got.n_pad) == (want.window, want.x_len, want.n_pad)
    assert got.cols_local.dtype == np.int32 and got.starts.dtype == np.int32
    assert got.cols_local.min() >= 0 and got.cols_local.max() < got.window
    assert got.n_blocks * block_n == got.n_pad


@pytest.mark.parametrize("n,l,block_n", SWEEP)
@pytest.mark.parametrize("nbuf", [2, 3])
def test_stream_kernels_match_jax(n, l, block_n, nbuf):
    vals, cols, x, f = _sweep_inputs(n, l, n + l + nbuf)
    tv, tx, tf = map(torch.as_tensor, (vals, x, f))
    got = spmv_ell_stream(tv, cols, tx, block_n=block_n, nbuf=nbuf)
    got_r = galerkin_residual_ell_stream(tv, cols, tx, tf, block_n=block_n, nbuf=nbuf)
    jv, jx, jf = map(jnp.asarray, (vals, x, f))
    wants = [jref.spmv_ell_ref(jv, jnp.asarray(cols), jx)]
    wants_r = [jref.galerkin_residual_ell_ref(jv, jnp.asarray(cols), jx, jf)]
    if n <= 1000:  # the interpret-mode Pallas kernel is slow: small sizes only
        wants.append(j_spmv_stream(jv, cols, jx, interpret=True, block_n=block_n, nbuf=nbuf))
        wants_r.append(j_residual_stream(jv, cols, jx, jf, interpret=True, block_n=block_n,
                                         nbuf=nbuf))
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
    for want in wants_r:
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want), atol=1e-12, rtol=0)


@pytest.mark.parametrize("n,l,seed", [(2, 1, 0), (97, 3, 1), (256, 6, 2), (400, 4, 3)])
def test_stream_padding_invariant(n, l, seed):
    """Zero-valued slots add nothing whatever valid column they name: with
    their columns retargeted at the own row (the ELL padding) the streaming
    kernels still give the sums of the original table."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, l))
    cols = np.sort(rng.integers(0, n, size=(n, l)))
    mask = rng.uniform(size=(n, l)) < 0.4
    vals_z = np.where(mask, 0.0, vals)
    cols_alias = np.where(mask, np.repeat(np.arange(n)[:, None], l, axis=1), cols)
    x, f = rng.normal(size=n), rng.normal(size=n)
    want = np.asarray(jref.spmv_ell_ref(jnp.asarray(vals_z), jnp.asarray(cols), jnp.asarray(x)))
    want_j = np.asarray(j_spmv_stream(jnp.asarray(vals_z), cols_alias, jnp.asarray(x),
                                      interpret=True, block_n=128))
    tv, tx, tf = map(torch.as_tensor, (vals_z, x, f))
    got = spmv_ell_stream(tv, cols_alias, tx, block_n=128)
    got_r = galerkin_residual_ell_stream(tv, cols_alias, tx, tf, block_n=128)
    for w in (want, want_j):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-12, rtol=0)
        np.testing.assert_allclose(got_r.numpy(), w - f, atol=1e-12, rtol=0)


def test_plain_version_walks_the_plan():
    """The plain version gathers through starts + cols_local: a wrong window
    start changes y (it does not just index x by the original columns)."""
    vals, cols, x, _ = _sweep_inputs(1000, 7, 9)
    plan = StreamPlan(cols, 256)
    cols_local, starts = plan.staged("cpu")
    tv, tx = torch.as_tensor(vals), torch.as_tensor(x)
    good = tref.spmv_ell_stream_ref(tv, cols_local, starts, tx, 256, plan.x_len)
    np.testing.assert_allclose(good.numpy(), (vals * x[cols]).sum(1), atol=1e-12)
    shifted = starts.clone()
    shifted[1] += 1
    bad = tref.spmv_ell_stream_ref(tv, cols_local, shifted, tx, 256, plan.x_len)
    assert not torch.allclose(bad[256:512], good[256:512])
    torch.testing.assert_close(bad[:256], good[:256])


def test_stream_smem_bytes_independent_of_n():
    """The footprint of a block does not scale with N: banded tables of 10k
    and 200k rows give one window and one ring, hence one footprint, which
    is the kernel's layout: the ring, nbuf stages of TILE_ROWS rows of vals,
    cols and f (16 bytes of landing room each), and nbuf + 4 mbarriers."""
    band = 300
    footprints = set()
    for n in (10_000, 200_000):
        rows = np.arange(n)[:, None]
        cols = np.clip(rows + np.array([-band, -1, 0, 1, band]), 0, n - 1).astype(np.int32)
        plan = StreamPlan(cols, 1024)
        footprints.add((plan.window, plan.ring, plan.smem_bytes(2, 8)))
    assert len(footprints) == 1
    (window, ring, _), = footprints
    assert ring == window + 1024  # the band advances block_n columns a block
    for nbuf, itemsize in ((2, 8), (5, 4)):
        stage = (128 * 7 * itemsize + 16) + (128 * 7 * 4 + 16) + (128 * itemsize + 16)
        assert stream_smem_bytes(7, 2048, nbuf=nbuf, itemsize=itemsize) == \
            2048 * itemsize + nbuf * stage + 8 * (nbuf + 4)


def test_stream_constants_match_the_kernel():
    """The tile rows and the deepest ring the footprint formula assumes are
    the ones the CUDA source allocates and accepts."""
    src = (Path(kernels.__file__).parent / "csrc" / "spmv_ell_stream.cu").read_text()
    assert int(re.search(r"kTileRows = (\d+);", src).group(1)) == TILE_ROWS == 128
    assert int(re.search(r"kMaxBuffers = (\d+);", src).group(1)) == MAX_BUFFERS
    need = re.search(r"size_t smem_need\(.*?\n}", src, re.S).group(0)
    assert "(item + sizeof(int))" in need and "kTileRows * item + 48" in need
    assert "8 * (nbuf + 4)" in need


@pytest.mark.parametrize("n_tiles,n_ctas", [(1, 1), (7, 7), (4291, 132), (14261, 132),
                                            (1250, 396), (100, 3)])
def test_stream_runs_balanced(n_tiles, n_ctas):
    """CTA runs cover the tiles in order, each once, and differ by at most
    one tile (no wave tail)."""
    runs = stream_runs(n_tiles, n_ctas)
    assert runs.dtype == np.int32 and runs.shape == (n_ctas + 1,)
    assert runs[0] == 0 and runs[-1] == n_tiles
    sizes = np.diff(runs)
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1


def _band_cols(n, centre, half=40):
    offs = np.array([-3, -1, 0, 1, 2, half // 2, half])
    return np.clip(centre[:, None] + offs[None, :], 0, n - 1).astype(np.int32)


def _schedule_plan(kind):
    """(plan, check of the path it takes) for each replay input."""
    if kind == "decreasing":  # a band's rows in reverse: starts go down
        r = np.arange(3000)
        return StreamPlan(_band_cols(3000, 2999 - r), 256), lambda p: (p.load_lo[1:] < 0).all()
    if kind == "past_ring":  # a slow band that jumps 3N/4 ahead half way
        r = np.arange(3000)
        centre = np.where(r < 1536, r // 4, 3000 - (3000 - r) // 4)
        plan = StreamPlan(_band_cols(3000, centre), 256)
        return plan, lambda p: (p.load_lo[1:] < 0).sum() == 1 and (p.load_lo[1:] >= 0).sum() > 1
    if kind[0] == "fem":
        _, cols = _fem_cols(getattr(tc, kind[1]), kind[2])
        return StreamPlan(cols, kind[3]), lambda p: True
    n, l, block_n = kind
    return StreamPlan(_sweep_inputs(n, l, n + l)[1], block_n), lambda p: True


def _replay(plan, n_ctas, x, shift):
    """The CUDA kernel's walk in numpy: per CTA run, a ring of plan.ring
    slots (position p in slot (p + shift) % R), whole-window loads at the
    start of a run and where load_lo < 0, slides otherwise, each copy
    stopping at N; returns the x value each (row, slot) gathers, and checks
    that a slide never writes a slot the previous block still reads and
    that every row is summed once."""
    n, width, bn, w, ring_len = plan.n_rows, plan.width, plan.block_n, plan.window, plan.ring
    tpb = plan.tiles_per_block
    runs = stream_runs(plan.n_tiles, n_ctas)
    got = np.full((n, width), np.nan)
    summed = np.zeros(n, dtype=np.int64)
    for c in range(n_ctas):
        ring = np.full(ring_len, np.nan)
        held = np.full(ring_len, -1, dtype=np.int64)  # position in each slot
        prev = None
        for k in range(runs[c], runs[c + 1]):
            b, j = divmod(k, tpb)
            row0 = b * bn + j * TILE_ROWS
            rows = min(TILE_ROWS, bn - j * TILE_ROWS, n - row0)
            if b != prev:
                start = int(plan.starts[b])
                slide = prev is not None and plan.load_lo[b] >= 0
                if slide:
                    assert b == prev + 1
                lo = int(plan.load_lo[b]) if slide else start
                pos = np.arange(lo, min(start + w, n))
                slots = (pos + shift) % ring_len
                assert len(pos) <= ring_len
                if slide:
                    live = (np.arange(plan.starts[prev], plan.starts[prev] + w) + shift) % ring_len
                    assert not np.isin(slots, live).any()
                ring[slots] = x[pos]
                held[slots] = pos
                base, prev = (start + shift) % ring_len, b
            local = plan.cols_local[row0:row0 + rows].astype(np.int64)
            slot = base + local
            slot = np.where(slot >= ring_len, slot - ring_len, slot)
            np.testing.assert_array_equal(held[slot], start + local)
            got[row0:row0 + rows] = ring[slot]
            summed[row0:row0 + rows] += 1
    np.testing.assert_array_equal(summed, 1)
    return got


REPLAY_PLANS = SWEEP + [("fem", "unit_square_tri", 15, 128), ("fem", "unit_square_tri", 15, 256),
                        ("fem", "unit_cube_tet", 4, 128), ("fem", "unit_cube_tet", 4, 256),
                        "decreasing", "past_ring"]


@pytest.mark.parametrize("kind", REPLAY_PLANS, ids=str)
@pytest.mark.parametrize("n_ctas", [1, 5, 132])
def test_stream_schedule_replay_gathers_the_plain_values(kind, n_ctas):
    """Every gather of the kernel's schedule reads the x value that
    spmv_ell_stream_ref gathers, whatever the CTA count and x's alignment."""
    plan, takes_path = _schedule_plan(kind)
    assert takes_path(plan)
    assert plan.ring >= plan.window and plan.ring % 128 == 0
    x = np.random.default_rng(plan.n_rows).normal(size=plan.n_rows)
    n_ctas = min(n_ctas, plan.n_tiles)
    x_pad = np.concatenate([x, np.zeros(plan.x_len - plan.n_rows)])
    row_start = np.repeat(plan.starts.astype(np.int64), plan.block_n)[:plan.n_rows, None]
    want = x_pad[row_start + plan.cols_local[:plan.n_rows]]
    for shift in (0, 1, 3):
        np.testing.assert_array_equal(_replay(plan, n_ctas, x, shift), want)
    vals = np.random.default_rng(1).normal(size=want.shape)
    ref = tref.spmv_ell_stream_ref(torch.as_tensor(vals), *plan.staged("cpu"),
                                   torch.as_tensor(x), plan.block_n, plan.x_len)
    np.testing.assert_allclose((vals * want).sum(1), ref.numpy(), rtol=0, atol=1e-12)



def test_infeasible_plan_raises_before_launch():
    """A block whose columns reach 30k rows ahead needs a float64 window of
    over 240 KB, more than an H100 block may hold; the check raises and
    names W, block_n, nbuf and the limit.  In float32 the plan fits."""
    cols = np.repeat(np.arange(40_000, dtype=np.int32)[:, None], 3, axis=1)
    cols[::1024, 0] = np.minimum(np.arange(0, 40_000, 1024) + 30_000, 39_999)
    plan = StreamPlan(cols, 1024)
    assert plan.window >= 30_000
    with pytest.raises(ValueError, match=r"W=\d+, block_n=1024, nbuf=2.*allows 232448"):
        check_stream_fits(plan, 2, 8, H100_SMEM_OPTIN)
    assert check_stream_fits(plan, 1, 4, H100_SMEM_OPTIN) == plan.smem_bytes(1, 4)
    # the default depth is the deepest up to N_BUFFERS that fits, down to 1
    # (which then raises)
    assert plan.depth(4, H100_SMEM_OPTIN) == N_BUFFERS
    assert plan.depth(8, H100_SMEM_OPTIN) == 1
    limit = plan.smem_bytes(2, 4)
    assert plan.depth(4, limit) == 2 and plan.depth(4, limit - 1) == 1


def test_stream_wrappers_reject_bad_operands():
    vals, cols, x, f = _sweep_inputs(50, 3, 0)
    tv, tx = torch.as_tensor(vals), torch.as_tensor(x)
    for nbuf in (0, MAX_BUFFERS + 1, 2.0):
        with pytest.raises(ValueError, match="nbuf"):
            spmv_ell_stream(tv, cols, tx, nbuf=nbuf)
    with pytest.raises(ValueError):
        spmv_ell_stream(tv, cols[:, :2], tx)
    with pytest.raises(ValueError):
        galerkin_residual_ell_stream(tv, cols, tx, tx[:10])
    with pytest.raises(ValueError, match="block_n"):
        spmv_ell_stream(tv, StreamPlan(cols, 128), tx, block_n=256)
    meta = torch.device("meta")
    with pytest.raises(TypeError, match="host precompute"):
        spmv_ell_stream(tv, torch.zeros((50, 3), dtype=torch.int32, device=meta), tx)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        spmv_ell_stream(tv.to(meta), cols, tx.to(meta))
    with pytest.raises(ValueError, match="CUDA device"):
        galerkin_residual_ell_stream(tv, cols, tx.to(meta), tx)
    assert kernels.LAUNCHES == before


def test_autotune_returns_a_candidate_and_caches_it():
    k, _ = _fem_cols(tc.unit_square_tri, 20)
    ell = tc.csr_to_ell(k)
    x = torch.as_tensor(np.random.default_rng(5).normal(size=k.shape[0]))
    telemetry.reset()
    with telemetry.enabled():
        bn, nb = autotune_ell_stream(ell, x, block_candidates=(128, 256), nbuf_candidates=(2,),
                                     iters=1)
        snap = telemetry.snapshot()
    assert bn in (128, 256) and nb == 2
    assert k.pattern.stream_plans().tuned[torch.float64] == (bn, nb)
    assert autotune_ell_stream(ell, x) == (bn, nb)  # cached: no candidate is timed again
    assert sum(1 for key in snap["histograms"] if key.startswith("ell_stream_autotune_us")) == 2
    assert snap["gauges"]["ell_stream_block_n"] == bn
    assert any(key.startswith("ell_stream_window") for key in snap["gauges"])
    telemetry.reset()
    assert autotune_stream(ell.vals, np.asarray(ell.cols), x, block_candidates=(128,),
                           nbuf_candidates=(3,), iters=1) == (128, 3)


def test_pattern_caches_and_stages_the_plan_once():
    k, _ = _fem_cols(tc.unit_square_tri, 12)
    plans = k.pattern.stream_plans()
    assert plans is k.pattern.stream_plans() and plans(128) is plans(128)
    a, b = plans(128).staged("cpu"), plans(128).staged("cpu")
    assert a[0] is b[0] and a[1] is b[1]
    ell = tc.csr_to_ell(k)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=k.shape[0]))
    f = torch.as_tensor(np.random.default_rng(2).normal(size=k.shape[0]))
    torch.testing.assert_close(ell_matvec_stream(ell, x, block_n=64), k.matvec(x),
                               atol=1e-13, rtol=0)
    torch.testing.assert_close(ell_residual_stream(ell, x, f, nbuf=3), k.matvec(x) - f,
                               atol=1e-13, rtol=0)
    assert isinstance(plans, StreamPlans) and set(plans._plans) == {64, 128, 1024}


def test_ell_stream_poisson_solve_matches_jax():
    jp = JPoisson(jc.unit_square_tri(8))
    ju = jp.solve(backend="ell_stream", spec=jc.SolverSpec(method="cg", tol=1e-12))
    tp = PoissonProblem(tc.unit_square_tri(8), device="cpu")
    tu = tp.solve(backend="ell_stream", spec=tc.SolverSpec(method="cg", tol=1e-12))
    assert abs(tu.iters - int(ju.iters)) <= 1 and tu.converged
    np.testing.assert_allclose(tu.u.numpy(), np.asarray(ju.u), atol=1e-10, rtol=0)
    td = tp.solve(backend="ell", spec=tc.SolverSpec(method="cg", tol=1e-12))
    assert td.iters == tu.iters
    torch.testing.assert_close(tu.u, td.u, atol=0, rtol=0)


def test_ell_stream_advection_diffusion_solve_matches_ell():
    """BiCGSTAB on the nonsymmetric operator: the streaming backend runs the
    Krylov matvecs and the residual check, with the answer of ``ell``."""
    prob = AdvectionDiffusionProblem(tc.unit_square_tri(12), device="cpu")
    kw = dict(eps=0.05, beta=(1.0, 0.5), f=1.0)
    a, b = prob.solve(backend="ell", **kw), prob.solve(backend="ell_stream", **kw)
    assert a.converged and (a.iters, a.residual) == (b.iters, b.residual)
    torch.testing.assert_close(a.u, b.u, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (run on a CUDA machine)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,block_n", SWEEP)
@pytest.mark.parametrize("t_dt,tol", [(torch.float32, 2e-4), (torch.float64, 1e-12)])
def test_cuda_stream_kernels_match_plain(cuda, n, l, block_n, t_dt, tol):
    vals, cols, x, f = _sweep_inputs(n, l, n)
    tv, tx, tf = (torch.as_tensor(a, dtype=t_dt, device=cuda) for a in (vals, x, f))
    plan = StreamPlan(cols, block_n)
    cols_local, starts = plan.staged(cuda)
    want = tref.spmv_ell_stream_ref(tv, cols_local, starts, tx, block_n, plan.x_len)
    kernels.reset_launches()
    for nbuf in (1, 2, 3):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(spmv_ell_stream(tv, plan, tx, nbuf=nbuf), want,
                                   atol=tol * scale, rtol=0)
        torch.testing.assert_close(galerkin_residual_ell_stream(tv, plan, tx, tf, nbuf=nbuf),
                                   want - tf, atol=tol * scale, rtol=0)
    assert kernels.LAUNCHES["spmv_ell_stream"] == 3
    assert kernels.LAUNCHES["galerkin_residual_ell_stream"] == 3
