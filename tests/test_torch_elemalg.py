"""Torch port parity for the element tensor algebra: ``factorize`` /
``ElementFactors.solve`` on both routes, ``block_partition``,
``masked_element_matrices``, the DoF splits, the condensation scaffold and
every block apply of ``CondensedSystem``, ``condensed_solve`` and its
gradient, the ``ebe`` and ``chebyshev`` preconditioners (applies, solve
counts, the LU route), the problem classes' condensed and Chebyshev solves
— each against ``repro.core.elemalg`` or the JAX call on the same numpy
inputs — and the JAX numbers that ``chip_smoke.py``'s ``elemalg`` phase
pins."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import elemalg as je  # noqa: E402
from repro.core import weakform as jwf  # noqa: E402
from repro.fem import tensormesh as jtm  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.core import elemalg as te  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.fem import tensormesh as ttm  # noqa: E402

SPEC = dict(method="cg", tol=1e-12, atol=1e-12, maxiter=10000)
ANISO = np.diag([100.0, 1.0])


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), atol=atol, rtol=0)


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


@functools.lru_cache(maxsize=None)
def _spaces(gen, args, degree=1, vs=1):
    """Both packages' plan and Dirichlet condenser on one space."""
    mj, mt = getattr(jc, gen)(*args), getattr(tc, gen)(*args)
    sj = jc.FunctionSpace(mj, jc.mesh.element_for_mesh(mj, degree), vs)
    st = tc.FunctionSpace(mt, tc.element_for_mesh(mt, degree), vs)
    pj, pt = jc.build_plan(sj), tc.build_plan(st, device="cpu")
    bj = jc.DirichletCondenser(pj.static.mat_routing, sj.boundary_dofs())
    bt = tc.DirichletCondenser(pt.mat_routing, st.boundary_dofs(), device="cpu")
    return sj, st, pj, bj, pt, bt


def _ops(gen, args, degree, form_j, form_t, vs=1, load=(1.0,)):
    """The Dirichlet-condensed matrix-free operator and the masked load of
    one form in both packages."""
    sj, st, pj, bj, pt, bt = _spaces(gen, args, degree, vs)
    oj = jc.matfree_operator(pj, form_j).condensed(bj)
    ot = tc.matfree_operator(pt, form_t).condensed(bt)
    src = load[0] if len(load) == 1 else np.asarray(load)
    fj = bj.project_residual(jc.assemble_rhs(pj, jwf.source(
        src if len(load) == 1 else jnp.asarray(src))))
    ft = bt.project_residual(tc.assemble_rhs(pt, twf.source(
        src if len(load) == 1 else torch.as_tensor(src))))
    return sj, st, oj, ot, fj, ft


def _p2(n):
    return _ops("unit_square_tri", (n,), 2, jwf.diffusion(1.0), twf.diffusion(1.0))


def _aniso(n):
    return _ops("unit_square_tri", (n,), 1, jwf.anisotropic_diffusion(jnp.asarray(ANISO)),
                twf.anisotropic_diffusion(torch.as_tensor(ANISO)))


def _elasticity():
    return _ops("unit_cube_tet", (3,), 1, jwf.elasticity(1.0, 0.4), twf.elasticity(1.0, 0.4),
                vs=3, load=(0.0, 0.0, -1.0))


# ---------------------------------------------------------------------------
# batched primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("spd", [True, False])
def test_factorize_and_solve_match_jax(k, spd):
    e = 50
    q = _rng(1, e, k, k)
    mat = q @ q.transpose(0, 2, 1) + 3.0 * np.eye(k) if spd else q + 4.0 * np.eye(k)
    fj, ft = je.factorize(jnp.asarray(mat), spd=spd), te.factorize(torch.as_tensor(mat), spd=spd)
    assert ft.is_cholesky == fj.is_cholesky == spd
    for rhs in (_rng(2, e, k), _rng(3, e, k, 4)):
        want = np.asarray(fj.solve(jnp.asarray(rhs)))
        got = ft.solve(torch.as_tensor(rhs))
        assert got.shape == rhs.shape
        _close(got, want, 1e-12)
        _close(got, np.linalg.solve(mat, rhs if rhs.ndim == 3 else rhs[..., None]).reshape(
            rhs.shape), 1e-12)


def test_factorize_marks_a_failed_cholesky_with_nan():
    """As ``jnp.linalg.cholesky`` does: an element that is not positive
    definite gets NaN factors (no host check), the others stay exact."""
    mat = np.stack([np.eye(3) * 2.0, -np.eye(3)])
    fac = te.factorize(torch.as_tensor(mat), spd=True)
    x = fac.solve(torch.ones(2, 3, dtype=torch.float64))
    assert torch.isnan(x[1]).all()
    _close(x[0], np.full(3, 0.5), 1e-15)
    xj = je.factorize(jnp.asarray(mat), spd=True).solve(jnp.ones((2, 3)))
    assert np.isnan(np.asarray(xj[1])).all()


def test_block_partition_and_masked_element_matrices_match_jax():
    _, _, oj, ot, _, _ = _p2(4)
    kj, kt = je.masked_element_matrices(oj), te.masked_element_matrices(ot)
    _close(kt, kj, 1e-12)
    k_e = _rng(4, 5, 6, 6)
    for rows, cols in (([0, 2], [1, 3, 5]), ([3, 4], None)):
        _close(te.block_partition(torch.as_tensor(k_e), rows, cols),
               je.block_partition(jnp.asarray(k_e), rows, cols), 0)
    with pytest.raises(TypeError, match="repro_torch.core.matfree_operator"):
        te.masked_element_matrices(tc.assemble(ot.plan, twf.diffusion(1.0)))


def test_dof_splits_match_jax_and_reject_bad_splits():
    sj, st, *_ = _p2(4)
    edges = np.arange(st.num_dofs) >= st.mesh.num_vertices  # the edge DoFs as interface
    for a, b in ((te.vertex_split(st), je.vertex_split(sj)),
                 (te.dof_split(st.cell_dofs, edges), je.dof_split(sj.cell_dofs, edges))):
        for f in ("interface_mask", "interface_slots", "interior_slots"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    p1 = tc.FunctionSpace(st.mesh, tc.element_for_mesh(st.mesh, 1))
    with pytest.raises(ValueError, match="degree"):
        te.vertex_split(p1)
    bad = np.zeros(st.num_dofs, dtype=bool)
    bad[0] = True
    with pytest.raises(ValueError, match="slot-uniform"):
        te.dof_split(st.cell_dofs, bad)


def test_scaffold_tables_equal_jax():
    sj, st, oj, ot, _, _ = _p2(6)
    scj, sct = je._scaffold(oj, je.vertex_split(sj)), te._scaffold(ot, te.vertex_split(st))
    for f in ("cell_b", "cell_i", "interface_dofs", "interior_dofs"):
        np.testing.assert_array_equal(getattr(sct, f), getattr(scj, f))
        np.testing.assert_array_equal(sct.dev[f].numpy(), getattr(scj, f))
    assert (sct.nb, sct.ni, sct.n) == (scj.nb, scj.ni, scj.n)
    split = te.vertex_split(st)
    assert te._scaffold(ot, split) is te._scaffold(ot, split)  # cached per identity


# ---------------------------------------------------------------------------
# static condensation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _condensed(n=6):
    sj, st, oj, ot, fj, ft = _p2(n)
    return (sj, st, oj, ot, fj, ft,
            je.condense(oj, je.vertex_split(sj)), te.condense(ot, te.vertex_split(st)))


@pytest.mark.parametrize("which", ["kbb_matvec", "kii_matvec", "kib_matvec", "kbi_matvec",
                                   "matvec", "reduce_rhs", "recover"])
def test_condensed_system_applies_match_jax(which):
    *_, fj, ft, sysj, syst = _condensed()
    nb, ni = syst.shape[0], syst.sc.ni
    assert syst.shape == sysj.shape and syst.full_shape == sysj.full_shape
    args = {"kbb_matvec": (_rng(5, nb),), "kii_matvec": (_rng(6, ni),),
            "kib_matvec": (_rng(7, nb),), "kbi_matvec": (_rng(8, ni),),
            "matvec": (_rng(9, nb),), "reduce_rhs": (np.array(fj),),
            "recover": (_rng(10, nb), np.array(fj))}[which]
    want = getattr(sysj, which)(*map(jnp.asarray, args))
    got = getattr(syst, which)(*map(torch.as_tensor, args))
    _close(got, want, 1e-12)


def test_condensed_solve_matches_jax_in_fewer_iterations():
    sj, st, oj, ot, fj, ft = _p2(6)
    uj, ij = je.condensed_solve(oj, fj, jc.SolverSpec(**SPEC), split=je.vertex_split(sj),
                                return_info=True)
    u, info = te.condensed_solve(ot, ft, tc.SolverSpec(**SPEC), space=st, return_info=True)
    _, full = tc.matfree_solve(ot, ft, tc.SolverSpec(**SPEC), return_info=True)
    assert info.converged and abs(info.iters - int(ij.iters)) <= 1 and info.iters < full.iters
    _close(u, uj, 1e-10)
    with pytest.raises(TypeError, match="split="):
        te.condensed_solve(ot, ft)


@functools.lru_cache(maxsize=None)
def _cond_grad_jax(n, rho):
    sj, _, pj, bj, _, _ = _spaces("unit_square_tri", (n,), 2)
    fj = bj.project_residual(jc.assemble_rhs(pj, jwf.source(1.0)))
    split, spec = je.vertex_split(sj), jc.SolverSpec(**SPEC)

    @jax.jit
    def run(r, b):
        def loss(r, b):
            op = jc.matfree_operator(pj, jwf.diffusion(r)).condensed(bj)
            return jnp.sum(je.condensed_solve(op, b, spec, split=split) ** 2)

        return jax.grad(loss, argnums=(0, 1))(r, b)

    g_rho, g_b = run(jnp.asarray(np.asarray(rho)), fj)
    return np.asarray(fj), np.asarray(g_rho), np.asarray(g_b)


def test_condensed_solve_gradient_matches_jax_grad():
    n = 4
    _, st, _, _, pt, bt = _spaces("unit_square_tri", (n,), 2)
    rho = tuple(np.random.default_rng(11).uniform(0.5, 2.0, pt.num_cells))
    f, g_rho_j, g_b_j = _cond_grad_jax(n, rho)
    r = torch.tensor(rho, dtype=torch.float64, requires_grad=True)
    b = torch.tensor(f, requires_grad=True)
    op = tc.matfree_operator(pt, twf.diffusion(r)).condensed(bt)
    u = te.condensed_solve(op, b, tc.SolverSpec(**SPEC), space=st)
    g_rho, g_b = torch.autograd.grad((u ** 2).sum(), (r, b))
    for got, want in ((g_rho, g_rho_j), (g_b, g_b_j)):
        _close(got, want, 1e-10 * np.abs(want).max())


# ---------------------------------------------------------------------------
# preconditioners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["aniso", "elasticity"])
@pytest.mark.parametrize("name", ["ebe", "chebyshev"])
def test_preconditioner_applies_match_jax(problem, name):
    *_, oj, ot, _, _ = _aniso(8) if problem == "aniso" else _elasticity()
    x = _rng(12, ot.shape[0])
    want = jc.make_preconditioner(oj, name)(jnp.asarray(x))
    got = tc.make_preconditioner(ot, name)(torch.as_tensor(x))
    _close(got, want, 1e-12 * max(1.0, float(np.abs(np.asarray(want)).max())))


@pytest.mark.parametrize("name", ["jacobi", "ebe", "chebyshev"])
def test_preconditioned_matfree_solve_counts_match_jax(name):
    *_, oj, ot, fj, ft = _aniso(12)
    spec = dict(method="cg", tol=1e-10, atol=1e-10, maxiter=10000, precond=name)
    uj, ij = jc.matfree_solve(oj, fj, jc.SolverSpec(**spec), return_info=True)
    u, info = tc.matfree_solve(ot, ft, tc.SolverSpec(**spec), return_info=True)
    assert info.converged and abs(info.iters - int(ij.iters)) <= 1
    _close(u, uj, 1e-10 * float(np.abs(np.asarray(uj)).max()))


def test_ebe_lu_route_with_bicgstab_matches_jax():
    beta = np.array([1.0, 0.3])
    *_, oj, ot, fj, ft = _ops("unit_square_tri", (12,), 1,
                              jwf.diffusion(0.05) + jwf.advection(jnp.asarray(beta)),
                              twf.diffusion(0.05) + twf.advection(torch.as_tensor(beta)))
    assert not ot.is_spd()
    k_e = te.masked_element_matrices(ot)
    assert not te.factorize(k_e, spd=ot.is_spd()).is_cholesky
    spec = dict(method="bicgstab", tol=1e-11, atol=1e-11, precond="ebe")
    uj = jc.matfree_solve(oj, fj, jc.SolverSpec(**spec))
    u, info = tc.matfree_solve(ot, ft, tc.SolverSpec(**spec), return_info=True)
    assert info.converged
    _close(u, uj, 1e-8)


def test_preconditioners_need_no_import_keep_state_gauge_and_reject_csr():
    """``ebe``/``chebyshev`` resolve through the registry; building and
    applying them leaves the ``operator_state_bytes`` gauge as it was (no
    global matrix); ``ebe`` on an assembled CSR raises, ``chebyshev`` runs
    on it."""
    *_, ot, _, ft = _aniso(8)
    telemetry.enable()
    try:
        before = telemetry.snapshot()["gauges"]
        for name in ("ebe", "chebyshev"):
            assert torch.isfinite(tc.make_preconditioner(ot, name)(ft)).all()
        after = telemetry.snapshot()["gauges"]
        assert {k: v for k, v in after.items() if "operator_state_bytes" in k} == {
            k: v for k, v in before.items() if "operator_state_bytes" in k}
    finally:
        telemetry.disable()
    k = tc.assemble(ot.plan, twf.diffusion(1.0))
    with pytest.raises(TypeError, match="element tensors"):
        tc.make_preconditioner(k, "ebe")
    assert torch.isfinite(tc.make_preconditioner(k, "chebyshev")(ft)).all()


# ---------------------------------------------------------------------------
# problem classes and the chip smoke test's pins
# ---------------------------------------------------------------------------

def test_problem_condensed_and_chebyshev_solves_match_jax():
    spec = dict(method="cg", tol=1e-12, atol=1e-12)
    pj = jtm.PoissonProblem(jc.unit_square_tri(6), degree=2)
    pt = ttm.PoissonProblem(tc.unit_square_tri(6), degree=2, device="cpu")
    rj = pj.solve(backend="matfree", condensed=True, spec=jc.SolverSpec(**spec))
    rt = pt.solve(backend="matfree", condensed=True, spec=tc.SolverSpec(**spec))
    assert abs(rt.iters - rj.iters) <= 1 and rt.converged
    _close(rt.u, rj.u, 1e-10)
    cj = jtm.PoissonProblem(jc.unit_cube_tet(3))
    ct = ttm.PoissonProblem(tc.unit_cube_tet(3), device="cpu")
    rj = cj.solve(spec=jc.SolverSpec(precond="chebyshev", **spec))
    rt = ct.solve(spec=tc.SolverSpec(precond="chebyshev", **spec))
    assert abs(rt.iters - rj.iters) <= 1 and rt.converged
    _close(rt.u, rj.u, 1e-10)


def test_chip_smoke_elemalg_pins_match_jax():
    """``chip_smoke.py`` holds the card to JAX numbers (the card machine has
    no JAX): the outer CG count and max u of the condensed P2 solve at
    unit_square_tri(64), and the CG counts of jacobi/ebe/chebyshev on the
    anisotropic P1 problem at unit_square_tri(32).  The JAX package meets
    them exactly, the port at the card's gates."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    pins = chip_smoke.JAX_ELEMALG
    spec = dict(method="cg", tol=1e-12, atol=1e-12)
    n = pins["condensed_n"]
    rj = jtm.PoissonProblem(jc.unit_square_tri(n), degree=2).solve(
        backend="matfree", condensed=True, spec=jc.SolverSpec(**spec))
    assert rj.iters == pins["condensed_iters"] and float(jnp.max(rj.u)) == pins["condensed_max_u"]
    rt = ttm.PoissonProblem(tc.unit_square_tri(n), degree=2, device="cpu").solve(
        backend="matfree", condensed=True, spec=tc.SolverSpec(**spec))
    assert abs(rt.iters - pins["condensed_iters"]) <= 1
    assert abs(float(rt.u.max()) - pins["condensed_max_u"]) <= 1e-10
    *_, oj, ot, fj, ft = _aniso(pins["precond_n"])
    for name, want in pins["precond_iters"].items():
        spec = dict(method="cg", tol=1e-10, atol=1e-10, maxiter=10000, precond=name)
        _, ij = jc.matfree_solve(oj, fj, jc.SolverSpec(**spec), return_info=True)
        _, it = tc.matfree_solve(ot, ft, tc.SolverSpec(**spec), return_info=True)
        assert int(ij.iters) == want and abs(it.iters - want) <= 1, name
