"""Torch port parity for the matrix-free operators: ``matfree_operator``
applies (every element × store), ``rmatvec``, the anisotropic action, the
elasticity fallback, condensation and ``diagonal`` against
``repro.core.matfree_operator``; ``matfree_solve`` and its gradients
against the JAX call and ``jax.grad`` (and ``gradcheck``); the problem
classes on ``backend="matfree"``; ``MatFreeFamily`` and
``matfree_solve_batched`` against the JAX family; the ``matfree`` backend of
the registry; the fused P1 diffusion action (``kernels.matfree_p1_diffusion``)
against the einsum action and the JAX operator, and which applies take it,
read from the ``matfree_action`` telemetry counter.  The ``cuda`` tests
count the kernels an apply launches and hold the fused kernel to its plain
twin."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import weakform as jwf  # noqa: E402
from repro.fem import tensormesh as jtm  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import kernels, telemetry  # noqa: E402
from repro_torch.core import forms, operator  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.fem import tensormesh as ttm  # noqa: E402

SPACES = {  # name -> (generator, args, degree, value_size)
    "P1_tri": ("unit_square_tri", (6,), 1, 1),
    "P2_tri": ("unit_square_tri", (4,), 2, 1),
    "P1_tet": ("unit_cube_tet", (3,), 1, 1),
    "Q1_quad": ("rectangle_quad", (5, 4, 1.0, 1.0), 1, 1),
    "Q1_hex": ("unit_cube_hex", (3,), 1, 1),
    "P1_tri_vec": ("unit_square_tri", (4,), 1, 2),
}
STORES = ["coords", "context", "local"]
SPEC = dict(method="cg", tol=1e-12, atol=1e-12, maxiter=10000)


@functools.lru_cache(maxsize=None)
def _plans(name, device="cpu"):
    """Both packages' plan and Dirichlet condenser on one space."""
    gen, args, degree, vs = SPACES[name]
    mj, mt = getattr(jc, gen)(*args), getattr(tc, gen)(*args)
    sj = jc.FunctionSpace(mj, jc.mesh.element_for_mesh(mj, degree), vs)
    st = tc.FunctionSpace(mt, tc.element_for_mesh(mt, degree), vs)
    pj, pt = jc.build_plan(sj), tc.build_plan(st, device=device)
    bj = jc.DirichletCondenser(pj.static.mat_routing, sj.boundary_dofs())
    bt = tc.DirichletCondenser(pt.mat_routing, st.boundary_dofs(), device=device)
    return pj, bj, pt, bt


def _rng_vec(n, seed):
    x = np.random.default_rng(seed).standard_normal(n)
    return jnp.asarray(x), torch.as_tensor(x)


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), atol=atol, rtol=0)


def _forms(kind, pt, seed=0):
    """Matched (JAX, torch) bilinear forms of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "diffusion_mass":
        rho = rng.uniform(0.5, 2.0, pt.num_cells)
        return (jwf.diffusion(jnp.asarray(rho)) + 0.3 * jwf.mass(),
                twf.diffusion(torch.as_tensor(rho)) + 0.3 * twf.mass())
    if kind == "advection":
        beta = np.array([1.0, 0.5])
        return (jwf.diffusion() + jwf.advection(jnp.asarray(beta)),
                twf.diffusion() + twf.advection(torch.as_tensor(beta)))
    if kind == "anisotropic":
        a = np.array([[2.0, 0.5], [0.3, 1.0]])  # nonsymmetric tensor coefficient
        return (jwf.anisotropic_diffusion(jnp.asarray(a)),
                twf.anisotropic_diffusion(torch.as_tensor(a)))
    if kind == "elasticity":
        return jwf.elasticity(1.2, 0.7), twf.elasticity(1.2, 0.7)
    raise KeyError(kind)


# ---------------------------------------------------------------------------
# the apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["P1_tri", "P2_tri", "P1_tet", "Q1_quad", "Q1_hex"])
@pytest.mark.parametrize("store", STORES)
def test_apply_and_diagonal_match_jax(name, store):
    pj, _, pt, _ = _plans(name)
    fj, ft = _forms("diffusion_mass", pt)
    oj, ot = jc.matfree_operator(pj, fj, store=store), tc.matfree_operator(pt, ft, store=store)
    xj, xt = _rng_vec(pt.num_dofs, 1)
    _close(ot.matvec(xt), oj.matvec(xj), 1e-12)
    _close(ot.rmatvec(xt), oj.rmatvec(xj), 1e-12)
    _close(ot.diagonal(), oj.diagonal(), 1e-12)
    _close(ot.element_matrices(), oj.element_matrices(), 1e-12)
    assert ot.is_spd() and oj.is_spd()
    # and the port's own assembled operator
    torch.testing.assert_close(ot.matvec(xt), tc.assemble(pt, ft).matvec(xt), atol=1e-12, rtol=0)


@pytest.mark.parametrize("kind,name", [("advection", "P1_tri"), ("anisotropic", "P1_tri"),
                                       ("elasticity", "P1_tri_vec")])
def test_nonsymmetric_and_fallback_actions_match_jax(kind, name):
    pj, _, pt, _ = _plans(name)
    fj, ft = _forms(kind, pt)
    oj, ot = jc.matfree_operator(pj, fj), tc.matfree_operator(pt, ft)
    xj, xt = _rng_vec(pt.num_dofs, 2)
    _close(ot.matvec(xt), oj.matvec(xj), 1e-12)
    _close(ot.rmatvec(xt), oj.rmatvec(xj), 1e-12)
    _close(ot.diagonal(), oj.diagonal(), 1e-12)
    k = tc.assemble(pt, ft)
    torch.testing.assert_close(ot.rmatvec(xt), k.rmatvec(xt), atol=1e-12, rtol=0)
    assert ot.is_spd() == oj.is_spd() == (kind == "elasticity")


@pytest.mark.parametrize("store", STORES)
def test_condensed_apply_matches_jax_and_condensed_csr(store):
    pj, bj, pt, bt = _plans("P1_tri")
    fj, ft = _forms("diffusion_mass", pt)
    oj = jc.matfree_operator(pj, fj, store=store).condensed(bj)
    ot = tc.matfree_operator(pt, ft, store=store).condensed(bt)
    xj, xt = _rng_vec(pt.num_dofs, 3)
    _close(ot.matvec(xt), oj.matvec(xj), 1e-12)
    _close(ot.diagonal(), oj.diagonal(), 1e-12)
    kc = bt.apply_matrix_only(tc.assemble(pt, ft))
    torch.testing.assert_close(ot.matvec(xt), kc.matvec(xt), atol=1e-12, rtol=0)
    torch.testing.assert_close(ot.diagonal(), kc.diagonal(), atol=1e-12, rtol=0)


def test_state_bytes_and_validation():
    pj, _, pt, _ = _plans("P1_tet")
    fj, ft = _forms("diffusion_mass", pt)
    for store in ("coords", "local"):
        assert (tc.matfree_operator(pt, ft, store=store).state_bytes()
                == jc.matfree_operator(pj, fj, store=store).state_bytes())
    k = tc.assemble(pt, ft)
    csr_bytes = 8 * k.nnz * 3
    assert tc.matfree_operator(pt, ft, store="coords").state_bytes() < csr_bytes / 2
    with pytest.raises(ValueError, match="unknown store"):
        tc.matfree_operator(pt, ft, store="nope")
    with pytest.raises(TypeError):
        tc.matfree_operator(pt, twf.source(1.0))


def test_matfree_rejects_facet_terms():
    m = tc.unit_square_tri(4)
    sp = tc.FunctionSpace(m, tc.element_for_mesh(m))
    asm = tc.GalerkinAssembler(sp, device="cpu")
    fa = tc.FacetAssembler(sp, m.boundary_facets(), volume_routing=asm.mat_routing,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="volume terms only"):
        tc.matfree_operator(asm.plan, twf.diffusion() + twf.robin(1.0, on=fa))


def test_registry_matfree_backend():
    pj, _, pt, _ = _plans("P1_tri")
    _, ft = _forms("diffusion_mass", pt)
    op, k = tc.matfree_operator(pt, ft), tc.assemble(pt, ft)
    _, x = _rng_vec(pt.num_dofs, 4)
    _, f = _rng_vec(pt.num_dofs, 5)
    torch.testing.assert_close(tc.make_matvec(op, "matfree")(x), k.matvec(x), atol=1e-12, rtol=0)
    torch.testing.assert_close(tc.make_residual(op, "matfree")(x, f), k.matvec(x) - f,
                               atol=1e-12, rtol=0)
    with pytest.raises(TypeError, match="matrix-free operator"):
        tc.make_matvec(k, "matfree")
    with pytest.raises(TypeError, match="assembled CSR"):
        tc.make_matvec(op, "ell")
    # the sharded backend shards the operator over the one-rank mesh: the same apply
    torch.testing.assert_close(tc.make_matvec(op, "matfree_sharded")(x), op.matvec(x),
                               atol=0, rtol=0)
    torch.testing.assert_close(tc.make_residual(op, "matfree_sharded")(x, f),
                               tc.make_residual(op, "matfree")(x, f), atol=0, rtol=0)


def test_cached_diagonal_keys_on_the_operator_tensors():
    _, _, pt, _ = _plans("P1_tri")
    rho = torch.as_tensor(np.random.default_rng(6).uniform(0.5, 2.0, pt.num_cells))
    op = tc.matfree_operator(pt, twf.diffusion(rho))
    d = tc.cached_diagonal(op)
    assert tc.cached_diagonal(op) is d
    # new leaves: a new key, a fresh diagonal
    op2 = op.with_traced([t.clone() for t in op.traced()])
    assert tc.cached_diagonal(op2) is not d
    # leaves that require grad: never cached, the diagonal keeps its graph
    opg = tc.matfree_operator(pt, twf.diffusion(rho.clone().requires_grad_(True)))
    dg = tc.cached_diagonal(opg)
    assert dg.requires_grad and tc.cached_diagonal(opg) is not dg


# ---------------------------------------------------------------------------
# matfree_solve and its gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cube():
    """The condensed P1 Poisson system on unit_cube_tet(3): load and ρ in
    both packages, and the JAX solve, its gradients in ρ and b (one jit)."""
    pj, bj, pt, bt = _plans("P1_tet")
    fj = bj.project_residual(jc.assemble_rhs(pj, jwf.source(1.0)))
    rho = np.random.default_rng(7).uniform(0.5, 2.0, pt.num_cells)
    spec_j = jc.SolverSpec(**SPEC)

    @jax.jit
    def run(r, b):
        def loss(r, b):
            op = jc.matfree_operator(pj, jwf.diffusion(r)).condensed(bj)
            u, info = jc.matfree_solve(op, b, spec_j, return_info=True)
            return jnp.sum(u ** 2), (u, info.iters)

        (_, (u, iters)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(r, b)
        return u, iters, grads

    u, iters, (g_rho, g_b) = run(jnp.asarray(rho), fj)
    ft = torch.tensor(np.asarray(fj))
    return pt, bt, rho, ft, (np.asarray(u), int(iters), np.asarray(g_rho), np.asarray(g_b))


@pytest.mark.parametrize("store", STORES)
def test_matfree_solve_and_gradients_match_jax(store):
    pt, bt, rho, f, (uj, itj, g_rho_j, g_b_j) = _cube()
    r = torch.tensor(rho, requires_grad=True)
    b = f.clone().requires_grad_(True)
    op = tc.matfree_operator(pt, twf.diffusion(r), store=store).condensed(bt)
    u, info = tc.matfree_solve(op, b, tc.SolverSpec(**SPEC), return_info=True)
    assert abs(info.iters - itj) <= 1 and info.converged
    _close(u, uj, 1e-10 * np.abs(uj).max())
    g_rho, g_b = torch.autograd.grad((u ** 2).sum(), (r, b))
    for got, want in ((g_rho, g_rho_j), (g_b, g_b_j)):
        _close(got, want, 1e-8 * np.abs(want).max())
    # no grad: the plain Krylov solve on the operator itself, same answer
    with torch.no_grad():
        torch.testing.assert_close(tc.matfree_solve(op, f, tc.SolverSpec(**SPEC)), u.detach(),
                                   atol=1e-14, rtol=0)


def test_matfree_solve_on_csr_is_sparse_solve():
    pt, bt, rho, f, _ = _cube()
    r = torch.tensor(rho, requires_grad=True)
    spec = tc.SolverSpec(**SPEC)
    us, grads = [], []
    for solve in (tc.matfree_solve, tc.sparse_solve):
        u = solve(bt.apply_matrix_only(tc.assemble(pt, twf.diffusion(r))), f, spec)
        us.append(u)
        grads.append(torch.autograd.grad((u ** 2).sum(), r)[0])
    torch.testing.assert_close(us[0], us[1], atol=1e-14, rtol=0)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-14, rtol=0)


def test_matfree_solve_gradcheck():
    m = tc.unit_cube_tet(2)
    sp = tc.FunctionSpace(m, tc.element_for_mesh(m))
    plan = tc.build_plan(sp, device="cpu")
    bt = tc.DirichletCondenser(plan.mat_routing, np.arange(0, sp.num_dofs, 3), device="cpu")
    rng = np.random.default_rng(8)
    rho = torch.tensor(rng.uniform(0.5, 2.0, m.num_cells), requires_grad=True)
    coords = plan.coords.clone().requires_grad_(True)
    b = torch.tensor(rng.standard_normal(sp.num_dofs), requires_grad=True)
    spec = tc.SolverSpec(method="cg", tol=1e-15, atol=1e-15, maxiter=1000)

    def solve(r, c, bb):
        op = tc.matfree_operator(plan, twf.diffusion(r) + twf.mass(0.5), store="coords",
                                 coords=c).condensed(bt)
        return tc.matfree_solve(op, bt.project_residual(bb), spec)

    assert torch.autograd.gradcheck(solve, (rho, coords, b), eps=1e-6, atol=1e-6,
                                    fast_mode=True)


# ---------------------------------------------------------------------------
# the problem classes on backend="matfree"
# ---------------------------------------------------------------------------

PROBLEMS = {  # name -> (JAX call, torch call of the store; only Poisson's takes one)
    "poisson": (lambda: jtm.PoissonProblem(jc.unit_cube_tet(3)).solve(
                    f=1.0, backend="matfree", return_info=True),
                lambda store: ttm.PoissonProblem(tc.unit_cube_tet(3), device="cpu").solve(
                    f=1.0, backend="matfree", return_info=True, store=store)),
    "advection": (lambda: jtm.AdvectionDiffusionProblem(jc.unit_square_tri(6)).solve(
                      eps=0.1, beta=(1.0, 0.5), dirichlet_values=0.5, backend="matfree",
                      return_info=True),
                  lambda _store: ttm.AdvectionDiffusionProblem(
                      tc.unit_square_tri(6), device="cpu").solve(
                      eps=0.1, beta=(1.0, 0.5), dirichlet_values=0.5, backend="matfree",
                      return_info=True)),
    "elasticity": (lambda: jtm.ElasticityProblem(jc.unit_square_tri(5)).solve(
                       backend="matfree", return_info=True),
                   lambda _store: ttm.ElasticityProblem(tc.unit_square_tri(5),
                                                        device="cpu").solve(
                       backend="matfree", return_info=True)),
}


@functools.lru_cache(maxsize=None)
def _jax_problem(name):
    res, info = PROBLEMS[name][0]()
    return np.asarray(res.u), int(info.iters), res.residual


@pytest.mark.parametrize("name,store", [("poisson", "context"), ("poisson", "local"),
                                        ("poisson", "coords"), ("advection", "context"),
                                        ("elasticity", "context")])
def test_problem_matfree_matches_jax(name, store):
    uj, itj, _ = _jax_problem(name)
    res, info = PROBLEMS[name][1](store)
    assert abs(res.iters - itj) <= 1 and res.converged
    assert res.residual < 1e-9
    _close(res.u, uj, 1e-10 * np.abs(uj).max())


def test_problem_matfree_equals_assembled_and_condensed_raises():
    """The matrix-free solve equals the assembled one; so does the
    statically condensed solve on a P2 mesh (``condensed=True``); so does
    the sharded backend on the one-rank mesh, bit for bit and in as many
    iterations as ``matfree``."""
    prob = ttm.PoissonProblem(tc.unit_cube_tet(3), device="cpu")
    mf = prob.solve(backend="matfree")
    torch.testing.assert_close(mf.u, prob.solve(backend="csr").u, atol=1e-10, rtol=0)
    p2 = ttm.PoissonProblem(tc.unit_square_tri(6), degree=2, device="cpu")
    spec = tc.SolverSpec(**SPEC)
    cond = p2.solve(backend="matfree", condensed=True, spec=spec)
    torch.testing.assert_close(cond.u, p2.solve(backend="csr", spec=spec).u, atol=1e-10, rtol=0)
    sharded = prob.solve(backend="matfree_sharded")
    torch.testing.assert_close(sharded.u, mf.u, atol=0, rtol=0)
    assert sharded.iters == mf.iters


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------

B = 3


@functools.lru_cache(maxsize=None)
def _family_inputs():
    pj, bj, pt, bt = _plans("P1_tri")
    rng = np.random.default_rng(9)
    rho_b = rng.uniform(0.5, 2.0, (B, pt.num_cells))
    coords_b = np.asarray(pj.coords)[None] + 1e-3 * rng.normal(size=(B,) + pj.coords.shape)
    return pj, bj, pt, bt, rho_b, coords_b


def _families(store, coords=False, condensed=False):
    pj, bj, pt, bt, rho_b, coords_b = _family_inputs()
    kw_j = dict(coords_batch=jnp.asarray(coords_b)) if coords else {}
    kw_t = dict(coords_batch=torch.as_tensor(coords_b)) if coords else {}
    fj = jc.matfree_family(pj, jwf.diffusion(jnp.asarray(rho_b[0])),
                           leaves_batch=(jnp.asarray(rho_b), None), store=store, **kw_j)
    ft = tc.matfree_family(pt, twf.diffusion(torch.as_tensor(rho_b[0])),
                           leaves_batch=(torch.as_tensor(rho_b), None), store=store, **kw_t)
    if condensed:
        fj, ft = fj.condensed(bj), ft.condensed(bt)
    return fj, ft


@pytest.mark.parametrize("store", STORES)
def test_family_matvec_diagonal_match_jax(store):
    fj, ft = _families(store, condensed=store == "context")
    assert isinstance(ft, tc.MatFreeFamily) and ft.batch == B
    xj, xt = _rng_vec(ft.shape[0], 10)
    y, d = ft.matvec(xt), ft.diagonal()
    _close(y, fj.matvec(xj), 1e-12)
    _close(d, fj.diagonal(), 1e-12)
    xbj, xbt = _rng_vec(B * ft.shape[0], 11)
    _close(ft.matvec(xbt.reshape(B, -1)), fj.matvec(xbj.reshape(B, -1)), 1e-12)
    for i in range(B):
        torch.testing.assert_close(y[i], ft[i].matvec(xt), atol=1e-12, rtol=0)
        torch.testing.assert_close(d[i], ft[i].diagonal(), atol=1e-12, rtol=0)


def test_family_batched_coords_getitem_and_validation():
    fj, ft = _families("context", coords=True)
    assert ft.op.store == "coords" and ft.coords_ax == 0
    xj, xt = _rng_vec(ft.shape[0], 12)
    _close(ft.matvec(xt), fj.matvec(xj), 1e-12)
    _close(ft[1].matvec(xt), fj[1].matvec(xj), 1e-12)
    _, _, pt, _, rho_b, _ = _family_inputs()
    r = torch.as_tensor(rho_b)
    with pytest.raises(TypeError):
        ft[0:2]
    with pytest.raises(ValueError, match="nothing is batched"):
        tc.matfree_family(pt, twf.diffusion(r[0]))
    with pytest.raises(ValueError, match="leaves_batch has"):
        tc.matfree_family(pt, twf.diffusion(r[0]), leaves_batch=(r,))
    with pytest.raises(ValueError, match="inconsistent"):
        tc.matfree_family(pt, twf.mass(1.0) + twf.diffusion(r[0]),
                          leaves_batch=(torch.ones((2, 1)), None, r, None))


@functools.lru_cache(maxsize=None)
def _jax_family_solve():
    """The JAX family solve, its iterations and ∂/∂ρ_b of Σx² (one jit)."""
    pj, bj, pt, bt, rho_b, _ = _family_inputs()
    f = np.random.default_rng(13).normal(size=(B, pt.num_dofs)) * np.asarray(bj.free_mask)
    spec_j = jc.SolverSpec(**SPEC)

    @jax.jit
    def run(rb):
        def loss(rb):
            fam = jc.matfree_family(pj, jwf.diffusion(rb[0]),
                                    leaves_batch=(rb, None)).condensed(bj)
            x, info = jc.matfree_solve_batched(fam, jnp.asarray(f), spec_j, return_info=True)
            return jnp.sum(x ** 2), (x, info.iters)

        return jax.value_and_grad(loss, has_aux=True)(rb)

    (_, (xj, itj)), gj = run(jnp.asarray(rho_b))
    return f, np.asarray(xj), np.asarray(itj), np.asarray(gj)


@pytest.mark.parametrize("store", ["context", "local"])
def test_family_solve_and_gradient_match_jax(store):
    _, _, pt, bt, rho_b, _ = _family_inputs()
    f, xj, itj, gj = _jax_family_solve()
    r = torch.tensor(rho_b, requires_grad=True)
    fam = tc.matfree_family(pt, twf.diffusion(r[0]), leaves_batch=(r, None),
                            store=store).condensed(bt)
    x, info = tc.matfree_solve_batched(fam, torch.as_tensor(f), tc.SolverSpec(**SPEC),
                                       return_info=True)
    assert info.iters.shape == (B,) and bool(info.converged.all())
    assert np.abs(info.iters.numpy() - itj).max() <= 1
    _close(x, xj, 1e-10 * np.abs(xj).max())
    g, = torch.autograd.grad((x ** 2).sum(), r)
    _close(g, gj, 1e-8 * np.abs(gj).max())


# ---------------------------------------------------------------------------
# the fused P1 diffusion action and its dispatch
# ---------------------------------------------------------------------------

RHO_KINDS = ["cell", "quad", "scalar", "callable"]


def _rho(kind, e, q, seed):
    """A coefficient of one encoding: per cell (E,), per quadrature point
    (E, Q), a number, or a callable of the quadrature points."""
    rng = np.random.default_rng(seed)
    if kind == "cell":
        return torch.as_tensor(rng.uniform(0.5, 2.0, e))
    if kind == "quad":
        return torch.as_tensor(rng.uniform(0.5, 2.0, (e, q)))
    if kind == "scalar":
        return 1.7
    return lambda xq: 1.0 + xq[..., 0] ** 2


def _action_paths(fn):
    """``fn()``'s matrix-free applies by path, read from the telemetry
    counter ``matfree_action``, and its result."""
    def read():
        counters = telemetry.snapshot()["counters"]
        return {p: counters.get(f"matfree_action{{path={p}}}", 0) for p in ("fused", "einsum")}

    with telemetry.enabled():
        before = read()
        out = fn()
        after = read()
    return {p: after[p] - before[p] for p in after}, out


@pytest.mark.parametrize("rho_kind", RHO_KINDS)
@pytest.mark.parametrize("gen,n", [("unit_cube_tet", 3), ("unit_square_tri", 5)])
def test_fused_twin_equals_the_einsum_action(gen, n, rho_kind):
    """The fused kernel's plain twin (its CPU path) against the einsum
    action times the scale, on a randomly distorted mesh: to 1e-13 of the
    largest entry in float64."""
    m = getattr(tc, gen)(n)
    plan = tc.build_plan(tc.FunctionSpace(m, tc.element_for_mesh(m)), device="cpu")
    rng = np.random.default_rng(21)
    pts = m.points + (0.2 / n) * rng.uniform(-1.0, 1.0, m.points.shape)
    ctx = plan.context(torch.as_tensor(pts[m.cells]))
    e, q = ctx.detj.shape
    rho = _rho(rho_kind, e, q, 22)
    scale = torch.tensor(0.37) if rho_kind == "quad" else 0.37
    x = torch.as_tensor(rng.standard_normal(plan.num_dofs))
    want = operator._diffusion_act(ctx, 1, x[plan.cell_dofs], rho) * scale
    rho_q = rho if rho_kind == "scalar" else forms.eval_coefficient(rho, ctx)
    got = kernels.matfree_p1_diffusion(x, plan.cell_dofs, ctx.grad, ctx.detj, ctx.w, rho_q,
                                       scale)
    assert got.shape == plan.cell_dofs.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-13 * float(want.abs().max()))


def test_fused_wrapper_checks_its_operands():
    """Shapes, the (k, d) it serves, the vector and the scale are checked
    before any launch; a tensor off the CPU never takes the plain twin."""
    _, _, pt, _ = _plans("P1_tet")
    ctx = pt.context()
    x = torch.zeros(pt.num_dofs, dtype=torch.float64)
    args = (x, pt.cell_dofs, ctx.grad, ctx.detj, ctx.w)

    def call(i, value, **kw):
        return lambda: kernels.matfree_p1_diffusion(*args[:i], value, *args[i + 1:], **kw)

    for bad in (call(0, x[None]), call(1, pt.cell_dofs[:, :3]), call(2, ctx.grad[..., :2]),
                call(3, ctx.detj[:, :2]), call(4, ctx.w[:2]),
                call(0, x, scale=torch.ones(2, dtype=torch.float64))):
        with pytest.raises(ValueError):
            bad()
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.matfree_p1_diffusion(*(t.to("meta") for t in args))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("rho_kind", ["cell", "quad", "scalar"])
@pytest.mark.parametrize("store", ["coords", "context"])
@pytest.mark.parametrize("name", ["P1_tri", "P1_tet"])
def test_fused_apply_matches_jax(name, store, rho_kind):
    """``matvec`` / ``rmatvec`` of a scaled P1 diffusion operator take the
    fused path and match the JAX operator at 1e-12."""
    pj, _, pt, _ = _plans(name)
    rho = _rho(rho_kind, pt.num_cells, pt.w.shape[0], 23)
    rho_j = rho if rho_kind == "scalar" else jnp.asarray(rho.numpy())
    oj = jc.matfree_operator(pj, 0.6 * jwf.diffusion(rho_j), store=store)
    ot = tc.matfree_operator(pt, 0.6 * twf.diffusion(rho), store=store)
    xj, xt = _rng_vec(pt.num_dofs, 24)
    paths, (y, yt) = _action_paths(lambda: (ot.matvec(xt), ot.rmatvec(xt)))
    assert paths == {"fused": 2, "einsum": 0}
    _close(y, oj.matvec(xj), 1e-12)
    _close(yt, oj.rmatvec(xj), 1e-12)


@pytest.mark.parametrize("store", ["context", "coords"])
def test_dispatch_fused_under_no_grad(store):
    _, _, pt, bt = _plans("P1_tet")
    rho = _rho("cell", pt.num_cells, 0, 25).requires_grad_(True)
    op = tc.matfree_operator(pt, twf.diffusion(rho), store=store).condensed(bt)
    _, x = _rng_vec(pt.num_dofs, 26)
    with torch.no_grad():
        paths, y = _action_paths(lambda: op.matvec(x))
    assert paths == {"fused": 1, "einsum": 0} and not y.requires_grad
    # with grad on, the same apply records its graph on the einsum path
    paths, yg = _action_paths(lambda: op.matvec(x))
    assert paths == {"fused": 0, "einsum": 1} and yg.requires_grad
    torch.testing.assert_close(y, yg.detach(), atol=1e-13, rtol=0)


def _einsum_case(case):
    """An operator (or family) that the fused kernel does not serve, and
    an input."""
    name = {"p2": "P2_tri", "quad": "Q1_quad", "hex": "Q1_hex"}.get(case, "P1_tet")
    _, _, pt, _ = _plans(name)
    rho = _rho("cell", pt.num_cells, 0, 27)
    _, x = _rng_vec(pt.num_dofs, 28)
    if case == "diffusion_mass":
        return tc.matfree_operator(pt, twf.diffusion(rho) + 0.3 * twf.mass()), x
    if case == "local":
        return tc.matfree_operator(pt, twf.diffusion(rho), store="local"), x
    if case == "family":
        return tc.matfree_family(pt, twf.diffusion(rho),
                                 leaves_batch=(torch.stack([rho, 2.0 * rho]), None)), x
    return tc.matfree_operator(pt, twf.diffusion(rho)), x


@pytest.mark.parametrize("case", ["diffusion_mass", "p2", "quad", "hex", "local", "family"])
def test_dispatch_einsum_where_the_kernel_does_not_apply(case):
    op, x = _einsum_case(case)
    with torch.no_grad():
        paths, _ = _action_paths(lambda: op.matvec(x))
    assert paths == {"fused": 0, "einsum": 1}


def test_dispatch_inside_the_matfree_solve_gradient():
    """With ρ requiring grad, the forward and adjoint Krylov solves apply
    the operator's detached tensors (fused); the pullback through one
    apply records a graph (einsum); the gradient still matches JAX's."""
    pt, bt, rho, f, (_, _, g_rho_j, _) = _cube()
    r = torch.tensor(rho, requires_grad=True)
    op = tc.matfree_operator(pt, twf.diffusion(r)).condensed(bt)
    fwd, (u, info) = _action_paths(
        lambda: tc.matfree_solve(op, f, tc.SolverSpec(**SPEC), return_info=True))
    assert fwd["einsum"] == 0 and fwd["fused"] >= info.iters
    bwd, (g,) = _action_paths(lambda: torch.autograd.grad((u ** 2).sum(), r))
    assert bwd["einsum"] == 1 and bwd["fused"] >= 1
    _close(g, g_rho_j, 1e-8 * np.abs(g_rho_j).max())


@pytest.mark.cuda
def test_cuda_matfree_apply_launches(cuda):
    m = tc.unit_cube_tet(4)
    sp = tc.FunctionSpace(m, tc.element_for_mesh(m))
    plan = tc.build_plan(sp, device=cuda)
    rho = torch.rand(m.num_cells, dtype=torch.float64, device=cuda) + 0.5
    x = torch.randn(sp.num_dofs, dtype=torch.float64, device=cuda)
    kernels.reset_launches()
    op = tc.matfree_operator(plan, twf.diffusion(rho), store="local")
    assert kernels.LAUNCHES["local_stiffness_p1"] == 1
    y = op.matvec(x)
    assert kernels.LAUNCHES["seg_reduce"] == 1
    k = tc.assemble(plan, twf.diffusion(rho))
    torch.testing.assert_close(y, k.matvec(x), atol=1e-12, rtol=0)
    fam = tc.matfree_family(plan, twf.diffusion(rho), leaves_batch=(torch.stack([rho] * 2),
                                                                    None), store="local")
    kernels.reset_launches()
    fam.matvec(x)
    fam.diagonal()
    assert kernels.LAUNCHES["seg_reduce"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("gen,n", [("unit_cube_tet", 6), ("unit_square_tri", 12)])
def test_cuda_matfree_p1_kernel_matches_its_twin(cuda, gen, n, dtype):
    """The kernel against its plain twin on the card, (k, d) = (4, 3) and
    (3, 2), ρ per cell (q-stride 0) and per quadrature point, a device
    scale: 1e-13 in float64, 1e-5 of scale in float32."""
    dt = getattr(torch, dtype)
    m = getattr(tc, gen)(n)
    plan = tc.build_plan(tc.FunctionSpace(m, tc.element_for_mesh(m)), device=cuda)
    ctx = plan.context()
    grad, detj, w = ctx.grad.to(dt), ctx.detj.to(dt), ctx.w.to(dt)
    e, q = detj.shape
    x = torch.randn(plan.num_dofs, dtype=dt, device=cuda)
    tol = 1e-13 if dt == torch.float64 else 1e-5
    for rho, scale in (((torch.rand(e, dtype=dt, device=cuda) + 0.5)[:, None].expand(e, q), 0.7),
                       (torch.rand((e, q), dtype=dt, device=cuda) + 0.5,
                        torch.tensor(0.7, dtype=dt, device=cuda)),
                       (None, 1.0)):
        args = (x, plan.cell_dofs, grad, detj, w, rho, scale)
        got = kernels.matfree_p1_diffusion(*args)
        want = kernels.ref.matfree_p1_diffusion_ref(*args)
        torch.testing.assert_close(got, want, atol=tol * float(want.abs().max()), rtol=0)


@pytest.mark.cuda
def test_cuda_fused_apply_launches_and_solves(cuda):
    """One P1 diffusion apply launches the fused kernel once and B2 once,
    and no cuBLAS kernel; at unit_cube_tet(16) the matrix-free solve is
    within 1e-8 of ``ell``'s, its iterations within ±1."""
    from torch.profiler import ProfilerActivity, profile

    prob = ttm.PoissonProblem(tc.unit_cube_tet(16), device=cuda)
    rho = torch.rand(prob.plan.num_cells, dtype=torch.float64, device=cuda) + 0.5
    op = tc.matfree_operator(prob.plan, twf.diffusion(rho))
    x = torch.randn(prob.plan.num_dofs, dtype=torch.float64, device=cuda)
    op.matvec(x)
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = op.matvec(x)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["matfree_p1_diffusion"] == 1 and kernels.LAUNCHES["seg_reduce"] == 1
    names = [ev.key.lower() for ev in prof.key_averages()]
    assert not [k for k in names if "gemv" in k or "gemm" in k or "cublas" in k], names
    torch.testing.assert_close(y, tc.assemble(prob.plan, twf.diffusion(rho)).matvec(x),
                               atol=1e-12, rtol=0)
    mf, ell = prob.solve(backend="matfree"), prob.solve(backend="ell")
    assert abs(mf.iters - ell.iters) <= 1
    assert float((mf.u - ell.u).abs().max()) <= 1e-8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
