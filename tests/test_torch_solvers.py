"""Torch port parity: CG / BiCGSTAB on the same condensed systems as the
JAX package, ``sparse_solve`` gradients against ``jax.grad``, and the
solver, preconditioner, matvec-backend and telemetry registries."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
from repro.core import weakform as jwf  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import convert, telemetry  # noqa: E402
from repro_torch.core import matvec as tmatvec  # noqa: E402


@functools.lru_cache(maxsize=None)
def _condensed(kind):
    """A condensed system assembled by the JAX package, exported as numpy:
    'spd' (P1 Poisson, variable ρ) or 'nonsym' (advection–diffusion)."""
    m = jc.unit_square_tri(10)
    asm = jc.GalerkinAssembler(jc.FunctionSpace(m, jc.mesh.element_for_mesh(m)))
    bc = jc.DirichletCondenser(asm, asm.space.boundary_dofs())
    if kind == "spd":
        form = jwf.diffusion(lambda x: 1.0 + x[..., 0])
    else:
        form = jwf.diffusion(0.05) + jwf.advection(jnp.asarray([1.0, 0.5]))
    k, f = bc.apply(asm.assemble(form), asm.assemble_rhs(jwf.source(1.0)))
    state = {"vals": np.asarray(k.vals), "indptr": k.indptr, "indices": k.indices,
             "shape": k.shape, "f": np.asarray(f)}
    return k, f, convert.from_numpy(state, "cpu")


@pytest.mark.parametrize("kind,method", [("spd", "cg"), ("spd", "bicgstab"),
                                         ("nonsym", "bicgstab")])
@pytest.mark.parametrize("precond", ["jacobi", "identity"])
def test_krylov_matches_jax(kind, method, precond):
    kj, fj, st = _condensed(kind)
    solver_j = {"cg": jc.cg, "bicgstab": jc.bicgstab}[method]
    solver_t = {"cg": tc.cg, "bicgstab": tc.bicgstab}[method]
    uj, ij = solver_j(kj.matvec, fj, m=jc.make_preconditioner(kj, precond))
    for backend in ("csr", "ell"):
        k = st["csr"]
        ut, it = solver_t(tc.make_matvec(k, backend), st["f"],
                          m=tc.make_preconditioner(k, precond))
        assert abs(it.iters - int(ij.iters)) <= 1, (it, ij)
        assert it.converged and bool(ij.converged)
        scale = float(np.abs(np.asarray(uj)).max())
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-9 * scale, rtol=0)


@pytest.mark.parametrize("kind,method", [("spd", "cg"), ("nonsym", "bicgstab")])
def test_sparse_solve_gradients_match_jax(kind, method):
    kj, fj, st = _condensed(kind)
    w = np.random.default_rng(0).normal(size=fj.shape[0])
    spec_j = jc.SolverSpec(method=method, tol=1e-14, atol=1e-16)
    spec_t = tc.SolverSpec(method=method, tol=1e-14, atol=1e-16)

    def loss(vals, b):
        return jnp.sum(jnp.asarray(w) * jc.sparse_solve(
            jc.CSR(vals, kj.indptr, kj.indices, kj.row_of_nnz, kj.shape, kj.diag_pos),
            b, spec_j))

    gv_j, gb_j = jax.grad(loss, argnums=(0, 1))(kj.vals, fj)
    vals = st["csr"].vals.clone().requires_grad_()
    b = st["f"].clone().requires_grad_()
    x, info = tc.sparse_solve(st["csr"].with_vals(vals), b, spec_t, return_info=True)
    assert info.converged
    (x * torch.as_tensor(w)).sum().backward()
    for got, want in ((vals.grad, gv_j), (b.grad, gb_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10 * np.abs(want).max(), rtol=0)


def test_preconditioner_registry():
    _, _, st = _condensed("spd")
    k = st["csr"]
    x = torch.ones(k.shape[0], dtype=torch.float64)
    assert torch.equal(tc.make_preconditioner(k, None)(x), x)
    assert torch.equal(tc.make_preconditioner(k, "none")(x), x)
    d = k.diagonal()
    assert torch.allclose(tc.make_preconditioner(k, "jacobi")(x), 1.0 / d)
    assert tc.cached_diagonal(k) is tc.cached_diagonal(k)
    cheb = tc.make_preconditioner(k, "chebyshev")  # registered by elemalg, looked up lazily
    assert cheb(x).shape == x.shape and torch.isfinite(cheb(x)).all()
    with pytest.raises(KeyError, match="registered"):
        tc.make_preconditioner(k, "does-not-exist")
    tc.register_preconditioner("half_test", lambda op: (lambda v: 0.5 * v), overwrite=True)
    assert torch.equal(tc.make_preconditioner(k, "half_test")(x), 0.5 * x)
    with pytest.raises(ValueError):
        tc.register_preconditioner("jacobi", tc.jacobi_preconditioner)


def test_solver_spec_resolution():
    spec = tc.SolverSpec(method="cg")
    assert tc.resolve_solver_spec(spec) is spec
    with pytest.warns(DeprecationWarning):
        got = tc.resolve_solver_spec(None, tol=1e-6, default=spec)
    assert got == spec.replace(tol=1e-6)
    with pytest.raises(TypeError):
        tc.resolve_solver_spec(object())


def test_matvec_registry():
    _, _, st = _condensed("nonsym")
    k, f = st["csr"], st["f"]
    x = torch.as_tensor(np.random.default_rng(2).normal(size=k.shape[0]))
    want = k.matvec(x)
    for backend in ("csr", "ell", "ell_pallas", "ell_stream"):
        torch.testing.assert_close(tc.make_matvec(k, backend)(x), want, atol=1e-13, rtol=0)
        torch.testing.assert_close(tc.make_residual(k, backend)(x, f), want - f,
                                   atol=1e-13, rtol=0)
    # matfree and matfree_sharded run a matrix-free operator (not an assembled one)
    m = tc.unit_square_tri(4)
    plan = tc.build_plan(tc.FunctionSpace(m, tc.element_for_mesh(m)), device="cpu")
    op = tc.matfree_operator(plan, tc.weakform.diffusion(1.5))
    xm = torch.as_tensor(np.random.default_rng(4).normal(size=plan.num_dofs))
    want_m = tc.assemble(plan, tc.weakform.diffusion(1.5)).matvec(xm)
    torch.testing.assert_close(tc.make_matvec(op, "matfree")(xm), want_m, atol=1e-13, rtol=0)
    torch.testing.assert_close(tc.make_residual(op, "matfree")(xm, xm), want_m - xm,
                               atol=1e-13, rtol=0)
    with pytest.raises(TypeError, match="matrix-free operator"):
        tc.make_matvec(k, "matfree")
    with pytest.raises(TypeError, match="matrix-free"):
        tc.make_matvec(k, "matfree_sharded")
    torch.testing.assert_close(tc.make_matvec(op, "matfree_sharded")(xm), want_m, atol=1e-13,
                               rtol=0)
    with pytest.raises(ValueError):
        tc.make_matvec(k, "nope")
    tc.register_matvec_backend("double_test", lambda op: (lambda v: 2 * op.matvec(v)),
                               overwrite=True)
    torch.testing.assert_close(tc.make_residual(k, "double_test")(x, f), 2 * want - f)
    assert "double_test" in tc.matvec_backends() and "double_test" not in tc.MATVEC_BACKENDS
    assert set(tmatvec.MATVEC_BACKENDS) == set(jc.MATVEC_BACKENDS)


def test_rmatvec_and_dense_match_jax():
    kj, _, st = _condensed("nonsym")
    x = np.random.default_rng(3).normal(size=kj.shape[0])
    np.testing.assert_allclose(st["csr"].rmatvec(torch.as_tensor(x)).numpy(),
                               np.asarray(kj.rmatvec(jnp.asarray(x))), atol=1e-13)
    np.testing.assert_array_equal(st["csr"].to_dense().numpy(), np.asarray(kj.to_dense()))
    np.testing.assert_array_equal(st["csr"].to_scipy().toarray(), kj.to_scipy().toarray())


def test_matvec_over_leading_axes_matches_jax_vmap():
    """``CSR.matvec`` on ``(T, B, n)`` is the 1-D matvec of each row, as
    ``jax.vmap`` of the reference's matvec gives it."""
    kj, _, st = _condensed("nonsym")
    x = np.random.default_rng(5).normal(size=(3, 2, kj.shape[0]))
    got = st["csr"].matvec(torch.as_tensor(x))
    assert got.shape == (3, 2, kj.shape[0])
    want = jax.vmap(jax.vmap(kj.matvec))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)
    for t in range(3):
        for b in range(2):
            torch.testing.assert_close(got[t, b], st["csr"].matvec(torch.as_tensor(x[t, b])),
                                       rtol=0, atol=0)


def test_convergence_policy_and_telemetry():
    _, _, st = _condensed("spd")
    k, f = st["csr"], st["f"]
    assert not telemetry.is_enabled()
    _, info = tc.cg(k, f, maxiter=2)
    assert info.iters == 2 and not info.converged
    with pytest.warns(telemetry.ConvergenceWarning):
        telemetry.check_convergence(info, where="test")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        telemetry.check_convergence(info, on_fail="ignore")
    telemetry.reset()
    with telemetry.enabled(on_nonconverged="raise"):
        with pytest.raises(telemetry.NonConvergedError):
            telemetry.check_convergence(info)
        tc.sparse_solve(k, f, tc.SolverSpec(method="cg"), return_info=True)
        snap = telemetry.snapshot()
    assert not telemetry.is_enabled()
    assert any(key.startswith("solves{") for key in snap["counters"])
    assert any(key.startswith("solve_iterations{") for key in snap["histograms"])
    telemetry.reset()
