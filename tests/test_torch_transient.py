"""Torch port parity for ``repro_torch.transient``: θ-method (backward
Euler, Crank–Nicolson) rollouts on the ``csr``, ``ell`` and ``ell_stream``
backends against ``repro.transient`` on the same operators, time-varying
Dirichlet data, gradients of the ``csr`` rollout against ``jax.grad``,
checkpoint segmentation, and Newmark-β trajectories, energy and gradients
on every backend."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import weakform as jwf  # noqa: E402
from repro.transient import CRANK_NICOLSON as J_CN  # noqa: E402
from repro.transient import NewmarkIntegrator as JNewmark  # noqa: E402
from repro.transient import ThetaIntegrator as JTheta  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import convert, telemetry  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.transient import (  # noqa: E402
    BACKWARD_EULER,
    CRANK_NICOLSON,
    NewmarkIntegrator,
    ThetaIntegrator,
    axpy_csr,
    segmented_rollout,
)

MESHES = {"tri8": ("unit_square_tri", 8), "tet3": ("unit_cube_tet", 3)}


@functools.lru_cache(maxsize=None)
def _setup(mesh_key):
    """Both packages' assembler and condenser on one mesh, the JAX mass and
    stiffness matrices carried across with ``convert.from_numpy``, and a
    sine initial state masked to the free DoFs."""
    name, n = MESHES[mesh_key]
    jm = getattr(jc, name)(n)
    jsp = jc.FunctionSpace(jm, jc.mesh.element_for_mesh(jm))
    jasm = jc.GalerkinAssembler(jsp)
    jbc = jc.DirichletCondenser(jasm, jsp.boundary_dofs())
    jmass = jasm.assemble(jwf.mass(1.0))
    jstiff = jasm.assemble(jwf.diffusion(1.0))

    tm = getattr(tc, name)(n)
    tsp = tc.FunctionSpace(tm, tc.element_for_mesh(tm))
    tasm = tc.GalerkinAssembler(tsp, device="cpu")
    tbc = tc.DirichletCondenser(tasm, tsp.boundary_dofs())
    state = {}
    for key, op in (("mass", jmass), ("stiff", jstiff)):
        state.update({f"{key}.vals": np.asarray(op.vals), f"{key}.indptr": op.indptr,
                      f"{key}.indices": op.indices, f"{key}.shape": op.shape})
    st = convert.from_numpy(state, "cpu")
    pts = jsp.dof_points
    u0 = np.prod(np.sin(np.pi * pts), axis=1) * np.asarray(jbc.free_mask)
    return (jasm, jbc, jmass, jstiff), (tasm, tbc, st["mass"], st["stiff"]), u0


def _theta_pair(mesh_key, theta, backend, from_form):
    (jasm, jbc, jmass, jstiff), (tasm, tbc, tmass, tstiff), u0 = _setup(mesh_key)
    kw = dict(theta=theta, spec=None, backend=backend)
    if from_form:
        j = JTheta.from_form(jasm, jwf.diffusion(1.0), 5e-3, bc=jbc, **kw)
        t = ThetaIntegrator.from_form(tasm, twf.diffusion(1.0), 5e-3, bc=tbc, **kw)
    else:
        j = JTheta(jmass, jstiff, 5e-3, bc=jbc, **kw)
        t = ThetaIntegrator(tmass, tstiff, 5e-3, bc=tbc, **kw)
    return j, t, u0


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("theta", [BACKWARD_EULER, CRANK_NICOLSON])
@pytest.mark.parametrize("backend", ["csr", "ell", "ell_stream", "matfree"])
def test_theta_rollout_matches_jax(mesh_key, theta, backend):
    """Three steps of each method on each backend: trajectories to 1e-10,
    per-step iterations within ±1 (the JAX ``ell_stream`` run is the
    interpret-mode Pallas kernel; ``matfree`` on tet3 steps on matrix-free
    operators from ``from_form``, on tri8 through ``matfree_solve`` on the
    assembled ones)."""
    j, t, u0 = _theta_pair(mesh_key, theta, backend, from_form=(mesh_key == "tet3"))
    jtraj, jinfo = j.rollout(jnp.asarray(u0), 3, return_info=True)
    ttraj, tinfo = t.rollout(torch.as_tensor(u0), 3, return_info=True)
    assert tuple(ttraj.shape) == (3, u0.shape[0])
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), atol=1e-10, rtol=0)
    assert tinfo.iters.shape == (3,) and tinfo.iters.dtype == torch.int64
    assert tinfo.residual.dtype == torch.float64 and bool(tinfo.converged.all())
    np.testing.assert_allclose(tinfo.iters.numpy(), np.asarray(jinfo.iters), atol=1)


def test_theta_ell_stream_equals_ell_bitwise():
    """The streaming and broadcast plans sum each row in one order, so the
    two backends give the same rollout."""
    _, a, u0 = _theta_pair("tri8", CRANK_NICOLSON, "ell", from_form=True)
    _, b, _ = _theta_pair("tri8", CRANK_NICOLSON, "ell_stream", from_form=True)
    ta, ia = a.rollout(torch.as_tensor(u0), 5, return_info=True)
    tb, ib = b.rollout(torch.as_tensor(u0), 5, return_info=True)
    torch.testing.assert_close(ta, tb, atol=0, rtol=0)
    assert torch.equal(ia.iters, ib.iters)


def test_theta_exact_on_linear_in_time_with_moving_dirichlet():
    """u(x,t) = t(1+x+y): backward Euler reproduces it to solver tolerance
    with per-step Dirichlet data and a static load (as the JAX test)."""
    (jasm, jbc, jmass, jstiff), (tasm, tbc, tmass, tstiff), _ = _setup("tri8")
    pts = tasm.space.dof_points
    w = 1.0 + pts[:, 0] + pts[:, 1]
    n_steps, dt = 10, 0.01
    g = np.stack([(n + 1) * dt * w[tbc.bc_dofs] for n in range(n_steps)])
    spec_j, spec_t = jc.SolverSpec(method="cg", tol=1e-13), tc.SolverSpec(method="cg", tol=1e-13)
    jtraj = JTheta(jmass, jstiff, dt, theta=1.0, bc=jbc, spec=spec_j).rollout(
        jnp.zeros(w.shape[0]), n_steps, loads=jmass.matvec(jnp.asarray(w)),
        bc_values=jnp.asarray(g))
    for backend in ("csr", "ell_stream"):
        integ = ThetaIntegrator(tmass, tstiff, dt, theta=1.0, bc=tbc, spec=spec_t,
                                backend=backend)
        traj = integ.rollout(torch.zeros(w.shape[0], dtype=torch.float64), n_steps,
                             loads=tmass.matvec(torch.as_tensor(w)), bc_values=g)
        np.testing.assert_allclose(traj[-1].numpy(), n_steps * dt * w, atol=1e-10)
        np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-10)
    with pytest.raises(ValueError, match="not understood"):
        integ.rollout(torch.zeros(w.shape[0], dtype=torch.float64), n_steps,
                      bc_values=np.zeros((n_steps, 3)))


def _lhs_loss_inputs():
    (jasm, jbc, jmass, jstiff), (tasm, tbc, tmass, tstiff), u0 = _setup("tri8")
    dt, theta = 0.01, CRANK_NICOLSON
    lhs = np.asarray(jmass.vals) + theta * dt * np.asarray(jstiff.vals)
    rhs = np.asarray(jmass.vals) - (1 - theta) * dt * np.asarray(jstiff.vals)
    wts = np.random.default_rng(0).normal(size=(8, u0.shape[0]))
    return (jbc, jmass), (tbc, tmass), u0, lhs, rhs, wts, dt


@pytest.mark.parametrize("checkpoint_every", [None, 4])
def test_csr_rollout_gradients_match_jax(checkpoint_every):
    """∂/∂u₀ and ∂/∂(lhs values) of a weighted trajectory loss through the
    ``csr`` rollout (adjoint solves) match ``jax.grad`` to 1e-8 relative,
    with and without checkpoint segments."""
    (jbc, jmass), (tbc, tmass), u0, lhs, rhs, wts, dt = _lhs_loss_inputs()
    spec_j = jc.SolverSpec(method="cg", tol=1e-13, atol=1e-15)
    spec_t = tc.SolverSpec(method="cg", tol=1e-13, atol=1e-15)

    def jcsr(vals):
        return jc.CSR(vals, jmass.indptr, jmass.indices, jmass.row_of_nnz, jmass.shape,
                      jmass.diag_pos)

    def jloss(u, lv):
        integ = JTheta(None, None, dt, theta=J_CN, bc=jbc, spec=spec_j, lhs_full=jcsr(lv),
                       rhs_op=jcsr(jnp.asarray(rhs)))
        return jnp.sum(jnp.asarray(wts) * integ.rollout(u, 8, checkpoint_every=checkpoint_every))

    jg_u, jg_l = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0), jnp.asarray(lhs))
    u = torch.as_tensor(u0).clone().requires_grad_()
    lv = torch.as_tensor(lhs).clone().requires_grad_()
    integ = ThetaIntegrator(None, None, dt, theta=CRANK_NICOLSON, bc=tbc, spec=spec_t,
                            lhs_full=tmass.with_vals(lv),
                            rhs_op=tmass.with_vals(torch.as_tensor(rhs)))
    traj = integ.rollout(u, 8, checkpoint_every=checkpoint_every)
    loss = (torch.as_tensor(wts) * traj).sum()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jnp.asarray(u0), jnp.asarray(lhs))),
                               rtol=1e-12)
    loss.backward()
    for got, want in ((u.grad, jg_u), (lv.grad, jg_l)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-8 * np.abs(want).max(), rtol=0)


def test_theta_matfree_equals_csr_and_gradient_matches_jax():
    """Crank–Nicolson on matrix-free operators against the assembled
    ``csr`` rollout (1e-10, iterations ±1), and ∂/∂κ of the trajectory's
    squared norm through ``matfree_solve`` against ``jax.grad`` (1e-8
    relative)."""
    (jasm, jbc, _, _), (tasm, tbc, _, _), u0 = _setup("tri8")
    spec = dict(method="cg", tol=1e-12, atol=1e-12)

    def torch_integ(kappa, backend):
        return ThetaIntegrator.from_form(tasm, twf.diffusion(kappa), 0.01, theta=CRANK_NICOLSON,
                                         bc=tbc, spec=tc.SolverSpec(**spec), backend=backend)

    trajs = {be: torch_integ(1.3, be).rollout(torch.as_tensor(u0), 4, return_info=True)
             for be in ("matfree", "csr")}
    torch.testing.assert_close(trajs["matfree"][0], trajs["csr"][0], atol=1e-10, rtol=0)
    assert (trajs["matfree"][1].iters - trajs["csr"][1].iters).abs().max() <= 1

    @jax.jit
    def jgrad(kappa):
        def loss(c):
            integ = JTheta.from_form(jasm, jwf.diffusion(c), 0.01, theta=J_CN, bc=jbc,
                                     spec=jc.SolverSpec(**spec), backend="matfree")
            return jnp.sum(integ.rollout(jnp.asarray(u0), 3) ** 2)

        return jax.value_and_grad(loss)(kappa)

    jval, jg = jgrad(1.3)
    kappa = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    loss = (torch_integ(kappa, "matfree").rollout(torch.as_tensor(u0), 3) ** 2).sum()
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-12)
    g, = torch.autograd.grad(loss, kappa)
    assert float(g) == pytest.approx(float(jg), rel=1e-8)


def test_checkpoint_segments_preserve_values_and_grads():
    (_, _), (tbc, tmass), u0, lhs, rhs, wts, dt = _lhs_loss_inputs()
    spec = tc.SolverSpec(method="cg", tol=1e-13, atol=1e-15)
    outs = []
    for ck in (None, 4, 2):
        u = torch.as_tensor(u0).clone().requires_grad_()
        integ = ThetaIntegrator(None, None, dt, theta=CRANK_NICOLSON, bc=tbc, spec=spec,
                                lhs_full=tmass.with_vals(torch.as_tensor(lhs)),
                                rhs_op=tmass.with_vals(torch.as_tensor(rhs)))
        loss = (integ.rollout(u, 8, checkpoint_every=ck) ** 2).sum()
        loss.backward()
        outs.append((float(loss.detach()), u.grad))
    for val, grad in outs[1:]:
        assert val == pytest.approx(outs[0][0], rel=1e-14)
        torch.testing.assert_close(grad, outs[0][1], atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="must divide"):
        segmented_rollout(lambda c, _: (c, c), torch.zeros(2), None, 7, checkpoint_every=3)


def test_axpy_and_converted_operators_share_one_pattern():
    _, (tasm, _, tmass, tstiff), _ = _setup("tri8")
    assert tmass.pattern is tstiff.pattern
    both = axpy_csr(1.0, tmass, 0.5, tstiff)
    assert both.pattern is tmass.pattern
    torch.testing.assert_close(both.vals, tmass.vals + 0.5 * tstiff.vals)
    own = tasm.assemble(twf.mass(1.0))
    np.testing.assert_array_equal(own.indices, tmass.indices)
    torch.testing.assert_close(axpy_csr(1.0, own, -1.0, tmass).vals, torch.zeros_like(own.vals),
                               atol=1e-15, rtol=0)
    other = tc.CSR.from_arrays(tmass.vals[:-1], np.r_[tmass.indptr[:-1], tmass.nnz - 1],
                               tmass.indices[:-1], tmass.shape)
    with pytest.raises(ValueError, match="one sparsity pattern"):
        axpy_csr(1.0, tmass, 1.0, other)


def test_matfree_backends_are_not_ported_yet():
    # (the name is kept from before the sharded backend was ported) on
    # assembled operators both matrix-free backends step through
    # matfree_solve (sparse_solve's adjoint on a CSR), equal to the csr
    # rollout; the sharded backend shards only matrix-free operators
    _, (tasm, tbc, tmass, tstiff), u0 = _setup("tri8")
    u0 = torch.as_tensor(u0)
    want = ThetaIntegrator(tmass, tstiff, 0.01, bc=tbc, backend="csr").rollout(u0, 3)
    for backend in ("matfree", "matfree_sharded"):
        integ = ThetaIntegrator(tmass, tstiff, 0.01, bc=tbc, backend=backend)
        assert isinstance(integ.lhs_full, tc.CSR)
        torch.testing.assert_close(integ.rollout(u0, 3), want, atol=1e-14, rtol=0)


def test_rollout_info_feeds_telemetry():
    _, t, u0 = _theta_pair("tri8", BACKWARD_EULER, "ell_stream", from_form=True)
    telemetry.reset()
    with telemetry.enabled():
        _, info = t.rollout(torch.as_tensor(u0), 4, return_info=True)
        snap = telemetry.snapshot()
        events = [e for e in telemetry.event_log() if e["name"] == "theta.rollout"]
    assert events[-1]["n_solves"] == 4 and events[-1]["iterations"] == int(info.iters.sum())
    assert any(k.startswith("solves{") and "ell_stream" in k for k in snap["counters"])
    telemetry.reset()
    bad = t.spec.replace(maxiter=1)
    t2 = ThetaIntegrator(None, None, t.dt, bc=t.bc, spec=bad, backend="ell_stream",
                         lhs_full=t.lhs_full, rhs_op=t.rhs_op)
    with pytest.warns(telemetry.ConvergenceWarning, match="4 solves"):
        t2.rollout(torch.as_tensor(u0), 4, return_info=True)


# ---------------------------------------------------------------------------
# Newmark-β
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_key,backend", [("tri8", "csr"), ("tri8", "ell_stream"),
                                              ("tet3", "ell")])
def test_newmark_matches_jax(mesh_key, backend):
    (_, jbc, jmass, jstiff), (_, tbc, tmass, tstiff), u0 = _setup(mesh_key)
    spec_j, spec_t = jc.SolverSpec(method="cg", tol=1e-12), tc.SolverSpec(method="cg", tol=1e-12)
    ju, jv = JNewmark(jmass, jstiff, 0.01, bc=jbc, spec=spec_j).rollout(
        jnp.asarray(u0), 10, return_velocity=True)
    (tu, tv), info = NewmarkIntegrator(tmass, tstiff, 0.01, bc=tbc, spec=spec_t,
                                       backend=backend).rollout(
        torch.as_tensor(u0), 10, return_velocity=True, return_info=True)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-10, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-10, rtol=0)
    assert info.iters.shape == (10,) and bool(info.converged.all())


def test_newmark_energy_conservation():
    """β=¼, γ=½ with F = 0 conserves E = ½(vᵀMv + uᵀKu) to solver
    tolerance over 200 steps (the JAX test's setting), on the streaming
    stiffness applies."""
    _, (_, tbc, tmass, tstiff), u0 = _setup("tri8")
    nm = NewmarkIntegrator(tmass, tstiff, dt=0.01, bc=tbc, backend="ell_stream",
                           spec=tc.SolverSpec(method="cg", tol=1e-12))
    u0 = torch.as_tensor(u0)
    u_traj, v_traj = nm.rollout(u0, 200, return_velocity=True)
    assert torch.isfinite(u_traj).all()

    def energy(u, v):
        return 0.5 * (v @ tmass.matvec(v) + u @ tstiff.matvec(u))

    e0 = energy(u0, torch.zeros_like(u0))
    drift = max(abs(float(energy(u, v) - e0)) for u, v in zip(u_traj, v_traj)) / float(e0)
    assert drift < 1e-6, f"Newmark energy drift {drift}"


@pytest.mark.parametrize("backend", ["csr", "ell", "ell_stream"])
def test_newmark_rollout_gradients_match_jax(backend):
    """∂/∂u₀ and ∂/∂(stiffness values) of a weighted trajectory loss through
    a Newmark rollout (adjoint solves, and the stiffness applies K·u* on
    ``backend``) match ``jax.grad`` to 1e-8 relative, as the θ rollout's at
    ``test_csr_rollout_gradients_match_jax``.  The JAX side runs ``csr`` or
    its plain-jnp ``ell`` backend."""
    (_, jbc, jmass, jstiff), (_, tbc, tmass, tstiff), u0 = _setup("tri8")
    spec_j = jc.SolverSpec(method="cg", tol=1e-13, atol=1e-15)
    spec_t = tc.SolverSpec(method="cg", tol=1e-13, atol=1e-15)
    wts = np.random.default_rng(1).normal(size=(6, u0.shape[0]))
    kv0 = np.array(jstiff.vals)

    def jloss(u, kv):
        k = jc.CSR(kv, jstiff.indptr, jstiff.indices, jstiff.row_of_nnz, jstiff.shape,
                   jstiff.diag_pos)
        nm = JNewmark(jmass, k, 0.01, bc=jbc, spec=spec_j,
                      backend="csr" if backend == "csr" else "ell")
        return jnp.sum(jnp.asarray(wts) * nm.rollout(u, 6))

    jg_u, jg_k = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0), jnp.asarray(kv0))
    u = torch.as_tensor(u0).clone().requires_grad_()
    kv = torch.as_tensor(kv0).clone().requires_grad_()
    nm = NewmarkIntegrator(tmass, tstiff.with_vals(kv), 0.01, bc=tbc, spec=spec_t,
                           backend=backend)
    loss = (torch.as_tensor(wts) * nm.rollout(u, 6)).sum()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jnp.asarray(u0),
                                                                 jnp.asarray(kv0))), rtol=1e-12)
    loss.backward()
    for got, want in ((u.grad, jg_u), (kv.grad, jg_k)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-8 * np.abs(want).max(), rtol=0)
