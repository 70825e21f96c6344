"""Torch port parity for ``NewtonKrylovIntegrator`` (backward Euler +
Newton on Allen–Cahn, the JAX test's set-up on unit_square_tri(8)), the
``reaction`` form, and the batched rollouts (``batched_rollout``,
``batched_theta_rollout`` over ``BatchedCSR`` and ``MatFreeFamily``
pairs) against ``repro.transient``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import weakform as jwf  # noqa: E402
from repro.transient import NewtonKrylovIntegrator as JNewton  # noqa: E402
from repro.transient import ThetaIntegrator as JTheta  # noqa: E402
from repro.transient import batched_rollout as j_batched_rollout  # noqa: E402
from repro.transient import batched_theta_rollout as j_batched_theta_rollout  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.transient import (  # noqa: E402
    NewtonKrylovIntegrator,
    ThetaIntegrator,
    batched_rollout,
    batched_theta_rollout,
)

EPS2, KAPPA, DT = 1.0, 1e-2, 1e-3


def reaction(u):
    return -EPS2 * u * (u ** 2 - 1.0)


@functools.lru_cache(maxsize=None)
def _setup(n=8):
    """Both packages' assembler, condenser, mass and stiffness on
    unit_square_tri(n), and u0 = sin(πx)sin(πy) on the free DoFs."""
    jm, tm = jc.unit_square_tri(n), tc.unit_square_tri(n)
    jsp = jc.FunctionSpace(jm, jc.mesh.element_for_mesh(jm))
    tsp = tc.FunctionSpace(tm, tc.element_for_mesh(tm))
    jasm, tasm = jc.GalerkinAssembler(jsp), tc.GalerkinAssembler(tsp, device="cpu")
    jbc = jc.DirichletCondenser(jasm, jsp.boundary_dofs())
    tbc = tc.DirichletCondenser(tasm, tsp.boundary_dofs())
    pts = jsp.dof_points
    u0 = np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1]) * np.asarray(jbc.free_mask)
    j = (jasm, jbc, jasm.assemble(jwf.mass(1.0)), jasm.assemble(jwf.diffusion(1.0)))
    t = (tasm, tbc, tasm.assemble(twf.mass(1.0)), tasm.assemble(twf.diffusion(1.0)))
    return j, t, u0


def _newton_pair(newton_iters=4, **kw):
    (jasm, jbc, jm, jk), (tasm, tbc, tm, tk), u0 = _setup()
    spec = dict(method="cg", tol=1e-12, atol=1e-12)
    j = JNewton(jasm, jm, jk, dt=DT, reaction=reaction, diffusion_scale=KAPPA, bc=jbc,
                newton_iters=newton_iters, spec=jc.SolverSpec(**spec))
    t = NewtonKrylovIntegrator(tasm, tm, tk, dt=DT, reaction=reaction, diffusion_scale=KAPPA,
                               bc=tbc, newton_iters=newton_iters, spec=tc.SolverSpec(**spec),
                               **kw)
    return j, t, u0


def test_newton_krylov_allen_cahn_matches_jax():
    """5 steps, 4 Newton iterations: the trajectory against JAX to 1e-10,
    the last step's residual below the JAX test's 1e-8, per-step Krylov
    iterations within ±1 of JAX's, and the jvp-derived r′ against the
    closed form −ε²(3u²−1)."""
    j, t, u0 = _newton_pair()
    jtraj, jinfo = j.rollout(jnp.asarray(u0), 5, return_info=True)
    traj, info = t.rollout(torch.as_tensor(u0), 5, return_info=True)
    assert tuple(traj.shape) == (5, u0.shape[0]) and not bool(torch.isnan(traj).any())
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-10, rtol=0)
    np.testing.assert_allclose(info.iters.numpy(), np.asarray(jinfo.iters), atol=1)
    assert bool(info.converged.all())
    res = t.residual(traj[-2], traj[-1])
    assert float(torch.linalg.vector_norm(res)) < 1e-8
    u = torch.linspace(-1.5, 1.5, 7, dtype=torch.float64)
    torch.testing.assert_close(t.reaction_prime(u), -EPS2 * (3 * u ** 2 - 1.0), atol=1e-12,
                               rtol=0)


def test_reaction_form_and_given_derivative():
    """``weakform.reaction`` against the JAX load, and a closed-form r′
    giving the jvp-derived trajectory."""
    (jasm, _, _, _), (tasm, _, _, _), u0 = _setup()
    np.testing.assert_allclose(
        tasm.assemble_rhs(twf.reaction(torch.as_tensor(u0), reaction)).numpy(),
        np.asarray(jasm.assemble_rhs(jwf.reaction(jnp.asarray(u0), reaction))),
        atol=1e-14, rtol=0)
    _, auto, _ = _newton_pair(newton_iters=2)
    _, given, _ = _newton_pair(newton_iters=2,
                               reaction_prime=lambda u: -EPS2 * (3 * u ** 2 - 1.0))
    u = torch.as_tensor(u0)
    torch.testing.assert_close(auto.rollout(u, 2), given.rollout(u, 2), atol=1e-14, rtol=0)


def test_newton_rollout_gradient_matches_jax():
    """∂/∂u₀ of a weighted trajectory loss through two steps (adjoint
    sparse solves, r′ differentiated) against ``jax.grad``, 1e-8."""
    j, t, u0 = _newton_pair(newton_iters=2)
    wts = np.random.default_rng(0).normal(size=(2, u0.shape[0]))
    jg = jax.grad(lambda u: jnp.sum(jnp.asarray(wts) * j.rollout(u, 2)))(jnp.asarray(u0))
    u = torch.tensor(u0, requires_grad=True)
    g, = torch.autograd.grad((torch.as_tensor(wts) * t.rollout(u, 2)).sum(), u)
    jg = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), jg, atol=1e-8 * np.abs(jg).max(), rtol=0)


def test_batched_rollout_matches_jax():
    (jasm, jbc, jm, jk), (tasm, tbc, tm, tk), u0 = _setup()
    u0s = u0[None] * np.array([1.0, 0.5, -2.0])[:, None]
    j = JTheta(jm, jk, 0.01, theta=0.5, bc=jbc)
    t = ThetaIntegrator(tm, tk, 0.01, theta=0.5, bc=tbc)
    jt = j_batched_rollout(j, jnp.asarray(u0s), 3)
    tt = batched_rollout(t, torch.as_tensor(u0s), 3)
    assert tuple(tt.shape) == (3, 3, u0.shape[0])
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-10, rtol=0)


@pytest.mark.parametrize("family", ["batched_csr", "matfree_family"])
def test_batched_theta_rollout_matches_jax(family):
    """A family of 3 conductivity fields, backward Euler over 4 steps, on
    ``BatchedCSR`` or ``MatFreeFamily`` operator pairs: the JAX call to
    1e-10, and each instance its own single rollout."""
    (jasm, jbc, _, _), (tasm, tbc, _, _), u0 = _setup()
    rng = np.random.default_rng(1)
    e, n = tasm.plan.num_cells, u0.shape[0]
    kap = rng.uniform(0.5, 2.0, (3, e))
    u0s = rng.normal(size=(3, n)) * np.asarray(jbc.free_mask)
    dt, theta = 0.01, 1.0

    def pair(pkg, wf, plan, kb):
        lhs = wf.mass(1.0) + (theta * dt) * wf.diffusion(kb[0])
        rhs = wf.mass(1.0) + (-(1 - theta) * dt) * wf.diffusion(kb[0])
        lb = (None, None, kb, None)
        build = pkg.assemble_batched if family == "batched_csr" else pkg.matfree_family
        return build(plan, lhs, leaves_batch=lb), build(plan, rhs, leaves_batch=lb)

    jl, jr = pair(jc, jwf, jasm.plan, jnp.asarray(kap))
    tl, tr = pair(tc, twf, tasm.plan, torch.as_tensor(kap))
    jt = j_batched_theta_rollout(jl, jr, jnp.asarray(u0s), 4, dt=dt, theta=theta, bc=jbc)
    tt = batched_theta_rollout(tl, tr, torch.as_tensor(u0s), 4, dt=dt, theta=theta, bc=tbc)
    assert tuple(tt.shape) == (3, 4, n)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-10, rtol=0)
    backend = "csr" if family == "batched_csr" else "matfree"
    one = ThetaIntegrator(None, None, dt, theta=theta, bc=tbc, lhs_full=tl[1], rhs_op=tr[1],
                          backend=backend).rollout(torch.as_tensor(u0s[1]), 4)
    torch.testing.assert_close(tt[1], one, atol=1e-14, rtol=0)
