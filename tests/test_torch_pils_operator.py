"""Torch port parity for ``repro.pils.operator``: ``TimeDependentProblem``
(the wave and Allen–Cahn residuals, the lumped-mass wave residual, the
Newmark and Newton–Krylov reference trajectories and the trajectory
losses), ``wave_residuals`` / ``allen_cahn_residuals`` and the sine-field
initial condition, against the JAX package on the disk meshes of its
tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.pils import operator as jop  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch.pils import operator as top  # noqa: E402


@functools.lru_cache(maxsize=None)
def _pair(n_r=6, **kw):
    kw = dict(kw)
    return (jop.TimeDependentProblem(jc.disk_tri(n_r), **kw),
            top.TimeDependentProblem(tc.disk_tri(n_r), **kw, device="cpu"))


def _u0(prob, seed):
    """The JAX package's initial condition from PRNGKey(seed), masked."""
    u = jop.random_initial_condition(jax.random.PRNGKey(seed), prob.space.dof_points)
    return np.array(u * prob.bc.free_mask)


def test_sine_field_matches_random_initial_condition():
    """The port's sine expansion on the amplitudes that JAX draws from the
    same key equals ``random_initial_condition`` (1e-13); the port's own
    draw is a field of the same family, reproducible from its generator."""
    jprob, tprob = _pair()
    pts = jprob.space.dof_points
    for seed, kw in ((0, {}), (3, dict(k_modes=4, r=1.0, domain_scale=2.0))):
        key = jax.random.PRNGKey(seed)
        k_modes = kw.get("k_modes", 6)
        a = np.array(jax.random.uniform(key, (k_modes, k_modes), minval=-1.0, maxval=1.0))
        want = np.asarray(jop.random_initial_condition(key, pts, **kw))
        got = top._sine_field(torch.as_tensor(a), pts, kw.get("r", 0.5),
                              kw.get("domain_scale", 1.0))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    u1 = top.random_initial_condition(torch.Generator().manual_seed(5), pts, device="cpu")
    u2 = top.random_initial_condition(torch.Generator().manual_seed(5), pts, device="cpu")
    assert u1.shape == (pts.shape[0],) and u1.dtype == torch.float64 and torch.equal(u1, u2)
    assert 0 < float(u1.abs().max()) < np.pi / 36 * 6 * 6


def _traj(n_steps=6, seed=1):
    rng = np.random.default_rng(seed)
    jprob, _ = _pair()
    return rng.normal(size=(n_steps, jprob.n)) * np.asarray(jprob.bc.free_mask)


def test_matrices_and_masks_match_jax():
    jprob, tprob = _pair()
    assert tprob.n == jprob.n and tprob.device.type == "cpu"
    for name in ("mass", "stiff"):
        np.testing.assert_allclose(getattr(tprob, name).vals.numpy(),
                                   np.asarray(getattr(jprob, name).vals), rtol=0, atol=1e-14)
    assert np.array_equal(tprob.interior.numpy(), np.asarray(jprob.interior))


@pytest.mark.parametrize("normalized", [False, True])
def test_wave_residuals_match_jax(normalized):
    """The per-step wave residuals of a trajectory (one batched matvec over
    the time axis) and the trajectory loss against JAX's vmapped ones,
    1e-12 of their scale."""
    jprob, tprob = _pair()
    traj = _traj()
    jt, tt = jnp.asarray(traj), torch.as_tensor(traj)
    if normalized:
        want = np.asarray(jax.vmap(jprob.wave_residual_normalized)(jt[:-2], jt[1:-1], jt[2:]))
        got = tprob.wave_residual_normalized(tt[:-2], tt[1:-1], tt[2:]).numpy()
    else:
        want = np.asarray(jop.wave_residuals(jprob, jt))
        got = top.wave_residuals(tprob, tt).numpy()
        one = tprob.wave_residual(tt[0], tt[1], tt[2]).numpy()
        np.testing.assert_allclose(one, want[0], rtol=0, atol=1e-12 * np.abs(want).max())
    assert got.shape == want.shape == (traj.shape[0] - 2, jprob.n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(float(tprob.wave_trajectory_loss(tt, normalized=normalized)),
                               float(jprob.wave_trajectory_loss(jt, normalized=normalized)),
                               rtol=1e-12)


def test_allen_cahn_residuals_match_jax():
    jprob, tprob = _pair()
    traj = 0.5 * _traj(4, seed=2)
    jt, tt = jnp.asarray(traj), torch.as_tensor(traj)
    want = np.asarray(jop.allen_cahn_residuals(jprob, jt))
    got = top.allen_cahn_residuals(tprob, tt).numpy()
    assert got.shape == want.shape == (3, jprob.n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(float(tprob.ac_trajectory_loss(tt)),
                               float(jprob.ac_trajectory_loss(jt)), rtol=1e-12)


def test_wave_reference_matches_jax():
    """``test_downstream.py``'s wave set-up (disk_tri(6), Δt = 5e-4): the
    Newmark-β trajectory to 1e-10, stable, with a small trajectory loss."""
    jprob, tprob = _pair()
    u0 = _u0(jprob, 0)
    want = np.asarray(jprob.wave_reference(jnp.asarray(u0), 40))
    traj = tprob.wave_reference(torch.as_tensor(u0), 40)
    assert traj.shape == (40, jprob.n) and not bool(torch.isnan(traj).any())
    np.testing.assert_allclose(traj.numpy(), want, rtol=0, atol=1e-10)
    assert float(traj.abs().max()) < 10 * float(np.abs(u0).max())
    full = torch.cat([torch.as_tensor(u0)[None], traj])
    assert float(tprob.wave_trajectory_loss(full)) < 1e-2 * max(float((full[0] ** 2).sum()),
                                                                1e-12)


def test_ac_reference_matches_jax():
    """``test_downstream.py``'s Allen–Cahn set-up (disk_tri(5), Δt = 1e-4,
    a² = 1e-2, ε² = 1): 30 backward-Euler Newton steps to 1e-10 and the
    trajectory loss below 1e-6."""
    jprob, tprob = _pair(5, dt=1e-4, a2=1e-2, eps2=1.0)
    u0 = _u0(jprob, 1)
    want = np.asarray(jprob.ac_reference(jnp.asarray(u0), 30))
    traj = tprob.ac_reference(torch.as_tensor(u0), 30)
    assert traj.shape == (30, jprob.n)
    np.testing.assert_allclose(traj.numpy(), want, rtol=0, atol=1e-10)
    full = torch.cat([torch.as_tensor(u0)[None], traj])
    assert float(tprob.ac_trajectory_loss(full)) < 1e-6


def test_integrators_take_the_reference_settings():
    _, tprob = _pair()
    nm = tprob.newmark_integrator()
    assert nm.dt == tprob.dt and nm.bc is tprob.bc
    np.testing.assert_allclose(nm.stiff.vals.numpy(), tprob.c ** 2 * tprob.stiff.vals.numpy())
    nk = tprob.newton_integrator(newton_iters=2)
    assert nk.newton_iters == 2 and nk.diffusion_scale == tprob.a2
    u = torch.linspace(-1, 1, 7, dtype=torch.float64)
    np.testing.assert_allclose(nk.reaction_prime(u).numpy(),
                               (-tprob.eps2 * (3 * u ** 2 - 1.0)).numpy())


def test_wave_loss_gradient_matches_jax():
    """The data-free operator-learning objective differentiates: ∂/∂traj of
    the normalized wave loss against ``jax.grad`` (1e-12 of its scale)."""
    jprob, tprob = _pair()
    traj = _traj(5, seed=4)
    jg = np.asarray(jax.grad(lambda t: jprob.wave_trajectory_loss(t, normalized=True))(
        jnp.asarray(traj)))
    x = torch.as_tensor(traj).requires_grad_(True)
    (g,) = torch.autograd.grad(tprob.wave_trajectory_loss(x, normalized=True), x)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-12 * np.abs(jg).max())
