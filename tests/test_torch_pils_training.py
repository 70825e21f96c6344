"""Torch port parity for ``repro.pils.training``: one Adam update, 10
``train_adam`` steps and 5 ``lbfgs_minimize`` steps on the TensorPILS
loss of a SIREN carried across by ``params_from_numpy``, and
``fit_family`` on a batched coefficient family, against the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
import repro.pils as jp  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.pils as tp  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402


def jf(x):
    return jnp.sign(jnp.sin(2 * np.pi * x[..., 0] + 1e-9) * jnp.sin(2 * np.pi * x[..., 1] + 1e-9))


def tf(x):
    return torch.sign(torch.sin(2 * np.pi * x[..., 0] + 1e-9)
                      * torch.sin(2 * np.pi * x[..., 1] + 1e-9))


@functools.lru_cache(maxsize=None)
def _setup(n=6):
    """Both packages' assembler and condenser on unit_square_tri(n)."""
    jm, tm = jc.unit_square_tri(n), tc.unit_square_tri(n)
    jsp = jc.FunctionSpace(jm, jc.mesh.element_for_mesh(jm))
    tsp = tc.FunctionSpace(tm, tc.element_for_mesh(tm))
    jasm, tasm = jc.GalerkinAssembler(jsp), tc.GalerkinAssembler(tsp, device="cpu")
    return ((jsp, jasm, jc.DirichletCondenser(jasm, jsp.boundary_dofs())),
            (tsp, tasm, tc.DirichletCondenser(tasm, tsp.boundary_dofs())))


def _siren(seed=0):
    jpar = jp.siren_init(jax.random.PRNGKey(seed), 2, 16, 1, depth=2)
    return jpar, params_from_numpy(jax.tree.map(np.asarray, jpar), "cpu")


def _flat(tree) -> dict:
    """Leaves by path, so both packages' trees compare whatever their order."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in tree for p, v in _flat(tree[k]).items()}
    if isinstance(tree, (list, tuple)):
        return {f"{i}/{p}": v for i, t in enumerate(tree) for p, v in _flat(t).items()}
    return {"": np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _assert_tree_close(got, want, atol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)



def test_adam_update_matches_jax():
    jpar, tpar = _siren()
    rng = np.random.default_rng(5)
    jg = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=np.shape(x))), jpar)
    tg = params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    jstate, tstate = jp.adam_init(jpar), tp.adam_init(tpar)
    assert float(tstate["t"]) == 0.0 and tstate["t"].dtype == torch.float64
    for _ in range(3):
        jpar, jstate = jp.adam_update(jpar, jg, jstate, 1e-2)
        tpar, tstate = tp.adam_update(tpar, tg, tstate, 1e-2)
    _assert_tree_close(tpar, jpar, atol=1e-14)
    _assert_tree_close(tstate, jstate, atol=1e-14)


def _galerkin_losses():
    (_, jasm, jbc), (_, tasm, tbc) = _setup()
    jl = jp.GalerkinResidualLoss(jasm, jbc, f=jf)
    tl = tp.GalerkinResidualLoss(tasm, tbc, f=tf)
    return (lambda p: jl.loss_from_net(jp.siren_apply, p),
            lambda p: tl.loss_from_net(tp.siren_apply, p))


def test_train_adam_and_lbfgs_match_jax():
    """10 ``train_adam`` steps (lr 2e-3, logged every 3) and then 5
    ``lbfgs_minimize`` steps on the TensorPILS loss: parameters within
    1e-8 of the JAX package's and the losses with them."""
    jloss, tloss = _galerkin_losses()
    jpar, tpar = _siren(seed=3)
    jpar, jhist, _ = jp.train_adam(jloss, jpar, 10, lr=2e-3, log_every=3)
    tpar, hist, its = tp.train_adam(tloss, tpar, 10, lr=2e-3, log_every=3)
    assert len(hist) == 4 and its > 0
    np.testing.assert_allclose(hist, jhist, rtol=1e-10)
    _assert_tree_close(tpar, jpar, atol=1e-8)
    jpar, jlosses, _ = jp.lbfgs_minimize(jloss, jpar, steps=5)
    tpar, losses, its = tp.lbfgs_minimize(tloss, tpar, steps=5)
    assert len(losses) == len(jlosses) == 6 and losses[-1] < losses[0] and its > 0
    np.testing.assert_allclose(losses, jlosses, rtol=1e-8)
    _assert_tree_close(tpar, jpar, atol=1e-8)


def test_fit_family_trains_toward_direct_solves():
    """``test_batched_assembly.py``'s ``fit_family`` bar on the port: the
    family residual below 1e-4 and the fit within 5 % of the direct solves;
    the first steps' losses equal the JAX package's."""
    (_, jasm, jbc), (tsp, tasm, tbc) = _setup(5)
    rho_b = np.random.default_rng(11).uniform(0.5, 2.0, (3, tsp.mesh.num_cells))
    u_fit, hist, its, loss = tp.fit_family(tasm, tbc, torch.as_tensor(rho_b), steps=800,
                                           lr=5e-2, log_every=100)
    assert u_fit.shape == (3, tsp.num_dofs) and its > 0 and len(hist) == 8
    assert float(loss(u_fit)) < 1e-4
    u_star = loss.solve()
    rel = float(torch.linalg.vector_norm(u_fit - u_star) / torch.linalg.vector_norm(u_star))
    assert rel < 0.05, rel
    _, jhist, _, _ = jp.fit_family(jasm, jbc, jnp.asarray(rho_b), steps=201, lr=5e-2,
                                   log_every=100)
    np.testing.assert_allclose(hist[:3], jhist, rtol=1e-8)


def test_chip_smoke_siren_pins_match_jax():
    """``chip_smoke.py`` holds the card's 10 Adam steps of the paper's SIREN
    (2→64×4→1, weights from ``siren_numpy(0)``) on the K = 4 checkerboard
    at unit_square_tri(16) to JAX losses pinned here: they are the JAX
    package's, and the port on the CPU meets them at the card's gate."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    (_, jasm, jbc), (_, tasm, tbc) = _setup(chip_smoke.PILS_GATE_N)
    jl = jp.GalerkinResidualLoss(jasm, jbc, f=chip_smoke.checkerboard(jnp))
    tree = chip_smoke.siren_numpy(0)
    _, jhist, _ = jp.train_adam(lambda p: jl.loss_from_net(jp.siren_apply, p),
                                jax.tree.map(jnp.asarray, tree), 10, lr=1e-3, log_every=1)
    np.testing.assert_allclose(jhist, chip_smoke.JAX_PILS_ADAM, rtol=1e-12)
    for backend in ("csr", "ell"):
        tl = tp.GalerkinResidualLoss(tasm, tbc, f=chip_smoke.checkerboard(torch), backend=backend)
        _, hist, _ = tp.train_adam(lambda p, tl=tl: tl.loss_from_net(tp.siren_apply, p),
                                   params_from_numpy(tree, "cpu"), 10, lr=1e-3, log_every=1)
        np.testing.assert_allclose(hist, chip_smoke.JAX_PILS_ADAM, rtol=1e-8)
