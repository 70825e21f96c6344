"""Torch port parity for ``repro.pils`` (TensorPILS and its baselines):
SIREN and AGN carried across by ``params_from_numpy`` (apply, rollout),
every loss and its parameter gradient against ``jax.value_and_grad``, the
Galerkin residual loss across the ``csr`` / ``ell`` / ``matfree``
backends, the batched family loss, and Adam / L-BFGS / ``fit_family``
against the JAX package, on the small meshes of its tests."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
import repro.pils as jp  # noqa: E402
from repro.pils import gnn as jgnn  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.pils as tp  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.pils import gnn as tgnn  # noqa: E402
from repro_torch.pils.training import _leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K_CHECKER = 2


def jf(x):
    return jnp.sign(jnp.sin(K_CHECKER * np.pi * x[..., 0] + 1e-9)
                    * jnp.sin(K_CHECKER * np.pi * x[..., 1] + 1e-9))


def tf(x):
    return torch.sign(torch.sin(K_CHECKER * np.pi * x[..., 0] + 1e-9)
                      * torch.sin(K_CHECKER * np.pi * x[..., 1] + 1e-9))


@functools.lru_cache(maxsize=None)
def _setup(n=6):
    """Both packages' assembler and condenser on unit_square_tri(n)."""
    jm, tm = jc.unit_square_tri(n), tc.unit_square_tri(n)
    jsp = jc.FunctionSpace(jm, jc.mesh.element_for_mesh(jm))
    tsp = tc.FunctionSpace(tm, tc.element_for_mesh(tm))
    jasm, tasm = jc.GalerkinAssembler(jsp), tc.GalerkinAssembler(tsp, device="cpu")
    jbc = jc.DirichletCondenser(jasm, jsp.boundary_dofs())
    tbc = tc.DirichletCondenser(tasm, tsp.boundary_dofs())
    return (jsp, jasm, jbc), (tsp, tasm, tbc)


@functools.lru_cache(maxsize=None)
def _siren(seed=0, hidden=16, depth=2):
    jpar = jp.siren_init(jax.random.PRNGKey(seed), 2, hidden, 1, depth=depth)
    return jpar, params_from_numpy(jax.tree.map(np.asarray, jpar), "cpu")


def _flat(tree) -> dict:
    """Leaves by path, so both packages' trees compare whatever their order."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in tree for p, v in _flat(tree[k]).items()}
    if isinstance(tree, (list, tuple)):
        return {f"{i}/{p}": v for i, t in enumerate(tree) for p, v in _flat(t).items()}
    return {"": np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _assert_tree_close(got, want, rtol=0.0, atol=0.0, rel=None):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape, k
        if rel is None:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)
        else:
            scale = max(float(np.abs(w[k]).max()), 1e-300)
            assert float(np.abs(g[k] - w[k]).max()) <= rel * scale, k


def _value_and_grad(loss_fn, params):
    leaves = [x.detach().requires_grad_(True) for x in _leaves(params)]
    from repro_torch.pils.training import _unflatten

    p = _unflatten(params, leaves)
    val = loss_fn(p)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    return float(val.detach()), _unflatten(params, [torch.zeros_like(x) if g is None else g
                                           for x, g in zip(leaves, grads)])


def _loss_pair_close(jloss, tloss, jpar, tpar, tol=1e-10):
    jv, jg = jax.value_and_grad(jloss)(jpar)
    tv, tg = _value_and_grad(tloss, tpar)
    assert abs(tv - float(jv)) <= tol * abs(float(jv))
    _assert_tree_close(tg, jg, rel=tol)


# ---------------------------------------------------------------------------
# backbones
# ---------------------------------------------------------------------------

def test_params_from_numpy_keeps_the_tree():
    jpar, tpar = _siren()
    assert set(tpar) == {"layers", "omega0"} and len(tpar["layers"]) == 3
    assert all(x.dtype == torch.float64 and x.device.type == "cpu" for x in _leaves(tpar))
    _assert_tree_close(tpar, jpar)
    state = params_from_numpy({"m": [np.zeros(3)], "t": np.float64(2.0), "k": (np.int32(1),)},
                              "cpu")
    assert isinstance(state["k"], tuple) and state["k"][0].dtype == torch.int64
    assert state["t"].dtype == torch.float64 and float(state["t"]) == 2.0


def test_siren_apply_matches_jax():
    jpar, tpar = _siren(seed=0, hidden=64, depth=4)
    x = np.random.default_rng(0).uniform(size=(50, 2))
    np.testing.assert_allclose(tp.siren_apply(tpar, torch.as_tensor(x)).numpy(),
                               np.asarray(jp.siren_apply(jpar, jnp.asarray(x))),
                               rtol=0, atol=1e-12)


def test_siren_init_follows_the_reference_bounds():
    g = torch.Generator().manual_seed(0)
    par = tp.siren_init(g, 2, 64, 1, depth=4, device="cpu")
    dims = [2, 64, 64, 64, 64, 1]
    assert float(par["omega0"]) == 30.0 and len(par["layers"]) == 5
    for i, layer in enumerate(par["layers"]):
        bound = 1.0 / dims[i] if i == 0 else np.sqrt(6.0 / dims[i]) / 30.0
        assert layer["w"].shape == (dims[i], dims[i + 1]) and layer["w"].dtype == torch.float64
        assert float(layer["w"].abs().max()) <= bound and float(layer["b"].abs().max()) == 0.0
    again = tp.siren_init(torch.Generator().manual_seed(0), 2, 64, 1, depth=4, device="cpu")
    assert torch.equal(again["layers"][2]["w"], par["layers"][2]["w"])


@functools.lru_cache(maxsize=None)
def _agn_setup(n_r=4, w=4, hidden=16, n_layers=2):
    m = jc.disk_tri(n_r)
    edges = jgnn.element_graph_edges(m.cells)
    deg = np.zeros(m.num_vertices)
    np.add.at(deg, edges[:, 1], 1)
    deg = np.maximum(deg, 1.0)
    jpar = jgnn.agn_init(jax.random.PRNGKey(0), w, w, hidden=hidden, n_layers=n_layers)
    tpar = params_from_numpy(jax.tree.map(np.asarray, jpar), "cpu")
    u_win = np.random.default_rng(0).normal(size=(m.num_vertices, w))
    return m, edges, deg, jpar, tpar, u_win


def test_element_graph_edges_exact():
    m = tc.disk_tri(4)
    got = tgnn.element_graph_edges(m.cells)
    want = jgnn.element_graph_edges(jc.disk_tri(4).cells)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    q = tc.rectangle_quad(3, 2, 3.0, 2.0)
    assert np.array_equal(tgnn.element_graph_edges(q.cells), jgnn.element_graph_edges(q.cells))


def test_agn_apply_and_rollout_match_jax():
    """``agn_apply`` to 1e-12 and a 3-bundle ``agn_rollout`` (clamped
    boundary) to 1e-10; GELU is the tanh approximation, as jax.nn.gelu."""
    m, edges, deg, jpar, tpar, u_win = _agn_setup()
    coords = m.points
    out = tgnn.agn_apply(tpar, torch.as_tensor(u_win), torch.as_tensor(coords), edges,
                         torch.as_tensor(deg))
    jout = jgnn.agn_apply(jpar, jnp.asarray(u_win), jnp.asarray(coords), edges, jnp.asarray(deg))
    assert out.shape == (m.num_vertices, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tgnn.freq_features(torch.as_tensor(coords), 4).numpy(),
        np.asarray(jgnn.freq_features(jnp.asarray(coords), 4)), rtol=0, atol=1e-15)
    interior = np.ones(m.num_vertices, bool)
    interior[np.linalg.norm(coords - 0.5, axis=1) > 0.49] = False
    traj = tgnn.agn_rollout(tpar, torch.as_tensor(u_win), torch.as_tensor(coords),
                            torch.as_tensor(edges), torch.as_tensor(deg), 3,
                            torch.as_tensor(interior), 0.25)
    jtraj = jgnn.agn_rollout(jpar, jnp.asarray(u_win), jnp.asarray(coords), edges,
                             jnp.asarray(deg), 3, jnp.asarray(interior), 0.25)
    assert traj.shape == (m.num_vertices, 12)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0, atol=1e-10)
    assert bool((traj[~torch.as_tensor(interior)] == 0.25).all())


def test_agn_init_shapes():
    par = tgnn.agn_init(torch.Generator().manual_seed(1), 4, 4, hidden=32, n_layers=3,
                        device="cpu")
    _, _, _, jpar, _, _ = _agn_setup(hidden=32, n_layers=3)
    want = {k: v.shape for k, v in _flat(jpar).items()}
    assert {k: v.shape for k, v in _flat(par).items()} == want


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["csr", "ell", "ell_pallas", "matfree"])
def test_galerkin_residual_loss_from_net_matches_jax(backend):
    """TensorPILS ``loss_from_net`` and its parameter gradient (SIREN,
    hard Dirichlet rows) against ``jax.value_and_grad`` (1e-10).  The JAX
    ``ell_pallas`` kernel has no reverse-mode rule, so there the port's
    loss is held to its value and the gradient to JAX's ``ell`` (the same
    fused residual in plain jnp)."""
    (_, jasm, jbc), (_, tasm, tbc) = _setup()
    jpar, tpar = _siren()
    jl = jp.GalerkinResidualLoss(jasm, jbc, f=jf, backend=backend)
    tl = tp.GalerkinResidualLoss(tasm, tbc, f=tf, backend=backend)
    if backend == "ell_pallas":
        want = float(jl.loss_from_net(jp.siren_apply, jpar))
        got = float(tl.loss_from_net(tp.siren_apply, tpar))
        assert abs(got - want) <= 1e-10 * abs(want)
        jl = jp.GalerkinResidualLoss(jasm, jbc, f=jf, backend="ell")
    _loss_pair_close(lambda p: jl.loss_from_net(jp.siren_apply, p),
                     lambda p: tl.loss_from_net(tp.siren_apply, p), jpar, tpar)


def test_galerkin_residual_loss_backends_agree():
    """``test_matfree.py``'s backend parity on the port: the loss of one u
    on ``ell``, ``ell_pallas`` and ``matfree`` equals ``csr``'s to 1e-9,
    and its gradient in u to 1e-10."""
    (jsp, _, _), (tsp, tasm, tbc) = _setup()
    rho = np.random.default_rng(2).uniform(0.5, 2.0, tsp.mesh.num_cells)
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(tsp.num_dofs))
    vals, grads = {}, {}
    for backend in ("csr", "ell", "ell_pallas", "matfree"):
        loss = tp.GalerkinResidualLoss(tasm, tbc, rho=torch.as_tensor(rho), backend=backend)
        x = u.clone().requires_grad_(True)
        val = loss(x)
        (grads[backend],) = torch.autograd.grad(val, x)
        vals[backend] = float(val.detach())
    for backend in ("ell", "ell_pallas", "matfree"):
        assert abs(vals[backend] - vals["csr"]) < 1e-9 * max(1.0, abs(vals["csr"]))
        scale = float(grads["csr"].abs().max())
        assert float((grads[backend] - grads["csr"]).abs().max()) <= 1e-10 * scale


def test_pinn_poisson_loss_matches_jax():
    """The strong-form loss (Δu by vmap over the Hessian) and its
    parameter gradient against the JAX package's forward-over-reverse."""
    (jsp, _, jbc), _ = _setup()
    jpar, tpar = _siren()
    pts = jsp.dof_points
    free = np.asarray(jbc.free_mask, bool)
    interior, boundary = pts[free], pts[~free]
    f_int = np.array(jf(jnp.asarray(interior)[None])[0])
    _loss_pair_close(
        lambda p: jp.pinn_poisson_loss(jp.siren_apply, p, jnp.asarray(interior),
                                       jnp.asarray(f_int), jnp.asarray(boundary)),
        lambda p: tp.pinn_poisson_loss(tp.siren_apply, p, torch.as_tensor(interior),
                                       torch.as_tensor(f_int), torch.as_tensor(boundary)),
        jpar, tpar)


def test_deep_ritz_loss_matches_jax():
    (jsp, jasm, jbc), (_, tasm, _) = _setup()
    jpar, tpar = _siren()
    boundary = jsp.dof_points[~np.asarray(jbc.free_mask, bool)]
    jctx, tctx = jasm.context(), tasm.context()
    _loss_pair_close(
        lambda p: jp.deep_ritz_loss(jp.siren_apply, p, jctx.xq, jctx.wdet, jf(jctx.xq),
                                    jnp.asarray(boundary)),
        lambda p: tp.deep_ritz_loss(tp.siren_apply, p, tctx.xq, tctx.wdet, tf(tctx.xq),
                                    torch.as_tensor(boundary)),
        jpar, tpar)


def test_vpinn_loss_matches_jax():
    """The variational residual (∇u by vmap over grad, the Reduce onto the
    vector table) and its parameter gradient against the JAX package."""
    (jsp, jasm, jbc), (_, tasm, tbc) = _setup()
    jpar, tpar = _siren()
    boundary = jsp.dof_points[~np.asarray(jbc.free_mask, bool)]
    jload = jasm.assemble_rhs(jc.weakform.source(jf))
    tload = tasm.assemble_rhs(tc.weakform.source(tf))
    np.testing.assert_allclose(tload.numpy(), np.asarray(jload), rtol=0, atol=1e-14)
    _loss_pair_close(
        lambda p: jp.vpinn_loss(jp.siren_apply, p, jasm, jload, jbc.free_mask,
                                jnp.asarray(boundary)),
        lambda p: tp.vpinn_loss(tp.siren_apply, p, tasm, tload, tbc.free_mask,
                                torch.as_tensor(boundary)),
        jpar, tpar)


@functools.lru_cache(maxsize=None)
def _family(n=6, b=3, seed=7):
    (jsp, jasm, jbc), (tsp, tasm, tbc) = _setup(n)
    rng = np.random.default_rng(seed)
    rho_b = rng.uniform(0.5, 2.0, (b, tsp.mesh.num_cells))
    u_b = rng.uniform(-1, 1, (b, tsp.num_dofs))
    return rho_b, u_b


@pytest.mark.parametrize("backend", ["csr", "matfree"])
def test_batched_loss_matches_single_and_jax(backend):
    """``test_batched_assembly.py``'s family loss on the port: the mean of
    the single losses (1e-12), the JAX family loss, the family's direct
    solves zeroing it, and the backend parity of ``test_matfree.py``."""
    (_, jasm, jbc), (_, tasm, tbc) = _setup()
    rho_b, u_b = _family()
    loss_b = tp.BatchedGalerkinResidualLoss(tasm, tbc, torch.as_tensor(rho_b), backend=backend)
    assert loss_b.batch == 3
    singles = [tp.GalerkinResidualLoss(tasm, tbc, rho=torch.as_tensor(rho_b[i]))
               for i in range(3)]
    want = np.mean([float(s(torch.as_tensor(u_b[i]))) for i, s in enumerate(singles)])
    val = float(loss_b(torch.as_tensor(u_b)))
    np.testing.assert_allclose(val, want, rtol=1e-12)
    jloss = jp.BatchedGalerkinResidualLoss(jasm, jbc, jnp.asarray(rho_b), backend=backend)
    np.testing.assert_allclose(val, float(jloss(jnp.asarray(u_b))), rtol=1e-12)
    u_star = loss_b.solve()
    assert float(loss_b(u_star)) < 1e-16
    np.testing.assert_allclose(u_star.numpy(), np.asarray(jloss.solve()), rtol=0, atol=1e-9)
    x = torch.as_tensor(u_b).requires_grad_(True)
    (g,) = torch.autograd.grad(loss_b(x), x)
    jg = jax.grad(jloss)(jnp.asarray(u_b))
    assert float(np.abs(g.numpy() - np.asarray(jg)).max()) <= 1e-10 * float(np.abs(jg).max())
    if backend == "csr":
        with pytest.raises(ValueError, match="unknown backend"):
            tp.BatchedGalerkinResidualLoss(tasm, tbc, torch.as_tensor(rho_b), backend="ell")


def test_batched_loss_from_net_matches_jax():
    """The hard-constrained family loss of B per-instance SIRENs (vmap over
    the stacked parameter sets) and its gradient against the JAX package,
    and the zero net's loss equal to ‖F‖²'s."""
    (_, jasm, jbc), (tsp, tasm, tbc) = _setup()
    rho_b, _ = _family()
    pars = [jp.siren_init(jax.random.PRNGKey(s), 2, 8, 1, depth=2) for s in range(3)]
    jstack = jax.tree.map(lambda *x: jnp.stack(x), *pars)
    tstack = params_from_numpy(jax.tree.map(np.asarray, jstack), "cpu")
    jloss = jp.BatchedGalerkinResidualLoss(jasm, jbc, jnp.asarray(rho_b))
    tloss = tp.BatchedGalerkinResidualLoss(tasm, tbc, torch.as_tensor(rho_b))
    _loss_pair_close(lambda p: jloss.loss_from_net(jp.siren_apply, p),
                     lambda p: tloss.loss_from_net(tp.siren_apply, p), jstack, tstack)
    zero_net = lambda p, x: torch.zeros((x.shape[0], 1), dtype=x.dtype)  # noqa: E731
    np.testing.assert_allclose(
        float(tloss.loss_from_net(zero_net, torch.zeros((3, 1), dtype=torch.float64))),
        float(tloss(torch.zeros((3, tsp.num_dofs), dtype=torch.float64))), rtol=1e-12)


def test_opt_and_pils_import_neither_jax_nor_repro():
    """The new modules and the three example twins load neither JAX nor
    the JAX package, and hold no import line of either."""
    import re

    code = ("import sys\n"
            "import repro_torch.opt, repro_torch.pils, repro_torch.pils.gnn\n"
            "import repro_torch.pils.operator, repro_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print('loaded:', ','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "loaded:"
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b(?!_)", re.M)
    files = (sorted((ROOT / "src" / "repro_torch" / "opt").rglob("*.py"))
             + sorted((ROOT / "src" / "repro_torch" / "pils").rglob("*.py"))
             + [ROOT / "examples" / f for f in ("topology_optimization_torch.py",
                                                "poisson_pils_torch.py",
                                                "operator_learning_wave_torch.py")])
    assert len(files) == 12
    assert [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())] == []
