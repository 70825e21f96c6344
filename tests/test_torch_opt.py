"""Torch port parity for ``repro.opt`` (TensorOpt, paper §B.4): the SIMP
cantilever's compliance, its autograd sensitivity (against ``jax.grad``
and the closed form Eq. B.28), the batched multistart evaluation, the
sensitivity filter, and OC / MMA iterates against the JAX package on the
16×8 cantilever of ``tests/test_downstream.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core  # noqa: E402,F401  (x64 on)
from repro.core import weakform as jwf  # noqa: E402
from repro.core.solvers import sparse_solve as j_sparse_solve  # noqa: E402
from repro.opt import CantileverProblem as JCantilever  # noqa: E402
from repro.opt import MMAState as JMMAState  # noqa: E402
from repro.opt import mma_update as j_mma_update  # noqa: E402
from repro.opt import oc_update as j_oc_update  # noqa: E402
from repro.opt.simp import _SIMP_SPEC as J_SIMP_SPEC  # noqa: E402

from repro_torch.opt import CantileverProblem, MMAState, mma_update, oc_update  # noqa: E402
from repro_torch.opt import sensitivity_filter  # noqa: E402


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _pair(nx=16, ny=8):
    kw = dict(nx=nx, ny=ny, lx=float(nx), ly=float(ny))
    return JCantilever(**kw), CantileverProblem(**kw, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_sens(rho_key):
    jp, _ = _pair()
    c, g = jp.compliance_and_sensitivity(jnp.asarray(_RHOS[rho_key]))
    return float(c), np.asarray(g)


_E = 16 * 8
_RHOS = {"half": np.full(_E, 0.5),
         "random": np.random.default_rng(3).uniform(0.3, 0.9, _E)}


@pytest.mark.parametrize("rho_key", ["half", "random"])
def test_compliance_and_iterations_match_jax(rho_key):
    """C(ρ) to 1e-9 relative and the CG iterations of the solve ±1."""
    jp, tp = _pair()
    rho = _RHOS[rho_key]
    c = float(tp.compliance(torch.as_tensor(rho)))
    jc, _ = _jax_sens(rho_key)
    assert abs(c - jc) <= 1e-9 * abs(jc)
    _, info = tp._displacement(torch.as_tensor(rho))
    k = jp.asm.assemble(jwf.elasticity(jp.lam1, jp.mu1, scale=jp.simp_modulus(jnp.asarray(rho))))
    _, jinfo = j_sparse_solve(jp.bc.apply_matrix_only(k), jp.f, J_SIMP_SPEC, return_info=True)
    assert info.converged and abs(info.iters - int(jinfo.iters)) <= 1


@pytest.mark.parametrize("rho_key", ["half", "random"])
def test_sensitivity_matches_jax_grad_and_eq_b28(rho_key):
    """∂C/∂ρ by autograd through the assembly and the adjoint solve: to
    1e-7 (ℓ2, relative) against ``jax.grad``, and to the closed form of
    Eq. B.28 at rtol 1e-5, as ``test_downstream.py`` holds the reference."""
    _, tp = _pair()
    rho = torch.as_tensor(_RHOS[rho_key])
    c, g = tp.compliance_and_sensitivity(rho)
    jc, jg = _jax_sens(rho_key)
    assert abs(float(c) - jc) <= 1e-9 * abs(jc)
    assert not rho.requires_grad and g.shape == rho.shape
    assert _rel(g.numpy(), jg) <= 1e-7
    np.testing.assert_allclose(g.numpy(), tp.analytic_sensitivity(rho).numpy(), rtol=1e-5)


def test_compliance_batch_matches_single_and_jax():
    """B = 3 random starts: ``compliance_batch`` and
    ``compliance_and_sensitivity_batch`` equal the single calls (1e-10)
    and the JAX package's batched calls."""
    jp, tp = _pair()
    rho_b = np.random.default_rng(8).uniform(0.3, 0.9, (3, tp.n_elem))
    rb = torch.as_tensor(rho_b)
    c_b = tp.compliance_batch(rb)
    c_s, g_b = tp.compliance_and_sensitivity_batch(rb)
    assert c_b.shape == (3,) and g_b.shape == (3, tp.n_elem)
    np.testing.assert_allclose(c_s.numpy(), c_b.numpy(), rtol=1e-12)
    for i in range(3):
        c_i, g_i = tp.compliance_and_sensitivity(rb[i])
        assert abs(float(c_b[i]) - float(c_i)) <= 1e-10 * abs(float(c_i))
        assert _rel(g_b[i].numpy(), g_i.numpy()) <= 1e-10
    jc_b = np.asarray(jp.compliance_batch(jnp.asarray(rho_b)))
    _, jg_b = jp.compliance_and_sensitivity_batch(jnp.asarray(rho_b))
    np.testing.assert_allclose(c_b.numpy(), jc_b, rtol=1e-9)
    assert _rel(g_b.numpy(), np.asarray(jg_b)) <= 1e-7


def test_sensitivity_filter_matches_jax():
    """The host-built filter weights applied with ``index_add``, on one
    field and over a batch axis, against the JAX filter (1e-9)."""
    jp, tp = _pair()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, tp.n_elem))
    want = np.stack([np.asarray(jp.filter(jnp.asarray(r))) for r in x])
    got = tp.filter(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tp.filter(torch.as_tensor(x[0])).numpy(), want[0],
                               rtol=1e-9, atol=1e-12)
    centers = tp.mesh.points[tp.mesh.cells].mean(axis=1)
    apply = sensitivity_filter(centers, 2.5, device="cpu")
    np.testing.assert_allclose(apply(torch.ones(tp.n_elem, dtype=torch.float64)).numpy(), 1.0,
                               rtol=1e-14)


def _filtered(prob, rho, g, lib):
    if lib == "jax":
        return prob.filter(g * rho) / jnp.maximum(rho, 1e-3)
    return prob.filter(g * rho) / torch.clamp(rho, min=1e-3)


def test_oc_iterates_match_jax():
    """Three OC iterations from ρ = 0.5: each iterate to 1e-9 against the
    JAX package's, with the JAX sensitivities fed to both updates (so the
    update is compared alone) and end to end."""
    jp, tp = _pair()
    jrho = jnp.full((jp.n_elem,), 0.5)
    rho = torch.full((tp.n_elem,), 0.5, dtype=torch.float64)
    for _ in range(3):
        _, jg = jp.compliance_and_sensitivity(jrho)
        jgf = _filtered(jp, jrho, jg, "jax")
        alone = oc_update(torch.tensor(np.asarray(jrho)), torch.tensor(np.asarray(jgf)),
                          tp.volfrac)
        jrho = j_oc_update(jrho, jgf, jp.volfrac)
        np.testing.assert_allclose(alone.numpy(), np.asarray(jrho), rtol=0, atol=1e-12)
        _, g = tp.compliance_and_sensitivity(rho)
        rho = oc_update(rho, _filtered(tp, rho, g, "torch"), tp.volfrac)
        np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=0, atol=1e-9)


def test_mma_iterates_match_jax():
    """Three MMA iterations from ρ = 0.5 (the asymptote update takes its
    second branch from the third on): each iterate and the asymptotes to
    1e-9 against the JAX package's."""
    jp, tp = _pair()
    n = tp.n_elem
    jrho = jnp.full((n,), 0.5)
    rho = torch.full((n,), 0.5, dtype=torch.float64)
    jstate = JMMAState(low=jrho - 0.5, upp=jrho + 0.5)
    state = MMAState(low=rho - 0.5, upp=rho + 0.5)
    jdg, dg = jnp.full((n,), 1.0 / n), torch.full((n,), 1.0 / n, dtype=torch.float64)
    for _ in range(3):
        _, jg = jp.compliance_and_sensitivity(jrho)
        jrho, jstate = j_mma_update(jrho, _filtered(jp, jrho, jg, "jax"),
                                    jnp.asarray(float(jrho.mean()) - jp.volfrac), jdg, jstate)
        _, g = tp.compliance_and_sensitivity(rho)
        rho, state = mma_update(rho, _filtered(tp, rho, g, "torch"),
                                rho.mean() - tp.volfrac, dg, state)
        np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=0, atol=1e-9)
        for name in ("low", "upp"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)), rtol=0, atol=1e-9)


def test_multistart_step_matches_jax():
    """One OC step of a B = 2 family (batched sensitivities, filter and
    bisection over the batch axis) against the JAX package's vmapped step."""
    jp, tp = _pair()
    rho_b = np.random.default_rng(9).uniform(0.3, 0.9, (2, tp.n_elem))
    rho_new, c = tp.multistart_step(torch.as_tensor(rho_b))
    jrho_new, jc = jp.multistart_step(jnp.asarray(rho_b))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-9)
    np.testing.assert_allclose(rho_new.numpy(), np.asarray(jrho_new), rtol=0, atol=1e-9)
    for i in range(2):
        np.testing.assert_allclose(
            rho_new[i].numpy(),
            oc_update(torch.as_tensor(rho_b[i]),
                      _filtered(tp, torch.as_tensor(rho_b[i]),
                                tp.compliance_and_sensitivity(torch.as_tensor(rho_b[i]))[1],
                                "torch"), tp.volfrac).numpy(), rtol=0, atol=1e-12)


def test_oc_optimization_reduces_compliance():
    """``test_downstream.py``'s OC drop on the port: 8 iterations bring C
    below 0.7 of its start with the volume held to 1e-3."""
    _, tp = _pair()
    rho = torch.full((tp.n_elem,), 0.5, dtype=torch.float64)
    c0, _ = tp.compliance_and_sensitivity(rho)
    for _ in range(8):
        _, g = tp.compliance_and_sensitivity(rho)
        rho = oc_update(rho, _filtered(tp, rho, g, "torch"), tp.volfrac)
    c_end, _ = tp.compliance_and_sensitivity(rho)
    assert float(c_end) < 0.7 * float(c0)
    assert abs(float(tp.volume(rho)) - tp.volfrac) < 1e-3


def test_mma_optimization_reduces_compliance():
    """``test_downstream.py``'s MMA drop on the port: 8 iterations bring C
    below 0.8 of its start, the volume at most 1e-2 over its limit."""
    _, tp = _pair()
    n = tp.n_elem
    rho = torch.full((n,), 0.5, dtype=torch.float64)
    c0, _ = tp.compliance_and_sensitivity(rho)
    state = MMAState(low=rho - 0.5, upp=rho + 0.5)
    dg = torch.full((n,), 1.0 / n, dtype=torch.float64)
    for _ in range(8):
        _, g = tp.compliance_and_sensitivity(rho)
        rho, state = mma_update(rho, _filtered(tp, rho, g, "torch"),
                                float(rho.mean()) - tp.volfrac, dg, state)
    c_end, _ = tp.compliance_and_sensitivity(rho)
    assert float(c_end) < 0.8 * float(c0)
    assert float(rho.mean()) <= tp.volfrac + 1e-2


def test_cantilever_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CantileverProblem(nx=4, ny=2, lx=4.0, ly=2.0)


def test_chip_smoke_cantilever_pins_match_jax():
    """``chip_smoke.py`` holds the card to JAX numbers pinned at the paper's
    60×30 cantilever (the card machine has no JAX): they are the JAX
    package's compliance, ‖∂C/∂ρ‖₂ and CG iterations at ρ = 0.5, and the
    compliances of its first 3 MMA iterates; the port on the CPU meets the
    pins at the card's gates."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    pins = chip_smoke.JAX_CANTILEVER
    jp, tp = JCantilever(), CantileverProblem(device="cpu")
    jrho = jnp.full((jp.n_elem,), 0.5)
    rho = torch.full((tp.n_elem,), 0.5, dtype=torch.float64)
    jc, jg = jp.compliance_and_sensitivity(jrho)
    k = jp.asm.assemble(jwf.elasticity(jp.lam1, jp.mu1, scale=jp.simp_modulus(jrho)))
    _, jinfo = j_sparse_solve(jp.bc.apply_matrix_only(k), jp.f, J_SIMP_SPEC, return_info=True)
    assert float(jc) == pins["compliance"] and int(jinfo.iters) == pins["iters"]
    np.testing.assert_allclose(float(jnp.linalg.norm(jg)), pins["sens_norm"], rtol=1e-14)
    c, g = tp.compliance_and_sensitivity(rho)
    assert abs(float(c) / pins["compliance"] - 1) <= 1e-9
    assert abs(float(torch.linalg.vector_norm(g)) / pins["sens_norm"] - 1) <= 1e-7
    assert abs(tp._displacement(rho)[1].iters - pins["iters"]) <= 1
    n = jp.n_elem
    jstate = JMMAState(low=jrho - 0.5, upp=jrho + 0.5)
    state = MMAState(low=rho - 0.5, upp=rho + 0.5)
    jdg, dg = jnp.full((n,), 1.0 / n), torch.full((n,), 1.0 / n, dtype=torch.float64)
    jcs, cs = [], []
    for _ in range(4):
        jc, jg = jp.compliance_and_sensitivity(jrho)
        c, g = tp.compliance_and_sensitivity(rho)
        jcs.append(float(jc))
        cs.append(float(c))
        jrho, jstate = j_mma_update(jrho, _filtered(jp, jrho, jg, "jax"),
                                    jnp.asarray(float(jrho.mean()) - jp.volfrac), jdg, jstate)
        rho, state = mma_update(rho, _filtered(tp, rho, g, "torch"), rho.mean() - tp.volfrac,
                                dg, state)
    np.testing.assert_allclose(jcs[1:], pins["mma_compliance"], rtol=1e-12)
    np.testing.assert_allclose(cs[1:], pins["mma_compliance"], rtol=1e-8)
