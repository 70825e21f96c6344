"""Torch port parity for boundary facets: ``facet_context``, the
``FacetAssembler`` (Neumann loads, Robin values and their injection into
the volume pattern), ``weakform.robin``/``neumann`` in one assembly with
the volume terms, and ``MixedBCPoisson`` against the JAX package on the
same disk meshes.  On the CPU the kernels take their plain versions; the
``cuda`` twins run the same on a card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import weakform as jwf  # noqa: E402
from repro.fem import MixedBCPoisson as JMixedBCPoisson  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import assembly as tassembly  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.fem import MixedBCPoisson  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _disk(pkg, n_r):
    m = pkg.disk_tri(n_r, center=(0.0, 0.0), radius=1.0)
    el = (jc.mesh.element_for_mesh if pkg is jc else tc.element_for_mesh)(m)
    return m, pkg.FunctionSpace(m, el)


@functools.lru_cache(maxsize=None)
def _facet_pair(n_r=8, device="cpu"):
    """(JAX, port) assemblers and facet assemblers on every boundary facet
    of disk_tri(n_r), built once per size (the JAX side compiles per
    shape)."""
    mj, sj = _disk(jc, n_r)
    mt, st = _disk(tc, n_r)
    aj, at = jc.GalerkinAssembler(sj), tc.GalerkinAssembler(st, device=device)
    fj = jc.FacetAssembler(sj, mj.boundary_facets(), volume_routing=aj.mat_routing)
    ft = tc.FacetAssembler(st, mt.boundary_facets(), volume_routing=at.mat_routing,
                           device=device)
    return aj, at, fj, ft


def test_facet_context_matches_jax():
    _, _, fj, ft = _facet_pair()
    cj, ct = fj.context(), ft.context()
    assert ct.grad is None
    np.testing.assert_allclose(ct.detj.numpy(), np.asarray(cj.detj), atol=1e-12, rtol=0)
    np.testing.assert_allclose(ct.xq.numpy(), np.asarray(cj.xq), atol=1e-12, rtol=0)
    # the measures sum to the polygon's perimeter (quadrature weights sum to 1)
    perim = (ct.w[None] * ct.detj).sum()
    edges = np.linalg.norm(np.diff(ft.coords.numpy(), axis=1)[:, 0], axis=1)
    np.testing.assert_allclose(float(perim), edges.sum(), rtol=1e-13)
    direct = tc.facet_context(ft.coords, ft.phi, ft.gradhat, ft.w)
    np.testing.assert_array_equal(direct.detj.numpy(), ct.detj.numpy())


@pytest.mark.parametrize("coef", ["scalar", "callable", "facet"])
def test_neumann_load_and_robin_values_match_jax(coef):
    _, _, fj, ft = _facet_pair()
    n_f, q = ft.facets.shape[0], ft.w.shape[0]
    vals = np.random.default_rng(5).uniform(0.5, 2.0, n_f)
    cj, ct = {
        "scalar": (1.7, 1.7),
        "callable": (lambda x: 1.0 + x[..., 0] ** 2, lambda x: 1.0 + x[..., 0] ** 2),
        "facet": (jnp.asarray(vals), torch.as_tensor(vals)),
    }[coef]
    np.testing.assert_allclose(ft.neumann_load(ct).numpy(), np.asarray(fj.neumann_load(cj)),
                               atol=1e-12, rtol=0)
    vt, it = ft.robin_matrix_vals(ct)
    vj, ij = fj.robin_matrix_vals(cj)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(it, ij)
    assert q >= 2 and it.shape == (ft.mat_routing.nnz,)


def test_mixed_volume_robin_matches_legacy_path():
    """One assembly of diffusion + Robin (facet values injected into the
    volume pattern) equals the reference's legacy path (stiffness, then
    ``add_robin``) and its own; the fused right-hand side equals
    ``neumann_load``; the system solves u = x."""
    aj, at, fj, ft = _facet_pair()
    alpha = 1.3
    fused = at.assemble(twf.diffusion() + twf.robin(alpha, on=ft))
    with pytest.warns(DeprecationWarning):
        legacy_j = fj.add_robin(aj.assemble_stiffness(), alpha)
    np.testing.assert_allclose(fused.vals.numpy(), np.asarray(legacy_j.vals), atol=1e-12, rtol=0)
    legacy_t = ft.add_robin(at.assemble(twf.diffusion()), alpha)
    np.testing.assert_allclose(legacy_t.vals.numpy(), fused.vals.numpy(), atol=1e-12, rtol=0)

    gt = lambda x: (1.0 + alpha) * x[..., 0]  # noqa: E731
    rhs = at.assemble_rhs(twf.source(0.0) + twf.neumann(gt, on=ft))
    rhs_j = aj.assemble_rhs(jwf.source(0.0) + jwf.neumann(gt, on=fj))
    np.testing.assert_allclose(rhs.numpy(), np.asarray(rhs_j), atol=1e-12, rtol=0)
    np.testing.assert_allclose(rhs.numpy(), ft.neumann_load(gt).numpy(), atol=1e-13, rtol=0)
    # boundary terms only: no volume Map, zeros plus the facet values
    only = at.assemble(twf.robin(alpha, on=ft))
    only_j = aj.assemble(jwf.robin(alpha, on=fj))
    np.testing.assert_allclose(only.vals.numpy(), np.asarray(only_j.vals), atol=1e-12, rtol=0)

    u, info = tc.bicgstab(fused.matvec, rhs, m=tc.jacobi_preconditioner(fused), tol=1e-12)
    exact = at.space.dof_points[:, 0]
    assert info.converged
    assert np.linalg.norm(u.numpy() - exact) / np.linalg.norm(exact) < 1e-2


def test_mixed_form_keeps_the_p1_kernel_and_facet_reduces(monkeypatch):
    """The volume Map of diffusion + Robin is B1; the facet Reduce and the
    volume Reduce are both B2 (here: their wrappers' plain versions)."""
    _, at, _, ft = _facet_pair()
    maps, reduces = [], []
    real_map, real_reduce = tassembly.local_stiffness_p1, tassembly.seg_reduce
    monkeypatch.setattr(tassembly, "local_stiffness_p1",
                        lambda c, r: maps.append(c.shape) or real_map(c, r))
    monkeypatch.setattr(tassembly, "seg_reduce",
                        lambda v, t, **kw: reduces.append(t) or real_reduce(v, t, **kw))
    at.assemble(twf.diffusion(2.0) + twf.robin(1.0, on=ft))
    assert len(maps) == 1
    assert reduces == [at.plan.mat_reduce, ft.mat_reduce]
    reduces.clear()
    at.assemble_rhs(twf.source(1.0) + twf.neumann(1.0, on=ft))
    assert reduces == [at.plan.vec_reduce, ft.vec_reduce]
    at.assemble(twf.diffusion() + twf.mass() + twf.robin(1.0, on=ft))
    assert len(maps) == 1  # two volume terms: the einsum Map


def test_facet_errors():
    _, at, _, ft = _facet_pair()
    with pytest.raises(NotImplementedError, match="facet terms"):
        at.assemble(twf.diffusion() + twf.robin(1.0, on=ft), coords=at.coords)
    with pytest.raises(NotImplementedError, match="volume terms only"):
        at.assemble_batched(twf.diffusion() + twf.robin(1.0, on=ft),
                            leaves_batch=(torch.ones(2), None, None, None))
    m = tc.unit_cube_tet(2)
    with pytest.raises(NotImplementedError, match="2D triangles"):
        tc.FacetAssembler(tc.FunctionSpace(m, tc.element_for_mesh(m)), m.boundary_facets(),
                          device="cpu")
    m = tc.unit_square_tri(2)
    with pytest.raises(AssertionError, match="scalar"):
        tc.FacetAssembler(tc.FunctionSpace(m, tc.element_for_mesh(m), value_size=2),
                          m.boundary_facets(), device="cpu")


def _on_arc(c):
    return (np.sqrt(c[:, 0] ** 2 + c[:, 1] ** 2) > 0.95) & (c[:, 1] <= 0)


PREDICATES = dict(dirichlet_pred=lambda c: ~_on_arc(c),
                  neumann_pred=lambda c: _on_arc(c) & (c[:, 0] > 0),
                  robin_pred=lambda c: _on_arc(c) & (c[:, 0] <= 0))


@functools.lru_cache(maxsize=None)
def _mixed_pair(n_r, device="cpu"):
    pj = JMixedBCPoisson(jc.disk_tri(n_r, center=(0.0, 0.0), radius=1.0), **PREDICATES)
    pt = MixedBCPoisson(tc.disk_tri(n_r, center=(0.0, 0.0), radius=1.0), device=device,
                        **PREDICATES)
    return pj, pt


def _solve_u_eq_x(prob, sqrt):
    """The bench_mixed_bc data: u = x harmonic, Neumann data x/r on the
    lower right arc, Robin (α = 1) data x/r + x on the lower left."""
    r = lambda x: sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)  # noqa: E731
    return prob.solve(f=0.0, g_neumann=lambda x: x[..., 0] / r(x), robin_alpha=1.0,
                      g_robin=lambda x: x[..., 0] / r(x) + x[..., 0],
                      dirichlet_values=lambda p: p[:, 0])


@pytest.mark.parametrize("n_r", [6])
def test_mixed_bc_poisson_matches_jax(n_r):
    pj, pt = _mixed_pair(n_r)
    for part in ("d_facets", "n_facets", "r_facets"):
        np.testing.assert_array_equal(getattr(pt, part), getattr(pj, part))
    assert len(pt.n_facets) and len(pt.r_facets)
    rt, rj = _solve_u_eq_x(pt, torch.sqrt), _solve_u_eq_x(pj, jnp.sqrt)
    assert rt.converged and rj.converged
    assert abs(rt.iters - int(rj.iters)) <= 1
    u_j = np.asarray(rj.u)
    np.testing.assert_allclose(rt.u.numpy(), u_j, atol=1e-9, rtol=0)
    exact = pt.space.dof_points[:, 0]
    err = lambda u: np.linalg.norm(u - exact) / np.linalg.norm(exact)  # noqa: E731
    assert abs(err(rt.u.numpy()) - err(u_j)) <= 1e-9


# The JAX package's MixedBCPoisson at n_r = 14 on the CPU (backend 'ell'):
# 92 BiCGSTAB iterations, relative error 7.056437587069318e-05 against
# u = x.  The iteration count is not reproducible past rounding from
# n_r = 10 on: perturbing the reference's own condensed values by one ulp
# (16 seeds, its 'ell' and 'csr' backends) gave 86-93 iterations, so the
# port's count is held to that spread (±1).  A different stopping
# iteration moves u by the solver tolerance's order (1.8e-9 at most over
# those runs), so u is held to the JAX call's at 5e-9, and its error to
# the one the reference reaches.
N14_ITERS = (86 - 1, 93 + 1)
N14_REL_ERR = 7.056437587069318e-05


def test_mixed_bc_poisson_n14_within_reference_spread():
    pj, pt = _mixed_pair(14)
    rt, rj = _solve_u_eq_x(pt, torch.sqrt), _solve_u_eq_x(pj, jnp.sqrt)
    exact = pt.space.dof_points[:, 0]
    err = np.linalg.norm(rt.u.numpy() - exact) / np.linalg.norm(exact)
    assert rt.converged and rt.residual <= 1e-10 and rj.converged
    assert N14_ITERS[0] <= rt.iters <= N14_ITERS[1]
    assert N14_ITERS[0] <= int(rj.iters) <= N14_ITERS[1]
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), atol=5e-9, rtol=0)
    assert abs(err - N14_REL_ERR) <= 1e-8


def test_from_numpy_carries_the_facet_sets():
    pj, _ = _mixed_pair(6)
    m = pj.mesh
    state = {"points": m.points, "cells": m.cells, "cell_type": m.cell_type,
             "d_facets": pj.d_facets, "n_facets": pj.n_facets, "r_facets": pj.r_facets}
    got = convert.from_numpy(state, "cpu")
    pt = MixedBCPoisson(got["mesh"], device="cpu", **PREDICATES)
    for part in ("d_facets", "n_facets", "r_facets"):
        assert isinstance(got[part], np.ndarray) and got[part].dtype == np.int64
        np.testing.assert_array_equal(getattr(pt, part), got[part])


@pytest.mark.cuda
def test_cuda_mixed_bc_matches_cpu(cuda):
    from repro_torch import kernels

    _, on_cpu = _mixed_pair(8)
    _, on_card = _mixed_pair(8, device=cuda)
    kernels.reset_launches()
    r_card = _solve_u_eq_x(on_card, torch.sqrt)
    assert kernels.LAUNCHES["local_stiffness_p1"] == 1
    assert kernels.LAUNCHES["seg_reduce"] >= 4  # volume + Robin, volume + 2 boundary loads
    r_cpu = _solve_u_eq_x(on_cpu, torch.sqrt)
    assert abs(r_card.iters - r_cpu.iters) <= 1
    torch.testing.assert_close(r_card.u.cpu(), r_cpu.u, atol=1e-9, rtol=0)
