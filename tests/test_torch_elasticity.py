"""Torch port parity for linear elasticity: ``forms.elasticity`` and
``forms.vector_load`` through the weak-form API (interleaved vector DoFs)
against the JAX package's CSR values and load vectors, ``ElasticityProblem``
(BiCGSTAB + Jacobi) against the JAX call, and the rigid-body null space of
the un-condensed operator.  The ``cuda`` twin runs the same on a card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import weakform as jwf  # noqa: E402
from repro.fem import ElasticityProblem as JElasticity  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.fem import ElasticityProblem  # noqa: E402

MESHES = {"hollow_cube_tet": ("hollow_cube_tet", 3), "square_tri": ("unit_square_tri", 5)}
LAM, MU = 0.5769230769230769, 0.3846153846153846  # E = 1, ν = 0.3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _asms(name):
    gen, n = MESHES[name]
    mj, mt = getattr(jc, gen)(n), getattr(tc, gen)(n)
    sj = jc.FunctionSpace(mj, jc.mesh.element_for_mesh(mj), value_size=mj.dim)
    st = tc.FunctionSpace(mt, tc.element_for_mesh(mt), value_size=mt.dim)
    return jc.GalerkinAssembler(sj), tc.GalerkinAssembler(st, device="cpu")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("scale", ["none", "element"])
def test_elasticity_values_match_jax(mesh, scale):
    aj, at = _asms(mesh)
    s = np.random.default_rng(2).uniform(0.2, 1.0, at.plan.num_cells)
    sj, st = (None, None) if scale == "none" else (jnp.asarray(s), torch.as_tensor(s))
    kj = aj.assemble(jwf.elasticity(LAM, MU, scale=sj))
    kt = at.assemble(twf.elasticity(LAM, MU, scale=st))
    np.testing.assert_array_equal(kt.indices, kj.indices)
    np.testing.assert_allclose(kt.vals.numpy(), np.asarray(kj.vals), atol=1e-12, rtol=0)
    # the local matrix is symmetric, so K is
    dense = kt.to_dense()
    np.testing.assert_allclose(dense.numpy(), dense.T.numpy(), atol=1e-13, rtol=0)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("force", ["constant", "callable"])
def test_vector_load_matches_jax(mesh, force):
    aj, at = _asms(mesh)
    d = at.coords.shape[-1]
    if force == "constant":
        b = np.arange(1.0, d + 1.0)
        fj, ft = jnp.asarray(b), torch.as_tensor(b)
    else:
        fj = lambda x: jnp.stack([x[..., 0] * x[..., 1]] * d, axis=-1)  # noqa: E731
        ft = lambda x: torch.stack([x[..., 0] * x[..., 1]] * d, dim=-1)  # noqa: E731
    want = aj.assemble_rhs(jwf.source(fj))
    got = at.assemble_rhs(twf.source(ft))
    assert got.shape == (at.plan.num_dofs,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
    ctx = at.context()
    local = tc.forms.vector_load(ctx, ft, d)
    assert local.shape == (at.plan.num_cells, (d + 1) * d)


@pytest.mark.parametrize("mesh", ["hollow_cube_tet_6", "square_tri_8"])
def test_elasticity_problem_matches_jax(mesh):
    gen, n = {"hollow_cube_tet_6": ("hollow_cube_tet", 6),
              "square_tri_8": ("unit_square_tri", 8)}[mesh]
    pj, pt = JElasticity(getattr(jc, gen)(n)), ElasticityProblem(getattr(tc, gen)(n), device="cpu")
    assert pt.space.num_dofs == pj.space.num_dofs and pt.method == "bicgstab"
    assert (pt.lam, pt.mu) == (pj.lam, pj.mu)
    rj, rt = pj.solve(), pt.solve()
    assert abs(rt.iters - int(rj.iters)) <= 1
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), atol=1e-9, rtol=0)
    assert rt.iters > 0 and rt.converged and rt.residual <= 1e-9


def rigid_body_modes(points: np.ndarray) -> np.ndarray:
    """The d(d+1)/2 rigid-body displacement fields (translations and
    infinitesimal rotations) as interleaved vector fields, one per row."""
    n, d = points.shape
    modes = []
    for i in range(d):
        t = np.zeros((n, d))
        t[:, i] = 1.0
        modes.append(t)
    for i in range(d):
        for j in range(i + 1, d):
            r = np.zeros((n, d))
            r[:, i], r[:, j] = -points[:, j], points[:, i]
            modes.append(r)
    return np.stack([m.reshape(-1) for m in modes])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rigid_body_modes_span_the_null_space(mesh):
    """Translations and rotations are in the kernel of the un-condensed
    operator: ‖K r‖ ≤ 1e-10·‖K‖ for each mode r, as in the reference."""
    aj, at = _asms(mesh)
    kt = at.assemble(twf.elasticity(LAM, MU))
    kj = aj.assemble(jwf.elasticity(LAM, MU))
    modes = rigid_body_modes(at.mesh.points)
    assert modes.shape[0] == {2: 3, 3: 6}[at.mesh.dim]
    k_norm = float(np.abs(kt.vals.numpy()).max())
    for r in modes:
        kr = kt.matvec(torch.as_tensor(r)).numpy()
        assert np.abs(kr).max() <= 1e-10 * k_norm
        np.testing.assert_allclose(kr, np.asarray(kj.matvec(jnp.asarray(r))), atol=1e-12, rtol=0)


@pytest.mark.cuda
def test_cuda_elasticity_matches_cpu(cuda):
    from repro_torch import kernels

    on_cpu = ElasticityProblem(tc.hollow_cube_tet(6), device="cpu")
    on_card = ElasticityProblem(tc.hollow_cube_tet(6), device=cuda)
    kernels.reset_launches()
    r_card = on_card.solve()
    assert kernels.LAUNCHES["seg_reduce"] == 2 and kernels.LAUNCHES["spmv_ell"] > 0
    assert kernels.LAUNCHES["local_stiffness_p1"] == 0  # vector space: the einsum Map
    r_cpu = on_cpu.solve()
    assert abs(r_card.iters - r_cpu.iters) <= 1
    torch.testing.assert_close(r_card.u.cpu(), r_cpu.u, atol=1e-9, rtol=0)
