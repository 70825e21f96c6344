"""Torch port parity: assembled CSR values and load vectors against
``repro.core.assemble`` (P1/P2 tri, P1 tet, Q1 quad/hex), Dirichlet
condensation, the kernel Map + Reduce against the assembler, gradients
through assembly, and state carried across with ``convert.from_numpy``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
from repro.core import weakform as jwf  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import assembly as tassembly  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.kernels import batch_map_stiffness, seg_reduce  # noqa: E402

SPACES = {  # name -> (generator, args, degree)
    "P1_tri": ("unit_square_tri", (6,), 1),
    "P2_tri": ("unit_square_tri", (4,), 2),
    "P1_tet": ("unit_cube_tet", (3,), 1),
    "Q1_quad": ("rectangle_quad", (4, 3, 1.0, 1.5), 1),
    "Q1_hex": ("unit_cube_hex", (2,), 1),
}


@functools.lru_cache(maxsize=None)
def _asms(space_name):
    gen, args, degree = SPACES[space_name]
    mj, mt = getattr(jc, gen)(*args), getattr(tc, gen)(*args)
    sj = jc.FunctionSpace(mj, jc.mesh.element_for_mesh(mj, degree))
    st = tc.FunctionSpace(mt, tc.element_for_mesh(mt, degree))
    return jc.GalerkinAssembler(sj), tc.GalerkinAssembler(st, device="cpu")


def _coef(kind, asm_t, rng):
    """Matched (jax, torch) coefficient of one encoding."""
    e, n = asm_t.plan.num_cells, asm_t.plan.num_dofs
    d = asm_t.coords.shape[-1]
    q = asm_t.plan.w.shape[0]
    if kind == "none":
        return None, None
    if kind == "scalar":
        return 2.5, 2.5
    if kind == "callable":
        return (lambda x: 1.0 + x[..., 0] * x[..., 1]), (lambda x: 1.0 + x[..., 0] * x[..., 1])
    if kind == "vector":
        b = rng.normal(size=d)
        return jnp.asarray(b), torch.as_tensor(b)
    a = {"element": (e,), "quadrature": (e, q), "nodal": (n,)}[kind]
    c = rng.uniform(0.5, 2.0, size=a)
    return jnp.asarray(c), torch.as_tensor(c)


MATRIX_CASES = [
    ("diffusion", "none"), ("diffusion", "scalar"), ("diffusion", "element"),
    ("diffusion", "callable"), ("diffusion", "quadrature"), ("diffusion", "nodal"),
    ("mass", "none"), ("mass", "element"), ("advection", "vector"),
    ("anisotropic_diffusion", "tensor"),
]


@pytest.mark.parametrize("space_name", list(SPACES))
@pytest.mark.parametrize("form,coef", MATRIX_CASES)
def test_matrix_matches_jax(space_name, form, coef):
    asm_j, asm_t = _asms(space_name)
    rng = np.random.default_rng(3)
    if coef == "tensor":
        d = asm_t.coords.shape[-1]
        a = rng.normal(size=(d, d))
        a = a @ a.T + d * np.eye(d)
        cj, ct = jnp.asarray(a), torch.as_tensor(a)
    else:
        cj, ct = _coef(coef, asm_t, rng)
    kj = asm_j.assemble(getattr(jwf, form)(cj))
    kt = asm_t.assemble(getattr(twf, form)(ct))
    np.testing.assert_array_equal(kt.indptr, kj.indptr)
    np.testing.assert_array_equal(kt.indices, kj.indices)
    assert kt.vals.dtype == torch.float64
    np.testing.assert_allclose(kt.vals.numpy(), np.asarray(kj.vals), atol=1e-12, rtol=0)


@pytest.mark.parametrize("space_name", list(SPACES))
@pytest.mark.parametrize("coef", ["none", "scalar", "callable", "element", "nodal"])
def test_load_matches_jax(space_name, coef):
    asm_j, asm_t = _asms(space_name)
    cj, ct = _coef(coef, asm_t, np.random.default_rng(5))
    fj = asm_j.assemble_rhs(jwf.source(cj))
    ft = asm_t.assemble_rhs(twf.source(ct))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-12, rtol=0)


@pytest.mark.parametrize("space_name", ["P1_tri", "P2_tri", "P1_tet"])
def test_fused_form_matches_jax(space_name):
    asm_j, asm_t = _asms(space_name)
    d = asm_t.coords.shape[-1]
    beta = np.linspace(0.5, 1.0, d)
    kj = asm_j.assemble(jwf.diffusion(0.05) + jwf.advection(jnp.asarray(beta))
                        + 0.3 * jwf.mass() - jwf.mass(2.0))
    kt = asm_t.assemble(twf.diffusion(0.05) + twf.advection(torch.as_tensor(beta))
                        + 0.3 * twf.mass() - twf.mass(2.0))
    np.testing.assert_allclose(kt.vals.numpy(), np.asarray(kj.vals), atol=1e-12, rtol=0)


@pytest.mark.parametrize("space_name", ["P1_tri", "P2_tri", "P1_tet"])
@pytest.mark.parametrize("values", ["zero", "scalar", "per_dof"])
def test_dirichlet_condensation_matches_jax(space_name, values):
    asm_j, asm_t = _asms(space_name)
    bc_dofs = asm_t.space.boundary_dofs()
    bj = jc.DirichletCondenser(asm_j, asm_j.space.boundary_dofs())
    bt = tc.DirichletCondenser(asm_t, bc_dofs)
    v = {"zero": 0.0, "scalar": 0.3,
         "per_dof": np.random.default_rng(2).normal(size=bc_dofs.shape[0])}[values]
    vj = jnp.asarray(v) if values == "per_dof" else v
    vt = torch.as_tensor(v) if values == "per_dof" else v
    kcj, fcj = bj.apply(asm_j.assemble(jwf.diffusion(1.5)), asm_j.assemble_rhs(jwf.source(1.0)), vj)
    kct, fct = bt.apply(asm_t.assemble(twf.diffusion(1.5)), asm_t.assemble_rhs(twf.source(1.0)), vt)
    np.testing.assert_allclose(kct.vals.numpy(), np.asarray(kcj.vals), atol=1e-12, rtol=0)
    np.testing.assert_allclose(fct.numpy(), np.asarray(fcj), atol=1e-12, rtol=0)
    r = torch.ones(asm_t.plan.num_dofs, dtype=torch.float64)
    np.testing.assert_array_equal(bt.project_residual(r).numpy(),
                                  np.asarray(bj.project_residual(jnp.ones(r.shape[0]))))


def test_kernel_map_and_reduce_equal_assembler():
    """Kernel Map (local_stiffness_p1) + kernel Reduce (seg_reduce), here in
    their plain versions, equal the JAX assembler and the port's einsum Map."""
    asm_j, asm_t = _asms("P1_tet")
    rho = np.random.default_rng(1).uniform(0.5, 2.0, asm_t.plan.num_cells)
    want = asm_j.assemble(jwf.diffusion(jnp.asarray(rho))).vals
    k_local = batch_map_stiffness(asm_t.coords, torch.as_tensor(rho))
    got = seg_reduce(k_local, asm_t.plan.mat_reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
    # the einsum Map (taken when an input requires grad) gives the same values
    einsum = asm_t.assemble(twf.diffusion(torch.as_tensor(rho).requires_grad_()))
    np.testing.assert_allclose(einsum.vals.detach().numpy(), got.numpy(), atol=1e-12, rtol=0)


def test_map_takes_the_p1_kernel_only_for_plain_p1_diffusion(monkeypatch):
    calls = []
    real = tassembly.local_stiffness_p1

    def spy(coords, rho):
        calls.append(coords.shape)
        return real(coords, rho)

    monkeypatch.setattr(tassembly, "local_stiffness_p1", spy)
    _, asm_t = _asms("P1_tet")
    e = asm_t.plan.num_cells
    asm_t.assemble(twf.diffusion(lambda x: 1.0 + x[..., 0]))
    asm_t.assemble(3.0 * twf.diffusion(torch.ones(e, dtype=torch.float64)))
    assert len(calls) == 2
    asm_t.assemble(twf.mass())
    asm_t.assemble(twf.diffusion() + twf.mass())
    asm_t.assemble(twf.diffusion(torch.ones(e, dtype=torch.float64, requires_grad=True)))
    _, asm_p2 = _asms("P2_tri")
    asm_p2.assemble(twf.diffusion())
    assert len(calls) == 2


def test_gradients_through_assembly_match_jax():
    """d/dρ and d/dcoords of Σ w·vals through Map + Reduce, against jax.grad."""
    asm_j, asm_t = _asms("P1_tri")
    rng = np.random.default_rng(4)
    rho = rng.uniform(0.5, 2.0, asm_t.plan.num_cells)
    w = rng.normal(size=asm_t.plan.nnz)
    plan_j = asm_j.plan

    def loss_j(r, c):
        return jnp.sum(jnp.asarray(w) * jc.assemble(plan_j, jwf.diffusion(r), coords=c).vals)

    gj_rho, gj_c = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(rho), plan_j.coords)
    rho_t = torch.as_tensor(rho).requires_grad_()
    coords_t = asm_t.coords.clone().requires_grad_()
    k = tc.assemble(asm_t.plan, twf.diffusion(rho_t), coords=coords_t)
    (k.vals * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(rho_t.grad.numpy(), np.asarray(gj_rho), atol=1e-11, rtol=1e-11)
    np.testing.assert_allclose(coords_t.grad.numpy(), np.asarray(gj_c), atol=1e-10, rtol=1e-10)


def test_from_numpy_carries_state_across():
    asm_j, _ = _asms("P1_tet")
    m = asm_j.mesh
    rho = np.random.default_rng(0).uniform(0.5, 2.0, m.num_cells)
    kj = asm_j.assemble(jwf.diffusion(jnp.asarray(rho)))
    state = {"points": m.points, "cells": m.cells, "cell_type": m.cell_type,
             "vals": np.asarray(kj.vals), "indptr": kj.indptr, "indices": kj.indices,
             "shape": kj.shape, "rho": rho, "bc": asm_j.space.boundary_dofs()}
    got = convert.from_numpy(state, "cpu")
    assert got["rho"].dtype == torch.float64 and got["bc"].dtype == torch.int64
    np.testing.assert_array_equal(got["mesh"].cells, m.cells)
    asm_t = tc.GalerkinAssembler(tc.FunctionSpace(got["mesh"], tc.element_for_mesh(got["mesh"])),
                                 device="cpu")
    kt = asm_t.assemble(twf.diffusion(got["rho"]))
    np.testing.assert_allclose(kt.vals.numpy(), got["csr"].vals.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(got["csr"].diag_pos, kj.diag_pos)
    x = np.random.default_rng(1).normal(size=kj.shape[0])
    np.testing.assert_allclose(got["csr"].matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(kj.matvec(jnp.asarray(x))), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got["csr"].diagonal().numpy(), np.asarray(kj.diagonal()),
                               atol=0, rtol=0)


def test_weakform_algebra_and_errors():
    form = twf.diffusion(2.0) + 0.5 * twf.mass() - twf.advection(torch.ones(2))
    spec, leaves = twf.lower(form, twf.MATRIX)
    assert [k for k, _ in spec] == ["diffusion", "mass", "advection"]
    assert len(leaves) == 5  # 2.0, scale 1.0 | scale 0.5 | beta, scale -1.0
    assert sum([twf.mass(), twf.mass()]).terms[0].kind == "mass"
    with pytest.raises(TypeError):
        twf.lower(twf.source(1.0), twf.MATRIX)
    with pytest.raises(ValueError):
        twf.lower(twf.WeakForm(), twf.MATRIX)
    with pytest.raises(NotImplementedError, match="FacetAssembler"):
        twf.robin(1.0, on=object())
    with pytest.raises(NotImplementedError, match="FacetAssembler"):
        twf.neumann(1.0, on=object())
