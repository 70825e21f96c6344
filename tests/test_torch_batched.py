"""Torch port parity for batched families (SM B.1.4): ``assemble_batched``
and ``assemble_rhs_batched`` against stacked single assemblies and the JAX
call, ``BatchedCSR``, the batched condensation, ``sparse_solve_batched``,
``PoissonProblem.solve_batch`` / ``solve_coeff_batch`` and the gradient of
a ``solve_coeff_batch`` loss against ``jax.grad``; the batched plain
versions of B1/B2 against per-instance calls, and B1's autograd Function
against ``jax.grad`` of the reference Map.  The ``cuda`` twins run the
kernels on a card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import weakform as jwf  # noqa: E402
from repro.fem import PoissonProblem as JPoisson  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.fem import PoissonProblem  # noqa: E402
from repro_torch.kernels import local_stiffness_p1, seg_reduce  # noqa: E402
from repro_torch.kernels.ref import local_stiffness_p1_ref, seg_reduce_ref  # noqa: E402

B = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _problems(n=3):
    return JPoisson(jc.unit_cube_tet(n)), PoissonProblem(tc.unit_cube_tet(n), device="cpu")


def _rho_batch(e, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 2.0, size=(B, e))


def _case(name, plan_t):
    """(JAX form, JAX leaves_batch, torch form, torch leaves_batch, coords
    batch as numpy or None, arity) for one batching convention."""
    e, n = plan_t.num_cells, plan_t.num_dofs
    rng = np.random.default_rng(11)
    if name == "rho_p1_kernel":
        r = _rho_batch(e)
        return (jwf.diffusion(jnp.asarray(r[0])), (jnp.asarray(r), None),
                twf.diffusion(torch.as_tensor(r[0])), (torch.as_tensor(r), None), None, "m")
    if name == "scale_bare_tensor":
        s = rng.uniform(0.5, 2.0, B)
        return (jwf.diffusion(2.0), (None, jnp.asarray(s)),
                twf.diffusion(2.0), (None, torch.as_tensor(s)), None, "m")
    if name == "mass_plus_diffusion":
        c = rng.uniform(0.5, 2.0, (B, e))
        return (jwf.diffusion() + jwf.mass(jnp.asarray(c[0])), (None, jnp.asarray(c), None),
                twf.diffusion() + twf.mass(torch.as_tensor(c[0])),
                (None, torch.as_tensor(c), None), None, "m")
    if name == "coords_batch":
        base = np.asarray(jc.unit_cube_tet(3).points)[np.asarray(jc.unit_cube_tet(3).cells)]
        cb = base[None] * rng.uniform(0.8, 1.2, (B, 1, 1, 3))
        return (jwf.diffusion(1.5), None, twf.diffusion(1.5), None, cb, "m")
    if name == "nodal_source":
        f = rng.normal(size=(B, n))
        return (jwf.source(jnp.asarray(f[0])), jnp.asarray(f),
                twf.source(torch.as_tensor(f[0])), torch.as_tensor(f), None, "v")
    raise KeyError(name)


CASES = ["rho_p1_kernel", "scale_bare_tensor", "mass_plus_diffusion", "coords_batch",
         "nodal_source"]


@pytest.mark.parametrize("case", CASES)
def test_assemble_batched_matches_stacked_and_jax(case):
    pj, pt = _problems()
    fj, lj, ft, lt, cb, arity = _case(case, pt.plan)
    cbj = None if cb is None else jnp.asarray(cb)
    cbt = None if cb is None else torch.as_tensor(cb)
    if arity == "m":
        want = np.asarray(jc.assemble_batched(pj.plan, fj, cbj, lj).vals)
        kb = tc.assemble_batched(pt.plan, ft, cbt, lt)
        assert isinstance(kb, tc.BatchedCSR) and kb.batch == B
        got = kb.vals
    else:
        want = np.asarray(jc.assemble_rhs_batched(pj.plan, fj, cbj, lj))
        got = pt.asm.assemble_rhs_batched(ft, cbt, lt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    # each instance equals its own single assembly
    lt = lt if isinstance(lt, tuple) or lt is None else (lt, None)
    for b in range(B):
        leaves = twf.lower(ft, twf.MATRIX if arity == "m" else twf.VECTOR)[1]
        inst = [v if s is None else s[b] for v, s in zip(leaves, lt or (None,) * len(leaves))]
        form = _rebuild(ft, inst)
        coords = None if cbt is None else cbt[b]
        single = (tc.assemble(pt.plan, form, coords).vals if arity == "m"
                  else tc.assemble_rhs(pt.plan, form, coords))
        np.testing.assert_allclose(got[b].numpy(), single.numpy(), atol=1e-13, rtol=0)


def _rebuild(form, values):
    """``form`` with its value slots replaced by ``values`` in slot order."""
    it = iter(values)
    terms = []
    for t in form.terms:
        coeffs = tuple(c if c is None or callable(c) else next(it) for c in t.coeffs)
        terms.append(twf.Term(t.kind, coeffs, t.domain, next(it)))
    return twf.WeakForm(tuple(terms))


def test_batched_assembly_errors():
    _, pt = _problems()
    r = torch.ones((B, pt.plan.num_cells), dtype=torch.float64)
    with pytest.raises(ValueError, match="nothing is batched"):
        tc.assemble_batched(pt.plan, twf.diffusion(r[0]))
    with pytest.raises(ValueError, match="slots"):
        tc.assemble_batched(pt.plan, twf.diffusion(r[0]), leaves_batch=(r, None, None))
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        tc.assemble_batched(pt.plan, twf.diffusion(r[0]),
                            leaves_batch=(r, torch.ones(B + 1, dtype=torch.float64)))


def test_batched_csr_stack_index_and_condense():
    pj, pt = _problems()
    rho = _rho_batch(pt.plan.num_cells)
    singles = [pt.asm.assemble(twf.diffusion(torch.as_tensor(r))) for r in rho]
    kb = tc.BatchedCSR.stack(singles)
    assert kb.batch == B and kb.nnz == pt.plan.nnz and kb.shape == singles[0].shape
    np.testing.assert_array_equal(kb[1].vals.numpy(), singles[1].vals.numpy())
    assert kb[1:].batch == B - 1 and kb[0].pattern is kb.pattern
    with pytest.raises(TypeError):
        kb[[0, 1]]
    x = np.random.default_rng(2).normal(size=(B, kb.shape[0]))
    kbj = jc.BatchedCSR.stack([pj.asm.assemble(jwf.diffusion(jnp.asarray(r))) for r in rho])
    np.testing.assert_allclose(kb.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(kbj.matvec(jnp.asarray(x))), atol=1e-12, rtol=0)
    np.testing.assert_allclose(kb.matvec(torch.as_tensor(x[0])).numpy(),
                               np.asarray(kbj.matvec(jnp.asarray(x[0]))), atol=1e-12, rtol=0)
    np.testing.assert_allclose(kb.diagonal().numpy(), np.asarray(kbj.diagonal()), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(kb.to_dense().numpy(), np.asarray(kbj.to_dense()), atol=1e-12,
                               rtol=0)
    np.testing.assert_array_equal(kb.diagonal()[2].numpy(), singles[2].diagonal().numpy())
    # one condensation of the family equals B single ones, and the reference's
    kc = pt.bc.apply_matrix_only(kb)
    for b in range(B):
        np.testing.assert_array_equal(kc[b].vals.numpy(),
                                      pt.bc.apply_matrix_only(singles[b]).vals.numpy())
    np.testing.assert_allclose(kc.vals.numpy(), np.asarray(pj.bc.apply_matrix_only(kbj).vals),
                               atol=1e-12, rtol=0)
    # different patterns (same nnz or not) are refused
    other = PoissonProblem(tc.unit_cube_tet(2), device="cpu").asm.assemble(twf.diffusion())
    with pytest.raises(ValueError, match="patterns differ"):
        tc.BatchedCSR.stack([singles[0], other])
    m = tc.unit_square_tri(4)
    tri = tc.GalerkinAssembler(tc.FunctionSpace(m, tc.element_for_mesh(m)), device="cpu")
    a = tri.assemble(twf.diffusion())
    flipped = tc.CSR.from_arrays(a.vals, a.indptr, a.indices[::-1].copy(), a.shape)
    with pytest.raises(ValueError, match="patterns differ"):
        tc.BatchedCSR.stack([a, flipped])


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_sparse_solve_batched_matches_jax(method):
    pj, pt = _problems()
    rho = _rho_batch(pt.plan.num_cells, seed=3)
    kt = pt.bc.apply_matrix_only(tc.assemble_batched(
        pt.plan, twf.diffusion(torch.as_tensor(rho[0])), leaves_batch=(torch.as_tensor(rho), None)))
    kj = pj.bc.apply_matrix_only(jc.assemble_batched(
        pj.plan, jwf.diffusion(jnp.asarray(rho[0])), leaves_batch=(jnp.asarray(rho), None)))
    b = np.random.default_rng(4).normal(size=(B, kt.shape[0]))
    spec_t, spec_j = tc.SolverSpec(method=method), jc.SolverSpec(method=method)
    xt, it = tc.sparse_solve_batched(kt, torch.as_tensor(b), spec_t, return_info=True)
    xj, ij = jc.sparse_solve_batched(kj, jnp.asarray(b), spec_j, return_info=True)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10, rtol=0)
    np.testing.assert_array_equal(it.iters.numpy(), np.asarray(ij.iters))
    assert it.converged.all() and it.residual.shape == (B,)
    with pytest.raises(TypeError):  # the spec only: no per-kwarg form
        tc.sparse_solve_batched(kt, torch.as_tensor(b), method=method)
    # a shared right-hand side broadcasts
    xs = tc.sparse_solve_batched(kt, torch.as_tensor(b[0]), spec_t)
    np.testing.assert_allclose(xs[1].numpy(), tc.sparse_solve(kt[1], torch.as_tensor(b[0]),
                                                              spec_t).numpy(), atol=0, rtol=0)


def test_solve_batch_matches_jax():
    pj, pt = _problems()
    fb = np.random.default_rng(0).normal(size=(B, pt.space.num_dofs))
    ut, it = pt.solve_batch(fb)
    uj, ij = pj.solve_batch(jnp.asarray(fb))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-10, rtol=0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    single = pt.solve(f=torch.as_tensor(fb[1]))
    np.testing.assert_allclose(ut[1].numpy(), single.u.numpy(), atol=1e-10, rtol=0)


def test_solve_coeff_batch_and_gradient_match_jax():
    pj, pt = _problems()
    rho = _rho_batch(pt.plan.num_cells, seed=5)
    w = np.random.default_rng(6).normal(size=(B, pt.space.num_dofs))
    rt = torch.as_tensor(rho).requires_grad_()
    ut = pt.solve_coeff_batch(rt)
    (torch.as_tensor(w) * ut).sum().backward()

    def loss(r, wj):
        u = pj.solve_coeff_batch(r)
        return jnp.sum(wj * u), u

    # one compiled executable for u and its gradient: eager JAX compiles
    # the Krylov loop at each call
    (_, uj), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(rho), jnp.asarray(w))
    gj = np.asarray(gj)
    np.testing.assert_allclose(ut.detach().numpy(), np.asarray(uj), atol=1e-10, rtol=0)
    np.testing.assert_allclose(rt.grad.numpy(), gj, atol=1e-8 * np.abs(gj).max(), rtol=0)


@pytest.mark.parametrize("d", [2, 3])
def test_p1_function_grads_match_jax(d):
    """B1 with an input that requires grad goes through its autograd
    Function (here around the plain version); ∂/∂coords and ∂/∂ρ of Σ w·K
    equal ``jax.grad`` of the reference's plain Map, single and batched."""
    rng = np.random.default_rng(d)
    e = 9
    coords = rng.normal(size=(e, 1, d)) + np.concatenate([np.zeros((1, d)), np.eye(d)])[None]
    rhos = (rng.uniform(0.5, 2.0, e), rng.uniform(0.5, 2.0, (B, e)))
    ws = tuple(rng.normal(size=(*rho.shape, d + 1, d + 1)) for rho in rhos)

    def single(c, r, w):
        return jnp.sum(w * jref.local_stiffness_p1_ref(c, r))

    def batched(c, r, w):
        return jnp.sum(w * jax.vmap(lambda ri: jref.local_stiffness_p1_ref(c, ri))(r))

    # the single and batched gradients from one compiled executable
    grads = jax.jit(lambda c, r1, rb, w1, wb: (jax.grad(single, argnums=(0, 1))(c, r1, w1),
                                               jax.grad(batched, argnums=(0, 1))(c, rb, wb)))(
        jnp.asarray(coords), *(jnp.asarray(a) for a in rhos + ws))
    for rho, w, (gc, gr) in zip(rhos, ws, grads):
        ct, rt = (torch.as_tensor(a).requires_grad_() for a in (coords, rho))
        k = local_stiffness_p1(ct, rt)
        assert type(k.grad_fn).__name__ == "_P1StiffnessBackward"
        (torch.as_tensor(w) * k).sum().backward()
        np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc), atol=1e-12, rtol=0)
        np.testing.assert_allclose(rt.grad.numpy(), np.asarray(gr), atol=1e-12, rtol=0)
    # only ρ requires grad: no coordinate gradient is formed
    rt = torch.as_tensor(rho).requires_grad_()
    local_stiffness_p1(torch.as_tensor(coords), rt).sum().backward()
    assert rt.grad is not None
    with torch.no_grad():
        assert local_stiffness_p1(torch.as_tensor(coords), rt).grad_fn is None


def test_p1_function_gradcheck():
    rng = np.random.default_rng(7)
    coords = torch.as_tensor(rng.normal(size=(5, 1, 3)) + np.concatenate(
        [np.zeros((1, 3)), np.eye(3)])[None]).requires_grad_()
    rho = torch.as_tensor(rng.uniform(0.5, 2.0, (2, 5))).requires_grad_()
    assert torch.autograd.gradcheck(local_stiffness_p1, (coords, rho))
    assert torch.autograd.gradcheck(local_stiffness_p1, (coords, rho[0].detach().requires_grad_()))


@pytest.mark.parametrize("e", [1, 7, 130])
def test_batched_plain_versions_equal_instance_calls(e):
    rng = np.random.default_rng(e)
    for d in (2, 3):
        coords = torch.as_tensor(rng.normal(size=(e, d + 1, d)))
        rho = torch.as_tensor(rng.uniform(0.5, 2.0, (B, e)))
        got = local_stiffness_p1_ref(coords, rho)
        assert got.shape == (B, e, d + 1, d + 1)
        for b in range(B):
            np.testing.assert_allclose(got[b].numpy(),
                                       local_stiffness_p1_ref(coords, rho[b]).numpy(),
                                       atol=1e-12 * float(got.abs().max()), rtol=0)
        np.testing.assert_array_equal(local_stiffness_p1(coords, rho).numpy(), got.numpy())
    rows = rng.integers(0, e, size=3 * e + 1)
    perm = np.argsort(rows, kind="stable")
    table = kernels.ReduceTable(perm, rows[perm], rows, e, "cpu")
    src = torch.as_tensor(rng.normal(size=(B, rows.shape[0])))
    got = seg_reduce(src, table, batch=True)
    assert got.shape == (B, e)
    for b in range(B):
        np.testing.assert_array_equal(got[b].numpy(), seg_reduce(src[b], table).numpy())
        np.testing.assert_array_equal(
            got[b].numpy(), seg_reduce_ref(src[b], table.rows, table.n_rows).numpy())
    with pytest.raises(ValueError, match="local values"):
        seg_reduce(src[:, :-1], table, batch=True)
    # the batched Reduce's gradient gathers each instance's output gradient
    src.requires_grad_()
    g = torch.as_tensor(rng.normal(size=(B, e)))
    (g * seg_reduce(src, table, batch=True)).sum().backward()
    np.testing.assert_array_equal(src.grad.numpy(), g[:, table.rows].numpy())


def test_from_numpy_carries_a_batched_csr():
    pj, pt = _problems()
    rho = _rho_batch(pt.plan.num_cells)
    kbj = jc.assemble_batched(pj.plan, jwf.diffusion(jnp.asarray(rho[0])),
                              leaves_batch=(jnp.asarray(rho), None))
    got = convert.from_numpy({"vals": np.asarray(kbj.vals), "indptr": kbj.indptr,
                              "indices": kbj.indices, "shape": kbj.shape}, "cpu")["csr"]
    assert isinstance(got, tc.BatchedCSR) and got.batch == B
    kbt = tc.assemble_batched(pt.plan, twf.diffusion(torch.as_tensor(rho[0])),
                              leaves_batch=(torch.as_tensor(rho), None))
    np.testing.assert_allclose(got.vals.numpy(), kbt.vals.numpy(), atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# on a CUDA machine: the batched kernels, one launch per batched assembly
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_batched_assembly_is_one_launch_each(cuda):
    on_card = PoissonProblem(tc.unit_cube_tet(4), device=cuda)
    _, on_cpu = _problems(4)
    rho = torch.as_tensor(_rho_batch(on_cpu.plan.num_cells))
    kernels.reset_launches()
    kb = tc.assemble_batched(on_card.plan, twf.diffusion(rho[0].to(cuda)),
                             leaves_batch=(rho.to(cuda), None))
    assert kernels.LAUNCHES["local_stiffness_p1"] == 1 and kernels.LAUNCHES["seg_reduce"] == 1
    want = tc.assemble_batched(on_cpu.plan, twf.diffusion(rho[0]), leaves_batch=(rho, None))
    torch.testing.assert_close(kb.vals.cpu(), want.vals, atol=1e-12, rtol=0)


@pytest.mark.cuda
def test_cuda_p1_function_gradcheck(cuda):
    rng = np.random.default_rng(8)
    coords = torch.as_tensor(rng.normal(size=(6, 1, 3)) + np.concatenate(
        [np.zeros((1, 3)), np.eye(3)])[None], device=cuda).requires_grad_()
    rho = torch.as_tensor(rng.uniform(0.5, 2.0, (2, 6)), device=cuda).requires_grad_()
    kernels.reset_launches()
    assert torch.autograd.gradcheck(local_stiffness_p1, (coords, rho))
    assert kernels.LAUNCHES["local_stiffness_p1"] > 0
