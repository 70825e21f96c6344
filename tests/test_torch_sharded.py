"""Torch port parity for element-parallel sharding (``repro_torch.sharding``,
``assemble_sharded`` / ``assemble_rhs_sharded``,
``ShardedMatFreeOperator``, the ``matfree_sharded`` backend, the θ-method
and the problem classes on it) against ``repro``'s sharded functions,
case by case as ``tests/test_sharded_assembly.py`` and
``tests/test_matfree_sharded.py``.

Each case (``tests/torch_sharded_worker.py``) runs on the one-rank mesh in
this process, and in gloo worlds of 2 and of 4 ranks on the CPU, each
started once for the module; 4 ranks split ``unit_square_tri(9)`` (E =
162) and ``unit_cube_tet(3)`` unevenly.  Every rank of a world must return
bit-identical results (iteration counts included), and rank 0 must match
the JAX package on one host device: assembled values and applies at
1e-12, solves and θ rollouts at 1e-10 of max|u| with iteration counts
within ±1, gradients at 1e-8 of max|g| (``jax.grad``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import weakform as jwf  # noqa: E402
from repro.fem import tensormesh as jtm  # noqa: E402
from repro.sharding.partitioning import FEM_MESH_AXIS as J_AXIS  # noqa: E402
from repro.sharding.partitioning import fem_mesh as jfem_mesh  # noqa: E402
from repro.transient import CRANK_NICOLSON as J_CN  # noqa: E402
from repro.transient import ThetaIntegrator as JTheta  # noqa: E402

import torch_sharded_worker as worker  # noqa: E402
from repro_torch.sharding import FEM_MESH_AXIS, fem_mesh  # noqa: E402

SIZES = (1, 2, 4)
TOL = worker.TOL_SOLVE
SPEC = dict(method="cg", tol=TOL, atol=TOL)


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """The gloo worlds of 2 and 4 ranks, started before the first test;
    they run while this process computes the JAX references."""
    workdir = str(tmp_path_factory.mktemp("sharded_rendezvous"))
    started = {size: worker.World(size, workdir, tuple(worker.CASES)) for size in SIZES[1:]}
    for case in worker.CASES:
        _jax(case)
    yield started
    for world in started.values():
        world.close()


@functools.lru_cache(maxsize=None)
def _one_rank(case):
    return worker.CASES[case](fem_mesh(device="cpu"))


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def _result(worlds, size, case) -> dict:
    """Rank 0's result of ``case`` on a mesh of ``size`` ranks, after
    holding every rank's result (but its ``per_rank`` entry) equal to it
    bit for bit."""
    if size == 1:
        return _one_rank(case)
    ranks = [res[case] for res in worlds[size].results()]
    for r, res in enumerate(ranks[1:], start=1):
        assert res.keys() == ranks[0].keys()
        for key in res:
            if key != "per_rank":
                assert _equal(res[key], ranks[0][key]), f"{case}: rank {r} differs in {key}"
    return ranks[0]


def _close(got, want, atol):
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _rel(got, want, tol):
    want = np.asarray(want)
    _close(got, want, tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# the JAX side: repro's sharded functions on one host device
# ---------------------------------------------------------------------------

def _jplan(gen, n, value_size=1):
    m = getattr(jc, gen)(n)
    sp = jc.FunctionSpace(m, jc.mesh.element_for_mesh(m), value_size)
    plan = jc.build_plan(sp)
    return m, sp, plan, jc.DirichletCondenser(plan.static.mat_routing, sp.boundary_dofs())


def _sop(plan, form, store="context"):
    return jc.matfree_operator(plan, form, store=store).sharded()


@functools.lru_cache(maxsize=None)
def _jax(case) -> dict:
    d = worker.data(case)
    if case == "matrix":
        _, _, plan, bc = _jplan("unit_square_tri", d["n"])
        form = jwf.diffusion(jnp.asarray(d["rho"])) + jwf.mass(0.7)
        return {"vals": jc.assemble_sharded(plan, form, mesh=jfem_mesh()).vals}
    if case == "nondivisible":
        _, _, plan, _ = _jplan("unit_square_tri", d["n"])
        sop = jc.matfree_operator(plan, jwf.diffusion()).sharded(mesh=jfem_mesh(),
                                                                 axis_name=J_AXIS)
        return {"vals": jc.assemble_sharded(plan, jwf.diffusion(), mesh=jfem_mesh()).vals,
                "matvec": sop.matvec(jnp.asarray(d["x"]))}
    if case == "coeff_kinds":
        _, sp, plan, _ = _jplan("unit_square_tri", d["n"])
        forms = (jwf.diffusion(jnp.asarray(sp.dof_points[:, 0] + 0.5)),
                 jwf.diffusion(jnp.asarray(d["per_elem"])) + jwf.advection(jnp.array([1.0, 0.5])),
                 jwf.anisotropic_diffusion(jnp.array([[2.0, 0.3], [0.3, 1.0]])))
        return {f"vals{i}": jc.assemble_sharded(plan, form, mesh=jfem_mesh()).vals
                for i, form in enumerate(forms)}
    if case == "rhs":
        _, _, plan, _ = _jplan("unit_square_tri", 8)
        src = jwf.source(lambda x: x[..., 0] * x[..., 1])
        return {"rhs": jc.assemble_rhs_sharded(plan, src, mesh=jfem_mesh())}
    if case == "elasticity":
        m = jc.unit_square_tri(d["n"])
        asm = jc.GalerkinAssembler(jc.FunctionSpace(m, jc.mesh.element_for_mesh(m), 2))
        form = jwf.elasticity(1.2, 0.8, scale=jnp.asarray(d["scale"]))
        return {"vals": asm.assemble_sharded(form, mesh=jfem_mesh()).vals}
    if case.startswith("apply_"):
        _, _, plan, _ = _jplan("unit_square_tri", d["n"])
        form = jwf.diffusion(jnp.asarray(d["rho"])) + 0.3 * jwf.mass()
        sop, x = _sop(plan, form, case[len("apply_"):]), jnp.asarray(d["x"])
        return {"matvec": sop.matvec(x), "rmatvec": sop.rmatvec(x), "diagonal": sop.diagonal()}
    if case == "transpose":
        _, _, plan, _ = _jplan("unit_square_tri", d["n"])
        sop = _sop(plan, jwf.diffusion(1.0) + jwf.advection(jnp.asarray([1.0, 0.5])))
        x = jnp.asarray(d["x"])
        return {"matvec": sop.matvec(x), "rmatvec": sop.rmatvec(x)}
    if case == "vector_space":
        _, _, plan, _ = _jplan("unit_square_tri", d["n"], 2)
        sop = _sop(plan, jwf.elasticity(1.2, 0.6))
        return {"matvec": sop.matvec(jnp.asarray(d["x"])), "diagonal": sop.diagonal()}
    if case == "solve":
        _, _, plan, bc = _jplan("unit_cube_tet", d["n"])
        form = jwf.diffusion(jnp.asarray(d["rho"])) + 0.3 * jwf.mass()
        u, info = jc.matfree_solve(_sop(plan, form).condensed(bc),
                                   bc.project_residual(jnp.asarray(d["b"])),
                                   jc.SolverSpec(**SPEC), return_info=True)
        return {"u": u, "iters": int(info.iters)}
    if case in ("grad", "reapply", "collectives"):
        _, _, plan, bc = _jplan("unit_cube_tet", d["n"])
        rho, b = jnp.asarray(d["rho"]), bc.project_residual(jnp.asarray(d["b"]))
        if case == "reapply":
            return {"y1": _sop(plan, jwf.diffusion(rho)).matvec(jnp.asarray(d["b"])),
                    "y2": _sop(plan, jwf.diffusion(2.0 * rho)).matvec(jnp.asarray(d["b"]))}
        if case == "collectives":
            x = jnp.asarray(d["b"])
            return {"g": jax.grad(lambda r: jnp.sum(_sop(plan, jwf.diffusion(r)).matvec(x)))(rho)}
        spec = jc.SolverSpec(method="cg", tol=1e-13, atol=1e-13)

        @jax.jit
        def run(r, bb):
            def loss(r, bb):
                u = jc.matfree_solve(_sop(plan, jwf.diffusion(r)).condensed(bc), bb, spec)
                return jnp.sum(u ** 2), u

            (_, u), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(r, bb)
            return u, grads

        u, (g_rho, g_b) = run(rho, b)
        return {"u": u, "g_rho": g_rho, "g_b": g_b}
    if case == "registry":
        _, _, plan, _ = _jplan("unit_square_tri", d["n"])
        op = jc.matfree_operator(plan, jwf.diffusion(1.0) + 0.2 * jwf.mass())
        x, f = jnp.asarray(d["x"]), jnp.asarray(d["f"])
        return {"matvec": jc.make_matvec(op, "matfree_sharded")(x),
                "residual": jc.make_residual(op, "matfree_sharded")(x, f)}
    if case == "problems":
        res = jtm.PoissonProblem(jc.unit_cube_tet(4)).solve(
            backend="matfree_sharded", spec=jc.SolverSpec(**SPEC))
        return {"poisson_u": res.u, "poisson_iters": res.iters}
    if case == "theta":
        m = jc.unit_square_tri(d["n"])
        sp = jc.FunctionSpace(m, jc.mesh.element_for_mesh(m))
        asm = jc.GalerkinAssembler(sp)
        bc = jc.DirichletCondenser(asm, sp.boundary_dofs())
        integ = JTheta.from_form(asm, jwf.diffusion(1.0), d["dt"], theta=J_CN, bc=bc, tol=TOL,
                                 backend="matfree_sharded")
        traj, info = integ.rollout(bc.project_residual(jnp.asarray(d["u0"])), d["steps"],
                                   return_info=True)
        return {"traj": traj, "iters": np.asarray(info.iters).tolist()}
    return {}  # a case held against the port's own single-device path


# ---------------------------------------------------------------------------
# the mesh (tests/test_sharded_assembly.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_fem_mesh_uses_named_element_axis(worlds, size):
    assert FEM_MESH_AXIS == J_AXIS and jfem_mesh().axis_names == (J_AXIS,)
    res = _result(worlds, size, "fem_mesh")
    assert res["size"] == size and res["axis_ok"] and res["raised_available"]
    if size > 1:
        per_rank = [r["fem_mesh"]["per_rank"] for r in worlds[size].results()]
        assert [p["rank"] for p in per_rank] == list(range(size))
        # ⌈E/P⌉ blocks: contiguous, covering E once
        blocks = [p["block"] for p in per_rank]
        assert blocks[0][0] == 0 and blocks[-1][1] == 162
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


# ---------------------------------------------------------------------------
# sharded assembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_sharded_matrix_and_solution_match(worlds, size):
    """The values against the JAX package's; the solve on them against
    the solve on the single-device assembly."""
    res, ref = _result(worlds, size, "matrix"), _jax("matrix")
    _close(res["vals"], ref["vals"], 1e-12)
    _rel(res["u"], res["unsharded_u"], 1e-10)
    assert abs(res["iters"] - res["unsharded_iters"]) <= 1


@pytest.mark.parametrize("size", SIZES)
def test_sharded_handles_nondivisible_element_count(worlds, size):
    res, ref = _result(worlds, size, "nondivisible"), _jax("nondivisible")
    assert res["cells"] == 162 and res["cells"] % 4 != 0
    _close(res["vals"], ref["vals"], 1e-12)
    _close(res["matvec"], ref["matvec"], 1e-12)
    if size == 4:
        blocks = [r["nondivisible"]["per_rank"]["block"] for r in worlds[size].results()]
        assert blocks == [[0, 41], [41, 82], [82, 123], [123, 162]]


@pytest.mark.parametrize("size", SIZES)
def test_sharded_coefficient_kinds(worlds, size):
    res, ref = _result(worlds, size, "coeff_kinds"), _jax("coeff_kinds")
    for key in ref:
        _close(res[key], ref[key], 1e-12)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_rhs_matches_jax(worlds, size):
    _close(_result(worlds, size, "rhs")["rhs"], _jax("rhs")["rhs"], 1e-12)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_vector_space_elasticity(worlds, size):
    _close(_result(worlds, size, "elasticity")["vals"], _jax("elasticity")["vals"], 1e-12)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_rejects_facet_terms(worlds, size):
    assert _result(worlds, size, "facet_refusal")["refused"]


# ---------------------------------------------------------------------------
# the sharded matrix-free operator (tests/test_matfree_sharded.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["coords", "context", "local"])
@pytest.mark.parametrize("size", SIZES)
def test_sharded_apply_parity(worlds, size, store):
    res, ref = _result(worlds, size, f"apply_{store}"), _jax(f"apply_{store}")
    assert res["is_sharded"] and res["shape"] == [64, 64]
    for key in ("matvec", "rmatvec", "diagonal"):
        _close(res[key], ref[key], 1e-12)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_transpose_on_nonsymmetric_form(worlds, size):
    res, ref = _result(worlds, size, "transpose"), _jax("transpose")
    _close(res["rmatvec"], ref["rmatvec"], 1e-12)
    _close(res["matvec"], ref["matvec"], 1e-12)
    assert np.abs(res["matvec"] - res["rmatvec"]).max() > 1e-8  # truly nonsymmetric


@pytest.mark.parametrize("size", SIZES)
def test_sharded_vector_valued_space(worlds, size):
    res, ref = _result(worlds, size, "vector_space"), _jax("vector_space")
    _close(res["matvec"], ref["matvec"], 1e-12)
    _close(res["diagonal"], ref["diagonal"], 1e-12)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_solve_matches_jax(worlds, size):
    res, ref = _result(worlds, size, "solve"), _jax("solve")
    _rel(res["u"], ref["u"], 1e-10)
    assert abs(res["iters"] - ref["iters"]) <= 1


@pytest.mark.parametrize("size", SIZES)
def test_sharded_grads_match_jax(worlds, size):
    res, ref = _result(worlds, size, "grad"), _jax("grad")
    _rel(res["u"], ref["u"], 1e-10)
    _rel(res["g_rho"], ref["g_rho"], 1e-8)
    _rel(res["g_b"], ref["g_b"], 1e-8)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_reapply_builds_no_scaffold(worlds, size):
    res, ref = _result(worlds, size, "reapply"), _jax("reapply")
    # the first operator counts two builds (matrix-free operator, sharded
    # scaffold); new coefficient values on the same signature count none
    assert res["built"] == 2 and res["rebuilt"] == 0
    _close(res["y1"], ref["y1"], 1e-12)
    _close(res["y2"], ref["y2"], 1e-12)
    _close(res["y2"], 2.0 * res["y1"], 1e-12)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_collectives_per_apply(worlds, size):
    """One all-reduce per apply, per diagonal and per assembly; a
    differentiated apply adds one in the backward for the coefficient;
    the one-rank mesh without a process group issues none."""
    res, ref = _result(worlds, size, "collectives"), _jax("collectives")
    one = 1 if size > 1 else 0
    for name in ("matvec", "diagonal", "assemble"):
        assert res["counts"][name] == {"reduce_from_shards": one, "to_shard": 0}
    assert res["counts"]["grad_apply"] == {"reduce_from_shards": one, "to_shard": one}
    _rel(res["g"], ref["g"], 1e-12)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_block_takes_the_fused_action(worlds, size):
    """Each rank's block of a P1 diffusion apply runs the fused kernel
    (one ``matfree_action{path=fused}`` an apply); a differentiated apply
    takes the einsum path."""
    res = _result(worlds, size, "collectives")
    assert res["paths"] == {"matvec": {"fused": 1, "einsum": 0},
                            "grad_apply": {"fused": 0, "einsum": 1}}


# ---------------------------------------------------------------------------
# registry and consumers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_registry_dispatch_parity_and_refusal(worlds, size):
    res, ref = _result(worlds, size, "registry"), _jax("registry")
    _close(res["matvec"], ref["matvec"], 1e-12)
    _close(res["residual"], ref["residual"], 1e-12)
    _close(res["matvec"], res["csr_matvec"], 1e-12)
    _close(res["passthrough"], ref["matvec"], 1e-12)
    assert res["csr_refused"] and res["matfree_to_stream_refused"]


@pytest.mark.parametrize("size", SIZES)
def test_problem_classes_sharded_backend(worlds, size):
    """``PoissonProblem`` against the JAX package's sharded solve; the
    advection-diffusion and elasticity problems against their own
    ``matfree`` solve (held against the JAX package in
    ``tests/test_torch_matfree.py``)."""
    res, ref = _result(worlds, size, "problems"), _jax("problems")
    _rel(res["poisson_u"], ref["poisson_u"], 1e-10)
    assert abs(res["poisson_iters"] - ref["poisson_iters"]) <= 1
    for name in ("poisson", "advection", "elasticity"):
        assert res[f"{name}_converged"]
        _rel(res[f"{name}_u"], res[f"{name}_unsharded_u"], 1e-10)
        assert abs(res[f"{name}_iters"] - res[f"{name}_unsharded_iters"]) <= 1


@pytest.mark.parametrize("size", SIZES)
def test_ebe_on_a_sharded_operator(worlds, size):
    """As in the reference, EbE reads the element matrices of the wrapped
    operator and the sharded diagonal: the solve equals the one on the
    unsharded operator (held against the JAX package in
    ``tests/test_torch_elemalg.py``)."""
    res = _result(worlds, size, "ebe")
    _rel(res["u"], res["unsharded_u"], 1e-10)
    assert abs(res["iters"] - res["unsharded_iters"]) <= 1


@pytest.mark.parametrize("size", SIZES)
def test_theta_integrator_sharded_backend(worlds, size):
    res, ref = _result(worlds, size, "theta"), _jax("theta")
    assert res["sharded"]
    _rel(res["traj"], ref["traj"], 1e-10)
    assert max(abs(a - b) for a, b in zip(res["iters"], ref["iters"])) <= 1
