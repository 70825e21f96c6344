"""The rank side of ``tests/test_torch_sharded.py``: the sharded cases of
``repro_torch`` run on one mesh, and the launcher of a gloo world of
ranks on the CPU that runs them.

Every case takes the mesh and returns a dict of numpy arrays and Python
numbers; a gloo world runs each case on every rank, so the test can hold
the ranks equal and rank 0 against the JAX package.  The inputs are made
with numpy from fixed seeds (:func:`data`), so the test makes the same ones
for the JAX side.  This module imports torch only in the functions a rank
runs (never JAX), so a spawned rank starts fast."""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import traceback

import numpy as np

TOL_SOLVE = 1e-12
GROUP_TIMEOUT_S = 60


def data(case: str) -> dict:
    """The numpy inputs of a case (shared with the JAX side); none for a
    case that makes its own."""
    if case == "matrix":
        return {"n": 8, "rho": np.random.default_rng(0).uniform(0.5, 2.0, 2 * 8 * 8)}
    if case == "coeff_kinds":
        return {"n": 8, "per_elem": np.random.default_rng(1).uniform(0.5, 2.0, 2 * 8 * 8)}
    if case == "elasticity":
        return {"n": 6, "scale": np.random.default_rng(2).uniform(0.5, 1.0, 2 * 6 * 6)}
    if case.startswith("apply_"):
        rng = np.random.default_rng(3)
        return {"n": 7, "rho": rng.uniform(0.5, 2.0, 2 * 7 * 7), "x": rng.standard_normal(64)}
    if case in ("transpose", "registry"):
        rng = np.random.default_rng(4)
        return {"n": 8, "x": rng.standard_normal(81), "f": rng.standard_normal(81)}
    if case == "nondivisible":
        return {"n": 9, "x": np.random.default_rng(5).standard_normal(100)}
    if case == "vector_space":
        return {"n": 6, "x": np.random.default_rng(6).standard_normal(2 * 49)}
    if case in ("solve", "grad", "reapply", "collectives"):
        n = 4 if case == "solve" else 3
        rng = np.random.default_rng(7 if case == "solve" else 8)
        return {"n": n, "rho": rng.uniform(0.5, 2.0, 6 * n ** 3),
                "b": rng.standard_normal((n + 1) ** 3)}
    if case == "ebe":
        rng = np.random.default_rng(9)
        return {"n": 8, "rho": rng.uniform(0.5, 2.0, 2 * 8 * 8), "b": rng.standard_normal(81)}
    if case == "theta":
        return {"n": 8, "u0": np.random.default_rng(10).standard_normal(81), "dt": 0.01,
                "steps": 5}
    return {}


# ---------------------------------------------------------------------------
# the cases (torch only)
# ---------------------------------------------------------------------------

def _space(gen: str, n: int, value_size: int = 1):
    import repro_torch.core as tc

    m = getattr(tc, gen)(n)
    return m, tc.FunctionSpace(m, tc.element_for_mesh(m), value_size)


def _plan(gen: str, n: int, value_size: int = 1):
    import repro_torch.core as tc

    m, sp = _space(gen, n, value_size)
    plan = tc.build_plan(sp, device="cpu")
    return m, sp, plan, tc.DirichletCondenser(plan.mat_routing, sp.boundary_dofs(), device="cpu")


def _t(a):
    import torch

    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def case_fem_mesh(mesh) -> dict:
    from repro_torch.sharding import FEM_MESH_AXIS, fem_mesh

    got = fem_mesh(device="cpu")
    try:
        fem_mesh(n_devices=got.size + 1, device="cpu")
        raised = ""
    except ValueError as err:
        raised = str(err)
    return {"size": got.size, "axis_names": list(got.axis_names),
            "axis_ok": got.axis_names == (FEM_MESH_AXIS,), "raised_available": "available" in raised,
            "per_rank": {"rank": got.rank, "block": list(got.block(162))}}


def case_matrix(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("matrix")
    _, _, plan, bc = _plan("unit_square_tri", d["n"])
    form = wf.diffusion(_t(d["rho"])) + wf.mass(0.7)
    k = tc.assemble_sharded(plan, form, mesh=mesh)
    f = bc.project_residual(tc.assemble_rhs(plan, wf.source(1.0)))
    spec = tc.SolverSpec(method="cg", tol=TOL_SOLVE, atol=TOL_SOLVE, maxiter=2000)
    u, info = tc.sparse_solve(bc.apply_matrix_only(k), f, spec, return_info=True)
    u1, info1 = tc.sparse_solve(bc.apply_matrix_only(tc.assemble(plan, form)), f, spec,
                                return_info=True)
    return {"vals": _np(k.vals), "u": _np(u), "iters": info.iters, "unsharded_u": _np(u1),
            "unsharded_iters": info1.iters}


def case_nondivisible(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf
    from repro_torch.sharding import FEM_MESH_AXIS

    d = data("nondivisible")
    m, _, plan, _ = _plan("unit_square_tri", d["n"])
    op = tc.matfree_operator(plan, wf.diffusion())
    sop = op.sharded(mesh=mesh, axis_name=FEM_MESH_AXIS)
    return {"cells": m.num_cells, "vals": _np(tc.assemble_sharded(plan, wf.diffusion(), mesh).vals),
            "matvec": _np(sop.matvec(_t(d["x"]))),
            "per_rank": {"block": list(plan.shard(mesh).block)}}


def case_coeff_kinds(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("coeff_kinds")
    _, sp, plan, _ = _plan("unit_square_tri", d["n"])
    nodal = _t(sp.dof_points[:, 0] + 0.5)
    forms = (wf.diffusion(nodal),
             wf.diffusion(_t(d["per_elem"])) + wf.advection(_t([1.0, 0.5])),
             wf.anisotropic_diffusion(_t([[2.0, 0.3], [0.3, 1.0]])))
    return {f"vals{i}": _np(tc.assemble_sharded(plan, form, mesh=mesh).vals)
            for i, form in enumerate(forms)}


def case_rhs(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    _, _, plan, _ = _plan("unit_square_tri", 8)
    src = wf.source(lambda x: x[..., 0] * x[..., 1])
    return {"rhs": _np(tc.assemble_rhs_sharded(plan, src, mesh=mesh))}


def case_elasticity(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("elasticity")
    _, sp = _space("unit_square_tri", d["n"], 2)
    asm = tc.GalerkinAssembler(sp, device="cpu")
    form = wf.elasticity(1.2, 0.8, scale=_t(d["scale"]))
    return {"vals": _np(asm.assemble_sharded(form, mesh=mesh).vals)}


def case_facet_refusal(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    m, sp = _space("unit_square_tri", 5)
    asm = tc.GalerkinAssembler(sp, device="cpu")
    fa = tc.FacetAssembler(sp, m.boundary_facets(), volume_routing=asm.mat_routing,
                           device="cpu")
    try:
        tc.assemble_sharded(asm.plan, wf.diffusion() + wf.robin(1.0, on=fa), mesh=mesh)
        msg = ""
    except NotImplementedError as err:
        msg = str(err)
    return {"refused": "volume terms only" in msg}


def _apply_case(store: str, mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data(f"apply_{store}")
    _, _, plan, _ = _plan("unit_square_tri", d["n"])
    op = tc.matfree_operator(plan, wf.diffusion(_t(d["rho"])) + 0.3 * wf.mass(), store=store)
    sop = op.sharded(mesh)
    x = _t(d["x"])
    return {"is_sharded": isinstance(sop, tc.ShardedMatFreeOperator),
            "shape": list(sop.shape), "matvec": _np(sop.matvec(x)),
            "rmatvec": _np(sop.rmatvec(x)), "diagonal": _np(sop.diagonal())}


def case_apply_coords(mesh) -> dict:
    return _apply_case("coords", mesh)


def case_apply_context(mesh) -> dict:
    return _apply_case("context", mesh)


def case_apply_local(mesh) -> dict:
    return _apply_case("local", mesh)


def case_transpose(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("transpose")
    _, _, plan, _ = _plan("unit_square_tri", d["n"])
    sop = tc.matfree_operator(plan, wf.diffusion(1.0) + wf.advection(_t([1.0, 0.5]))).sharded(mesh)
    x = _t(d["x"])
    return {"matvec": _np(sop.matvec(x)), "rmatvec": _np(sop.rmatvec(x))}


def case_vector_space(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("vector_space")
    _, _, plan, _ = _plan("unit_square_tri", d["n"], 2)
    sop = tc.matfree_operator(plan, wf.elasticity(1.2, 0.6)).sharded(mesh)
    return {"matvec": _np(sop.matvec(_t(d["x"]))), "diagonal": _np(sop.diagonal())}


def case_solve(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("solve")
    _, _, plan, bc = _plan("unit_cube_tet", d["n"])
    b = bc.project_residual(_t(d["b"]))
    op = tc.matfree_operator(plan, wf.diffusion(_t(d["rho"])) + 0.3 * wf.mass())
    u, info = tc.matfree_solve(op.sharded(mesh).condensed(bc), b,
                               tc.SolverSpec(method="cg", tol=TOL_SOLVE, atol=TOL_SOLVE),
                               return_info=True)
    return {"u": _np(u), "iters": info.iters}


def case_grad(mesh) -> dict:
    import torch

    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("grad")
    _, _, plan, bc = _plan("unit_cube_tet", d["n"])
    rho = _t(d["rho"]).requires_grad_(True)
    b = bc.project_residual(_t(d["b"])).detach().requires_grad_(True)
    op = tc.matfree_operator(plan, wf.diffusion(rho)).sharded(mesh).condensed(bc)
    u = tc.matfree_solve(op, b, tc.SolverSpec(method="cg", tol=1e-13, atol=1e-13))
    g_rho, g_b = torch.autograd.grad((u ** 2).sum(), (rho, b))
    return {"u": _np(u), "g_rho": _np(g_rho), "g_b": _np(g_b)}


def case_reapply(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch import telemetry
    from repro_torch.core import weakform as wf

    d = data("reapply")
    _, _, plan, _ = _plan("unit_cube_tet", d["n"])
    rho = _t(d["rho"])
    x = _t(d["b"])
    with telemetry.enabled():
        start = tc.n_matfree_traces()
        sop = tc.matfree_operator(plan, wf.diffusion(rho)).sharded(mesh)
        y1 = sop.matvec(x)
        built = tc.n_matfree_traces() - start
        sop2 = tc.matfree_operator(plan, wf.diffusion(rho * 2.0)).sharded(mesh)
        y2 = sop2.matvec(x)
        rebuilt = tc.n_matfree_traces() - start - built
    return {"built": built, "rebuilt": rebuilt, "y1": _np(y1), "y2": _np(y2)}


def case_registry(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("registry")
    _, _, plan, _ = _plan("unit_square_tri", d["n"])
    form = wf.diffusion(1.0) + 0.2 * wf.mass()
    k = tc.assemble(plan, form)
    op = tc.matfree_operator(plan, form)
    x, f = _t(d["x"]), _t(d["f"])
    out = {"matvec": _np(tc.make_matvec(op, "matfree_sharded")(x)),
           "residual": _np(tc.make_residual(op, "matfree_sharded")(x, f)),
           "passthrough": _np(tc.make_matvec(op.sharded(mesh), "matfree_sharded")(x)),
           "csr_matvec": _np(k.matvec(x))}
    for key, target, backend, word in (("csr_refused", k, "matfree_sharded", "matrix-free"),
                                       ("matfree_to_stream_refused", op, "ell_stream", "CSR")):
        try:
            tc.make_matvec(target, backend)
            out[key] = False
        except TypeError as err:
            out[key] = word in str(err)
    return out


def _action_paths(fn) -> dict:
    """The matrix-free applies of ``fn()`` by path, read from the telemetry
    counter ``matfree_action``."""
    from repro_torch import telemetry

    def read():
        counters = telemetry.snapshot()["counters"]
        return {p: counters.get(f"matfree_action{{path={p}}}", 0) for p in ("fused", "einsum")}

    with telemetry.enabled():
        before = read()
        fn()
        after = read()
    return {p: after[p] - before[p] for p in after}


def case_collectives(mesh) -> dict:
    """The all-reduces of one apply, one diagonal, one sharded assembly and
    one differentiated apply; the paths the rank's block takes in the
    plain apply (the fused P1 diffusion kernel) and the differentiated one
    (einsum)."""
    import torch

    import repro_torch.core as tc
    from repro_torch.core import weakform as wf
    from repro_torch.sharding import COLLECTIVES, reset_collectives

    d = data("collectives")
    _, _, plan, _ = _plan("unit_cube_tet", d["n"])
    rho = _t(d["rho"])
    sop = tc.matfree_operator(plan, wf.diffusion(rho)).sharded(mesh)
    x = _t(d["b"])
    counts = {}
    for name, fn in (("matvec", lambda: sop.matvec(x)), ("diagonal", sop.diagonal),
                     ("assemble", lambda: tc.assemble_sharded(plan, wf.diffusion(rho), mesh))):
        reset_collectives()
        fn()
        counts[name] = dict(COLLECTIVES)
    reset_collectives()
    r = rho.clone().requires_grad_(True)
    y = tc.matfree_operator(plan, wf.diffusion(r)).sharded(mesh).matvec(x)
    g = torch.autograd.grad(y.sum(), r)[0]
    counts["grad_apply"] = dict(COLLECTIVES)
    paths = {"matvec": _action_paths(lambda: sop.matvec(x)),
             "grad_apply": _action_paths(lambda: tc.matfree_operator(
                 plan, wf.diffusion(rho.clone().requires_grad_(True))).sharded(mesh).matvec(x))}
    return {"counts": counts, "g": _np(g), "paths": paths}


def case_problems(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import unit_cube_tet, unit_square_tri
    from repro_torch.fem import AdvectionDiffusionProblem, ElasticityProblem, PoissonProblem

    out = {}
    for name, prob, kw in (
            ("poisson", PoissonProblem(unit_cube_tet(4), device="cpu"), {}),
            ("advection", AdvectionDiffusionProblem(unit_square_tri(6), device="cpu"),
             {"beta": (1.0, 0.5), "dirichlet_values": 0.25}),
            ("elasticity", ElasticityProblem(unit_square_tri(5), device="cpu"), {})):
        spec = tc.SolverSpec(method=prob.method, tol=TOL_SOLVE, atol=TOL_SOLVE)
        res = prob.solve(backend="matfree_sharded", spec=spec, **kw)
        ref = prob.solve(backend="matfree", spec=spec, **kw)
        out.update({f"{name}_u": _np(res.u), f"{name}_iters": res.iters,
                    f"{name}_converged": res.converged, f"{name}_unsharded_u": _np(ref.u),
                    f"{name}_unsharded_iters": ref.iters})
    return out


def case_ebe(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf

    d = data("ebe")
    _, _, plan, bc = _plan("unit_square_tri", d["n"])
    b = bc.project_residual(_t(d["b"]))
    op = tc.matfree_operator(plan, wf.diffusion(_t(d["rho"])))
    spec = tc.SolverSpec(method="cg", tol=TOL_SOLVE, atol=TOL_SOLVE, precond="ebe")
    u, info = tc.matfree_solve(op.sharded(mesh).condensed(bc), b, spec, return_info=True)
    u1, info1 = tc.matfree_solve(op.condensed(bc), b, spec, return_info=True)
    return {"u": _np(u), "iters": info.iters, "unsharded_u": _np(u1),
            "unsharded_iters": info1.iters}


def case_theta(mesh) -> dict:
    import repro_torch.core as tc
    from repro_torch.core import weakform as wf
    from repro_torch.transient import CRANK_NICOLSON, ThetaIntegrator

    d = data("theta")
    _, sp = _space("unit_square_tri", d["n"])
    asm = tc.GalerkinAssembler(sp, device="cpu")
    bc = tc.DirichletCondenser(asm, sp.boundary_dofs())
    u0 = bc.project_residual(_t(d["u0"]))
    integ = ThetaIntegrator.from_form(asm, wf.diffusion(1.0), d["dt"], theta=CRANK_NICOLSON,
                                      bc=bc, tol=TOL_SOLVE, backend="matfree_sharded")
    traj, info = integ.rollout(u0, d["steps"], return_info=True)
    return {"sharded": isinstance(integ.lhs_full, tc.ShardedMatFreeOperator),
            "traj": _np(traj), "iters": info.iters.tolist()}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def run_cases(mesh, names) -> dict:
    return {name: CASES[name](mesh) for name in names}


# ---------------------------------------------------------------------------
# a gloo world on the CPU
# ---------------------------------------------------------------------------

def _rank_main(rank: int, size: int, init_file: str, names, out) -> None:
    """One rank: a gloo group over a file rendezvous, every case on the
    world's mesh, the results (or the traceback) put on ``out``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=size,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        from repro_torch.sharding import fem_mesh

        results = run_cases(fem_mesh(device="cpu"), names)
        dist.barrier()
        out.put((rank, results, None))
    except Exception:  # the rank's boundary: report, then fail the world
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """A gloo world of ``size`` ranks on the CPU, started at once; every
    rank runs ``names``.  :meth:`results` waits for all ranks and returns
    their results in rank order, or raises with a rank's traceback."""

    def __init__(self, size: int, workdir: str, names):
        ctx = multiprocessing.get_context("spawn")
        self.size, self.queue = size, ctx.Queue()
        init_file = os.path.join(workdir, f"rendezvous_{size}")
        self.procs = [ctx.Process(target=_rank_main, args=(r, size, init_file, list(names),
                                                           self.queue), daemon=True)
                      for r in range(size)]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self, timeout: float = 120.0) -> list:
        if self._results is None:
            got = {}
            try:
                for _ in range(self.size):
                    rank, res, err = self.queue.get(timeout=timeout)
                    if err is not None:
                        raise RuntimeError(f"rank {rank} of {self.size} failed:\n{err}")
                    got[rank] = res
            except queue_mod.Empty:
                raise RuntimeError(f"a world of {self.size} ranks gave "
                                   f"{len(got)} results in {timeout} s") from None
            finally:
                self.close()
            self._results = [got[r] for r in range(self.size)]
        return self._results

    def close(self) -> None:
        for p in self.procs:
            p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
