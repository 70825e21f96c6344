"""The port's profiler ranges on the solve path, counted in a ``capture``d
trace on the CPU: the Krylov loop's children (``tg.solve.matvec``,
``tg.solve.precond``, ``tg.sync``), the Map's context build
(``tg.map.context``), Dirichlet condensation (``tg.condense``), the ELL
value fill (``tg.ell.values``), the post-solve residual
(``tg.solve.residual``) and the θ step (``tg.theta.step``,
``tg.theta.rhs``).  With telemetry off no range is entered, with it on
and no profiler recording none of these children is, and with it on the
ranges add no key to the metrics registry."""

import json
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro_torch.core as tc  # noqa: E402
from repro_torch import telemetry as tt  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.fem import ElasticityProblem, PoissonProblem  # noqa: E402
from repro_torch.telemetry import trace  # noqa: E402
from repro_torch.transient import ThetaIntegrator  # noqa: E402

# what a solve with telemetry on records in the registry, ranges or not
# (the plan's id masked)
SOLVE_KEYS = {
    "counters": {
        "assemblies{form=diffusion}",
        "assemblies{form=source}",
        "cache_lookups{kind=assembly_signature,outcome=miss}",
        "events{kind=assembly}",
        "events{kind=solve}",
        "jit_traces{form=diffusion,kind=assembly,plan=*}",
        "jit_traces{form=source,kind=assembly,plan=*}",
        "matvec_backend{backend=ell,role=matvec}",
        "matvec_backend{backend=ell,role=residual}",
        "solves{backend=ell,phase=forward,precond=jacobi,solver=cg}",
    },
    "gauges": {"csr_bytes"},
    "histograms": {
        "assembly_wall_us{form=diffusion}",
        "assembly_wall_us{form=source}",
        "solve_iterations{backend=ell,phase=forward,precond=jacobi,solver=cg}",
        "solve_wall_us{backend=ell,phase=forward,precond=jacobi,solver=cg}",
    },
}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    tt.disable()
    tt.reset()
    tt.clear_events()
    yield
    tt.disable()
    tt.reset()
    tt.clear_events()


def _mesh():
    return tc.unit_cube_tet(3)


def _rho(mesh):
    return torch.as_tensor(np.random.default_rng(0).uniform(0.5, 2.0, mesh.num_cells))


def _solve(problem: str):
    """One problem solve on the ``ell`` backend; its ``SolveInfo``."""
    mesh = _mesh()
    if problem == "poisson":
        _, info = PoissonProblem(mesh, device="cpu").solve(
            rho=_rho(mesh), backend="ell", spec=tc.SolverSpec(method="cg"), return_info=True)
    else:
        _, info = ElasticityProblem(mesh, device="cpu").solve(
            body_force=(0.0, 0.0, -1.0), backend="ell", return_info=True)
    return info


def _ranges(tmp_path, fn):
    """``fn()``'s result and its ``tg.*`` ranges, ``{name: [(start, end)]}``,
    from a trace captured with telemetry on."""
    d = str(tmp_path / "trace")
    with tt.enabled():
        with tt.capture(d):
            out = fn()
    (file,) = os.listdir(d)
    ranges = {}
    for e in json.load(open(os.path.join(d, file)))["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("tg."):
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return out, ranges


def _inside(spans, outer):
    return sum(any(lo <= s and e <= hi for lo, hi in outer) for s, e in spans)


@pytest.mark.parametrize("problem,method,contexts", [("poisson", "cg", 1),
                                                     ("elasticity", "bicgstab", 2)])
def test_a_solve_opens_its_ranges(tmp_path, problem, method, contexts):
    """A solve reads the stopping target, iterations + 1 stopping tests, the
    final residual and its relative residual on the host; CG applies the
    operator and the preconditioner once an iteration and once more for
    the initial residual, BiCGSTAB the operator twice an iteration (and for
    the initial residual) and the preconditioner twice; the ELL values are
    filled once for the loop's matvec and once for the residual; the
    einsum Map builds its element context once a call (the load's in
    Poisson, whose matrix goes through the P1 kernel; the matrix's and the
    load's in elasticity)."""
    info, r = _ranges(tmp_path, lambda: _solve(problem))
    n = info.iters
    assert n > 0 and info.converged
    counts = {name: len(v) for name, v in r.items()}
    loop = r[f"tg.solve.{method}"]
    assert counts[f"tg.solve.{method}"] == 1
    assert counts["tg.sync"] == n + 4
    assert counts["tg.solve.matvec"] == (n + 1 if method == "cg" else 2 * n + 1)
    assert counts["tg.solve.precond"] == (n + 1 if method == "cg" else 2 * n)
    assert counts["tg.ell.values"] == 2
    assert counts["tg.condense"] == 1
    assert counts["tg.map.context"] == contexts
    assert counts["tg.solve.residual"] == 1
    assert "tg.facet_inject" not in counts          # no facet terms
    # the children nest where the readers look for them
    assert _inside(r["tg.solve.matvec"], loop) == counts["tg.solve.matvec"]
    assert _inside(r["tg.solve.precond"], loop) == counts["tg.solve.precond"]
    assert _inside(r["tg.sync"], loop) == n + 1
    assert _inside(r["tg.sync"], r["tg.solve.residual"]) == 1
    assert _inside(r["tg.ell.values"], r["tg.solve.residual"]) == 1
    assert _inside(r["tg.map.context"], r["tg.map"]) == contexts


def test_a_theta_step_opens_its_ranges(tmp_path):
    """A θ step on the ``ell`` backend: one ``tg.theta.step`` with one
    ``tg.theta.rhs`` inside it; the warm-started CG reads the target,
    iterations + 1 stopping tests and the final residual (no relative
    residual); the ELL values were filled when the integrator was built."""
    mesh = _mesh()
    prob = PoissonProblem(mesh, device="cpu")
    integ = ThetaIntegrator.from_form(prob.asm, twf.diffusion(1.0), 1e-3, theta=0.5,
                                      bc=prob.bc, backend="ell")
    u0 = prob.bc.project_residual(torch.as_tensor(
        np.random.default_rng(1).standard_normal(prob.space.num_dofs)))
    (_, info), r = _ranges(tmp_path, lambda: integ.rollout(u0, 2, return_info=True))
    iters = info.iters.tolist()
    assert len(iters) == 2 and min(iters) > 0
    counts = {name: len(v) for name, v in r.items()}
    assert counts["tg.theta.step"] == 2 and counts["tg.theta.rhs"] == 2
    assert _inside(r["tg.theta.rhs"], r["tg.theta.step"]) == 2
    assert counts["tg.solve.cg"] == 2
    assert counts["tg.sync"] == sum(n + 3 for n in iters)
    assert _inside(r["tg.sync"], r["tg.theta.step"]) == counts["tg.sync"]
    assert counts["tg.solve.matvec"] == sum(n + 1 for n in iters)
    assert counts["tg.solve.precond"] == sum(n + 1 for n in iters)
    assert "tg.ell.values" not in counts and "tg.solve.residual" not in counts


CHILDREN = {"tg.sync", "tg.solve.matvec", "tg.solve.precond", "tg.condense", "tg.ell.values",
            "tg.map.context", "tg.solve.residual", "tg.theta.step", "tg.theta.rhs"}


def _entered(monkeypatch):
    """A function that runs a Poisson and an elasticity solve and a θ step
    and returns the names of the ranges they opened; the caller sets
    telemetry and the profiler."""
    entered = []
    real = trace._range_enter

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(trace, "_range_enter", counting)
    mesh = _mesh()
    prob = PoissonProblem(mesh, device="cpu")
    integ = ThetaIntegrator.from_form(prob.asm, twf.diffusion(1.0), 1e-3, theta=0.5,
                                      bc=prob.bc, backend="ell")

    def calls():
        entered.clear()
        _solve("poisson")
        _solve("elasticity")
        integ.rollout(torch.zeros(prob.space.num_dofs, dtype=torch.float64) + 1.0, 1)
        return set(entered)

    return calls


def test_no_record_function_is_entered_with_telemetry_off(monkeypatch):
    """With telemetry off the solve path opens no profiler range, under a
    profiler or not; with it on and a profiler recording it opens every
    range counted above."""
    calls = _entered(monkeypatch)
    assert calls() == set()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert calls() == set()
        with tt.enabled():
            assert CHILDREN <= calls()


def test_the_child_ranges_wait_for_a_profiler(monkeypatch):
    """With telemetry on and no profiler recording (the serve tier's mode)
    the loop runs on the bare callables and no child range opens: only
    the parents (the loop, the Map) do."""
    calls = _entered(monkeypatch)
    with tt.enabled():
        names = calls()
    assert not names & CHILDREN
    assert {"tg.solve.cg", "tg.solve.bicgstab", "tg.map"} <= names


def test_the_ranges_add_no_registry_key():
    """A solve with telemetry on and a profiler recording records the
    registry keys it recorded before the ranges existed, and no other."""
    tt.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _solve("poisson")
    snap = tt.snapshot()

    def masked(keys):
        return {re.sub(r"plan=[0-9a-f]+", "plan=*", k) for k in keys}

    assert {kind: masked(keys) for kind, keys in snap.items()} == SOLVE_KEYS
