"""Torch port parity for the whole slice: the problem classes against the
JAX package's (DoFs, iterations, residual, max u), the default device, and
the guard that the port never imports JAX or the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
from repro.fem import AdvectionDiffusionProblem as JAdvDiff  # noqa: E402
from repro.fem import PoissonProblem as JPoisson  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.fem import AdvectionDiffusionProblem, PoissonProblem  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _same_result(rt, rj, dofs_t, dofs_j):
    assert dofs_t == dofs_j
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert rt.converged and rj.converged
    assert abs(rt.residual - rj.residual) <= 1e-9
    u_j = np.asarray(rj.u)
    np.testing.assert_allclose(rt.u.numpy(), u_j, atol=1e-9 * np.abs(u_j).max(), rtol=0)
    assert abs(float(rt.u.max()) - float(u_j.max())) <= 1e-9


@pytest.mark.parametrize("rho", ["constant", "variable"])
def test_poisson_matches_jax(rho):
    coef = None if rho == "constant" else (lambda x: 1.0 + x[..., 0])
    pj = JPoisson(jc.unit_cube_tet(6))
    pt = PoissonProblem(tc.unit_cube_tet(6), device="cpu")
    kernels.reset_launches()
    rt = pt.solve(rho=coef, f=1.0)
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # plain versions on the CPU
    _same_result(rt, pj.solve(rho=coef, f=1.0), pt.space.num_dofs, pj.space.num_dofs)
    assert rt.u.dtype == torch.float64 and rt.u.device.type == "cpu"


def test_advection_diffusion_matches_jax():
    pj = JAdvDiff(jc.unit_square_tri(12))
    pt = AdvectionDiffusionProblem(tc.unit_square_tri(12), device="cpu")
    kw = dict(eps=0.05, beta=(1.0, 0.5), f=1.0)
    _same_result(pt.solve(**kw), pj.solve(**kw), pt.space.num_dofs, pj.space.num_dofs)


def test_solve_info_and_legacy_tol():
    pt = PoissonProblem(tc.unit_square_tri(8), device="cpu")
    res, info = pt.solve(f=1.0, return_info=True)
    assert info.iters == res.iters and info.converged
    with pytest.warns(DeprecationWarning):
        res2 = pt.solve(f=1.0, tol=1e-10)
    assert res2.iters == res.iters


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoissonProblem(tc.unit_cube_tet(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.build_plan(tc.FunctionSpace(tc.unit_square_tri(2),
                                       tc.element_for_mesh(tc.unit_square_tri(2))))


def test_port_imports_neither_jax_nor_repro():
    """The port's modules, and a run of examples/quickstart_torch.py on the
    CPU, load neither JAX nor the JAX package."""
    code = (
        "import runpy, sys\n"
        "import repro_torch, repro_torch.core, repro_torch.fem, repro_torch.kernels\n"
        "import repro_torch.telemetry, repro_torch.convert\n"
        "sys.argv = ['quickstart_torch.py', '--device', 'cpu']\n"
        f"runpy.run_path({str(ROOT / 'examples' / 'quickstart_torch.py')!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('loaded:', ','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert "batched solve:" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


def test_no_jax_import_lines_in_the_port():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|repro)\b(?!_)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py"]
    assert len(files) > 20
    offenders = [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())]
    assert offenders == []
