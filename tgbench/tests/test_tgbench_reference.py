"""The plain reference against the port, at small sizes on the CPU: the
frozen mesh generators, the element matrices assembled, the loads, the
boundary sets and the residual of the port's solves."""

import numpy as np
import pytest
import torch

from tgbench.plugins import load
from tgbench.program import import_port
from tgbench.reference import fem
from tgbench.run import ROOT

torch.set_num_threads(2)
import_port(ROOT)
from repro_torch.core import Mesh, hollow_cube_tet, unit_cube_tet, weakform as wf  # noqa: E402
from repro_torch.fem import ElasticityProblem, PoissonProblem  # noqa: E402

CASES = [("unit_cube_tet", 4), ("unit_cube_tet", 8), ("hollow_cube_tet", 8)]
PORT_GENERATORS = {"unit_cube_tet": unit_cube_tet, "hollow_cube_tet": hollow_cube_tet}


def dense(op: fem.ElementOperator) -> np.ndarray:
    return torch.stack([op.apply(e) for e in torch.eye(op.n, dtype=torch.float64)], 1).numpy()


def port_dense(csr) -> np.ndarray:
    n = csr.shape[0]
    return torch.stack([csr.matvec(e) for e in torch.eye(n, dtype=torch.float64)], 1).numpy()


@pytest.mark.parametrize("gen,n", CASES)
def test_generators_match_the_port(gen, n):
    points, cells = load("reference/meshes", gen).generate(n)
    port = PORT_GENERATORS[gen](n)
    np.testing.assert_array_equal(points, port.points)
    np.testing.assert_array_equal(cells, port.cells)


@pytest.mark.parametrize("gen,n", CASES)
def test_boundary_matches_the_port(gen, n):
    points, cells = load("reference/meshes", gen).generate(n)
    geo = fem.Geometry(points, cells, "cpu")
    prob = PoissonProblem(Mesh(points, cells, "tet"), device="cpu")
    np.testing.assert_array_equal(fem.boundary_vertices(geo).numpy(),
                                  np.sort(prob.space.boundary_dofs()))


@pytest.mark.parametrize("gen,n", CASES[:2])
def test_poisson_operators_match_the_port(gen, n):
    points, cells = load("reference/meshes", gen).generate(n)
    geo = fem.Geometry(points, cells, "cpu")
    prob = PoissonProblem(Mesh(points, cells, "tet"), device="cpu")
    rho = torch.exp(torch.linspace(-1.0, 1.0, geo.num_cells, dtype=torch.float64))
    k = dense(fem.ElementOperator(fem.diffusion_local(geo, rho), geo.cells, geo.num_vertices))
    np.testing.assert_allclose(k, port_dense(prob.asm.assemble(wf.diffusion(rho))),
                               rtol=0, atol=1e-14 * np.abs(k).max())
    m = dense(fem.ElementOperator(fem.mass_local(geo), geo.cells, geo.num_vertices))
    np.testing.assert_allclose(m, port_dense(prob.asm.assemble(wf.mass(1.0))),
                               rtol=0, atol=1e-14 * np.abs(m).max())
    f = fem.load_vector(geo, 1.0, 1).numpy()
    np.testing.assert_allclose(f, prob.asm.assemble_rhs(wf.source(1.0)).numpy(),
                               rtol=0, atol=1e-14 * np.abs(f).max())


def test_elasticity_operators_match_the_port():
    points, cells = load("reference/meshes", "hollow_cube_tet").generate(4)
    geo = fem.Geometry(points, cells, "cpu")
    prob = ElasticityProblem(Mesh(points, cells, "tet"), e_mod=1.0, nu=0.3, device="cpu")
    local = fem.elasticity_local(geo, prob.lam, prob.mu)
    k = dense(fem.ElementOperator(local, fem.cell_dofs(geo, 3), 3 * geo.num_vertices))
    np.testing.assert_allclose(k, port_dense(prob.asm.assemble(wf.elasticity(prob.lam, prob.mu))),
                               rtol=0, atol=1e-14 * np.abs(k).max())
    bf = torch.tensor([0.3, -0.5, 0.8], dtype=torch.float64)
    f = fem.load_vector(geo, bf, 3).numpy()
    np.testing.assert_allclose(f, prob.asm.assemble_rhs(wf.source(bf)).numpy(),
                               rtol=0, atol=1e-14 * np.abs(f).max())
