"""Quickstart on the GPU: solve a 3D Poisson problem with the PyTorch/CUDA
port of TensorMesh, line for line the twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py              # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import torch

from repro_torch.core import unit_cube_tet
from repro_torch.fem import PoissonProblem

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

# -Δu = 1 on the unit cube, u = 0 on the boundary
problem = PoissonProblem(unit_cube_tet(8), device=device)
result = problem.solve(f=1.0, tol=1e-10)

print(f"DoFs:               {problem.space.num_dofs}")
print(f"CG iterations:      {result.iters}")
print(f"relative residual:  {result.residual:.2e}   (paper tolerance: 1e-10)")
print(f"max u:              {float(result.u.max()):.6f}  (≈0.056 as h→0)")

# spatially varying coefficient + batched right-hand sides (many-query mode)
result2 = problem.solve(rho=lambda x: 1.0 + x[..., 0], f=1.0)
print(f"variable-ρ solve:   residual {result2.residual:.2e}")

import numpy as np

f_batch = torch.as_tensor(np.random.default_rng(0).normal(size=(8, problem.space.num_dofs)))
us, iters = problem.solve_batch(f_batch)
print(f"batched solve:      {us.shape[0]} RHS in one batched assembly, iters={list(map(int, iters))}")

# composable weak forms: steady advection–diffusion is one fused assembly —
# diffusion(eps) + advection(beta) — no per-PDE assembler code needed
from repro_torch.core import unit_square_tri
from repro_torch.fem import AdvectionDiffusionProblem

ad = AdvectionDiffusionProblem(unit_square_tri(24), device=device)
res3 = ad.solve(eps=0.05, beta=(1.0, 0.5), f=1.0)
print(f"advection-diffusion: residual {res3.residual:.2e}  max u {float(res3.u.max()):.4f}")
