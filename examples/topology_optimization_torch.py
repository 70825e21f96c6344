"""TensorOpt on the GPU: cantilever compliance minimization (paper §B.4,
Table 3) with the PyTorch/CUDA port, the twin of
``examples/topology_optimization.py``.

Sensitivities come from autograd through the differentiable assembly and
the adjoint sparse solve; MMA drives the densities.

    PYTHONPATH=src python examples/topology_optimization_torch.py              # on the card
    PYTHONPATH=src python examples/topology_optimization_torch.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.opt import CantileverProblem, MMAState, mma_update

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

t0 = time.perf_counter()
prob = CantileverProblem(nx=40, ny=20, lx=40.0, ly=20.0, device=device)
rho = torch.full((prob.n_elem,), 0.5, dtype=torch.float64, device=prob.device)
c0, _ = prob.compliance_and_sensitivity(rho)
print(f"setup+first solve: {time.perf_counter() - t0:.2f}s, elements={prob.n_elem}")
print(f"initial compliance: {float(c0):.2f}")

state = MMAState(low=rho - 0.5, upp=rho + 0.5)
dg = torch.full((prob.n_elem,), 1.0 / prob.n_elem, dtype=torch.float64, device=prob.device)
t0 = time.perf_counter()
for it in range(25):
    c, g = prob.compliance_and_sensitivity(rho)
    g_f = prob.filter(g * rho) / torch.clamp(rho, min=1e-3)
    vol_violation = float(rho.mean()) - prob.volfrac
    rho, state = mma_update(rho, g_f, vol_violation, dg, state)
    if it % 5 == 0:
        print(f"  iter {it:3d}  compliance {float(c):9.2f}  vol {float(rho.mean()):.3f}")
c_end, _ = prob.compliance_and_sensitivity(rho)
print(f"optimization loop: {time.perf_counter() - t0:.2f}s")
print(f"final compliance: {float(c_end):.2f}  ({float(c_end)/float(c0):.0%} of initial)")

# ASCII rendering of the design (ρ > 0.5 = material)
grid = rho.cpu().numpy().reshape(40, 20).T[::-1]
print("\nfinal topology (viewed y-up):")
for row in grid[::2]:
    print("".join("#" if v > 0.5 else "." for v in row))
