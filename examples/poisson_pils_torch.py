"""TensorPILS as a neural PDE solver on the GPU (paper Table 1, reduced
budget), the PyTorch/CUDA twin of ``examples/poisson_pils.py``.

Trains the same SIREN backbone with the strong-form PINN loss and the
TensorPILS discrete Galerkin residual on the K=4 checkerboard Poisson
problem, then compares accuracy vs the FEM reference.  The SIREN weights
are drawn from a ``torch.Generator`` (JAX's PRNG draws are not
reproducible in torch, so the numbers differ from the JAX example's).

    PYTHONPATH=src python examples/poisson_pils_torch.py              # on the card
    PYTHONPATH=src python examples/poisson_pils_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    DirichletCondenser, FunctionSpace, GalerkinAssembler, cg, element_for_mesh,
    jacobi_preconditioner, unit_square_tri,
)
from repro_torch.pils import (
    GalerkinResidualLoss, lbfgs_minimize, pinn_poisson_loss, siren_apply,
    siren_init, train_adam,
)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

K = 4
ADAM_STEPS, LBFGS_STEPS = 400, 40

mesh = unit_square_tri(16)
space = FunctionSpace(mesh, element_for_mesh(mesh))
asm = GalerkinAssembler(space, device=device)
bc = DirichletCondenser(asm, space.boundary_dofs())
f = lambda x: torch.sign(  # noqa: E731
    torch.sin(K * np.pi * x[..., 0] + 1e-9) * torch.sin(K * np.pi * x[..., 1] + 1e-9)
)

gl = GalerkinResidualLoss(asm, bc, f=f)
u_fem, _ = cg(gl.k.matvec, gl.f, m=jacobi_preconditioner(gl.k), tol=1e-12)
norm = float(torch.linalg.vector_norm(u_fem))

pts = gl.dof_points
free = bc.free_mask.to(torch.bool)


def rel_err(params):
    with torch.no_grad():
        u = siren_apply(params, pts)[:, 0] * free
    return float(torch.linalg.vector_norm(u - u_fem)) / norm


for name, loss in (
    ("TensorPILS", lambda p: gl.loss_from_net(siren_apply, p)),
    ("PINN", lambda p: pinn_poisson_loss(
        siren_apply, p, pts[free], f(pts[free][None])[0], pts[~free]
    )),
):
    params = siren_init(torch.Generator().manual_seed(0), 2, 64, 1, depth=4, device=device)
    params, hist, its_adam = train_adam(loss, params, ADAM_STEPS, lr=1e-3, log_every=100)
    params, losses, its_lbfgs = lbfgs_minimize(loss, params, steps=LBFGS_STEPS)
    print(
        f"{name:12s} rel-L2 vs FEM: {rel_err(params):.4f}   "
        f"adam {its_adam:6.1f} it/s   lbfgs {its_lbfgs:6.1f} it/s"
    )
