"""Physics-informed operator learning on the GPU (paper §B.3, reduced), the
PyTorch/CUDA twin of ``examples/operator_learning_wave.py``: an AGN learns
the wave-equation solution operator on a disk mesh from the *discrete
Galerkin residual alone* (data-free).  Initial conditions and weights come
from ``torch.Generator``s (JAX's PRNG draws are not reproducible in torch).

    PYTHONPATH=src python examples/operator_learning_wave_torch.py              # on the card
    PYTHONPATH=src python examples/operator_learning_wave_torch.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import disk_tri
from repro_torch.pils.gnn import agn_init, agn_rollout, element_graph_edges
from repro_torch.pils.operator import TimeDependentProblem, random_initial_condition
from repro_torch.pils.training import adam_init, adam_update
from repro_torch.transient import batched_rollout

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

W, N_BUNDLES, EPOCHS = 4, 8, 200
tp = TimeDependentProblem(disk_tri(6), dt=5e-4, c=4.0, device=device)
dev = tp.device
mesh = tp.mesh
edges_np = element_graph_edges(mesh.cells)
deg = np.zeros(mesh.num_vertices)
np.add.at(deg, edges_np[:, 1], 1)
deg = torch.as_tensor(np.maximum(deg, 1.0), device=dev)
edges = torch.as_tensor(edges_np, device=dev)
coords = torch.as_tensor(mesh.points, device=dev)
total = W * N_BUNDLES
print(f"mesh: {mesh.num_vertices} nodes / {mesh.num_cells} elements; rollout {total} steps")

gen = torch.Generator().manual_seed(0)
u0s = torch.stack(
    [random_initial_condition(gen, tp.space.dof_points, device=dev) * tp.bc.free_mask
     for _ in range(6)]
)
# one Newmark-β rollout per initial condition (repro_torch.transient)
refs = batched_rollout(tp.newmark_integrator(), u0s, W + total)
trajs = [torch.cat([u0s[i][None], refs[i]], 0) for i in range(len(u0s))]
train_trajs, test_trajs = trajs[:4], trajs[4:]


def rollout(params, traj):
    u_win = traj[:W].T   # window seeded with the known first w steps
    return agn_rollout(params, u_win, coords, edges, deg, N_BUNDLES, tp.interior)


def galerkin_loss(params):
    # data-free: only the PDE's discrete residual (Eq. B.17) is minimized
    tot = 0.0
    for traj in train_trajs:
        pred = rollout(params, traj)
        full = torch.cat([traj[W - 2 : W], pred.T], dim=0)
        tot = tot + tp.wave_trajectory_loss(full, normalized=True)
    return tot / len(train_trajs)


params = agn_init(torch.Generator().manual_seed(1), W, W, hidden=32, n_layers=3, device=dev)
state = adam_init(params)
vg = torch.func.grad_and_value(galerkin_loss)
t0 = time.perf_counter()
for i in range(EPOCHS):
    g, loss = vg(params)
    params, state = adam_update(params, g, state, 1e-3)
    if i % 50 == 0:
        print(f"  epoch {i:4d}  residual loss {float(loss):.3e}")
print(f"training: {time.perf_counter() - t0:.1f}s")

half = total // 2
for label, sl in (("ID ", slice(0, half)), ("OOD", slice(half, total))):
    errs = []
    for traj in test_trajs:
        with torch.no_grad():
            pred = rollout(params, traj).T.cpu().numpy()
        tgt = traj[W : W + total].cpu().numpy()
        rel = np.linalg.norm((pred - tgt)[sl]) / (np.linalg.norm(tgt[sl]) + 1e-12)
        errs.append(rel)
    print(f"{label} rel-L2 on held-out ICs: {np.mean(errs):.3f}")
