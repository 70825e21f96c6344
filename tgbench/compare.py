"""The comparison that decides ``correct``.

Each answer the program gave in the window (a solve's u, or every state of
a rollout) is put into the reference's own system: the reference builds
the element matrices, the load and the boundary set again from the
benchmark's mesh arrays and the operation's input, and computes the
residual of the program's answer in the Dirichlet-condensed system.  The
number compared is that residual's norm over the configuration's stopping
target, ``max(tol·‖b‖, atol)``: a sound solve stopped at the target reads
at most about 1.

The problem class's part (its element matrices and load) is
``reference/problems/<class>.py``; the operation's part (which systems its
answers solve) is ``reference/operations/<operation>.py``.
"""

from __future__ import annotations

import torch

from .plugins import load
from .reference import fem

__all__ = ["Checker", "NUMBER"]

NUMBER = "residual_over_target"


class Checker:
    """The reference's systems of one cell, in ``dtype`` (float64 for the
    comparison; the control builds them in float32)."""

    def __init__(self, config: dict, traffic: dict, points, cells, device,
                 dtype=torch.float64):
        solver = config["solver"]
        self.tol, self.atol = solver["tol"], solver["atol"]
        self.geo = fem.Geometry(points, cells, device, dtype)
        cls = load("reference/problems", config["problem"]["class"])
        self.value_size = cls.VALUE_SIZE
        self.problem = cls.Reference(self.geo, config["problem"], traffic.get("call", {}))
        self.dofs = fem.cell_dofs(self.geo, self.value_size)
        self.n = self.geo.num_vertices * self.value_size
        bc = fem.boundary_vertices(self.geo)
        if self.value_size > 1:
            comp = torch.arange(self.value_size, device=bc.device)
            bc = (bc[:, None] * self.value_size + comp).reshape(-1)
        self.free = torch.ones(self.n, dtype=dtype, device=device)
        self.free[bc] = 0.0
        self.operation = load("reference/operations", traffic["operation"]).Check(self, traffic)

    def operator(self, local: torch.Tensor) -> fem.ElementOperator:
        return fem.ElementOperator(local, self.dofs, self.n)

    def system(self, x: torch.Tensor) -> tuple[fem.ElementOperator, torch.Tensor]:
        """A solve's operator and its condensed load for input ``x``."""
        local, load_vector = self.problem.system(x)
        return self.operator(local), self.free * load_vector

    def over_target(self, op: fem.ElementOperator, b: torch.Tensor, u: torch.Tensor) -> float:
        r = fem.condensed_residual(op, self.free, u, b)
        target = max(self.tol * float(torch.linalg.vector_norm(b)), self.atol)
        return float(torch.linalg.vector_norm(r)) / target

    def readings(self, x: torch.Tensor, out: torch.Tensor) -> list:
        """``residual_over_target`` of one operation's answers on input
        ``x`` (NaN for an answer that is not finite)."""
        return self.operation.readings(x, out.to(self.free.device))
