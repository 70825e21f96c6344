"""The system under test: the port's entry points, driven as a cell states.

``Program`` builds the configuration's problem on the port from the mesh
arrays the benchmark made (``problems/<class>.py``) and the operation the
traffic mix drives through it (``operations/<operation>.py``):
``Program.run(x)`` is one operation on input ``x``.  The port is imported
from ``src/`` of the checkout the benchmark runs in.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from .plugins import load

__all__ = ["Outcome", "Program", "import_port"]


@dataclasses.dataclass
class Outcome:
    out: torch.Tensor      # u (N,), or the trajectory (steps, N)
    iters: list            # Krylov iterations, one per solve (a rollout: per step)
    converged: list        # and whether each converged


def import_port(root: Path):
    """``repro_torch`` from ``root/src``, and no other copy of it."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise ImportError(f"the port is not in this checkout: no {src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch

    if Path(repro_torch.__file__).resolve().parent != (src / "repro_torch").resolve():
        raise ImportError(f"repro_torch was imported from {repro_torch.__file__}, not {src}")
    return repro_torch


class Program:
    """One configuration's problem on the port, and the operation a traffic
    mix drives through it."""

    def __init__(self, root: Path, config: dict, traffic: dict, points: np.ndarray,
                 cells: np.ndarray, device):
        import_port(root)
        from repro_torch.core import Mesh, SolverSpec

        mesh = Mesh(points, cells, load("reference/meshes", config["mesh"]["generator"]).CELL)
        s = config["solver"]
        spec = SolverSpec(method=s["method"], tol=s["tol"], atol=s["atol"],
                          maxiter=s["maxiter"], precond=s["precond"])
        cls = load("problems", config["problem"]["class"])
        self.port = cls.build(mesh, config["problem"], device)
        self.operation = load("operations", traffic["operation"]).Operation(
            cls, self.port, config, traffic, spec)

    def run(self, x: torch.Tensor) -> Outcome:
        """One operation on input ``x``."""
        return self.operation.run(x)

    def warm(self, x: torch.Tensor) -> None:
        """The operation's warm-up on input ``x``: every shape and kernel the
        window uses, built or loaded."""
        self.operation.warm(x)
