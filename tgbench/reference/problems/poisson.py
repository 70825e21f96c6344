"""The reference of the Poisson class: −∇·(ρ∇u) = f on P1 tetrahedra,
u = 0 on the whole boundary.  A solve's input is the element coefficient
ρ (``argument: rho``); the source f is the configuration's constant
``load``."""

from tgbench.reference import fem
from tgbench.work.sizes import p1_sizes

VALUE_SIZE = 1


def sizes(points, cells):
    return p1_sizes(cells, points.shape[0], VALUE_SIZE)


class Reference:
    def __init__(self, geo: fem.Geometry, problem: dict, call: dict):
        if call.get("argument", "rho") != "rho":
            raise ValueError(f"the poisson class takes rho, not {call['argument']!r}")
        self.geo = geo
        self.load = fem.load_vector(geo, problem["load"], VALUE_SIZE)

    def system(self, x):
        """The element matrices and the load of a solve on input ``x``."""
        return fem.diffusion_local(self.geo, x), self.load
