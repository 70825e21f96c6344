"""The reference of the elasticity class: isotropic linear elasticity
(Young's modulus ``E``, Poisson's ratio ``nu``) on P1 vector tetrahedra,
clamped on the whole boundary.  A solve's input is a constant body force
(``argument: body_force``)."""

from tgbench.reference import fem
from tgbench.work.sizes import p1_sizes

VALUE_SIZE = 3


def sizes(points, cells):
    return p1_sizes(cells, points.shape[0], VALUE_SIZE)


class Reference:
    def __init__(self, geo: fem.Geometry, problem: dict, call: dict):
        if call.get("argument", "body_force") != "body_force":
            raise ValueError(f"the elasticity class takes body_force, not {call['argument']!r}")
        self.geo = geo
        e, nu = problem["E"], problem["nu"]
        lam, mu = e * nu / ((1 + nu) * (1 - 2 * nu)), e / (2 * (1 + nu))
        self.local = fem.elasticity_local(geo, lam, mu)

    def system(self, x):
        """The element matrices and the load of a solve on input ``x``."""
        return self.local, fem.load_vector(self.geo, x, VALUE_SIZE)
