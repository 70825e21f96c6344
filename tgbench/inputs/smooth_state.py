"""A smooth state that vanishes on the unit cube's faces: u0 = a(x) Π sin(π
x_i) at the vertices, a the smooth random field of ``tgbench.fields``
(``k_max``, standard deviation ``log_std``)."""

import math

from tgbench.fields import FourierField


def _envelope(at, values):
    values.mul_((math.pi * at).sin_().prod(dim=1))


class Input:
    def __init__(self, spec: dict, points, cells, device):
        self.field = FourierField(points, spec["k_max"], spec["log_std"], device)

    def draw(self, g):
        return self.field.draw(g, post=_envelope)
