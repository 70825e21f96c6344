"""A log-normal element coefficient: ρ = exp(a) at the cell centroids, a
the smooth random field of ``tgbench.fields`` (``k_max``, ``log_std``)."""

from tgbench.fields import FourierField


class Input:
    def __init__(self, spec: dict, points, cells, device):
        centroids = points[cells].mean(axis=1)
        self.field = FourierField(centroids, spec["k_max"], spec["log_std"], device)

    def draw(self, g):
        return self.field.draw(g).exp_()
