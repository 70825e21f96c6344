"""[0,1]³ minus the open box (0.25, 0.75)³, in cubes of side 1/n, six
tetrahedra a cube."""

from tgbench.reference.structured import box

CELL = "tet"


def generate(n: int):
    """``(points, cells)`` as numpy arrays."""
    lo, hi = int(round(0.25 * n)), int(round(0.75 * n))

    def keep(i, j, k):
        inside = [(lo <= a) & (a < hi) for a in (i, j, k)]
        return ~(inside[0] & inside[1] & inside[2])

    return box(n, keep)
