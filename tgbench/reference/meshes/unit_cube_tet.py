"""The unit cube in n³ cubes, 6·n³ tetrahedra."""

from tgbench.reference.structured import box

CELL = "tet"


def generate(n: int):
    """``(points, cells)`` as numpy arrays."""
    return box(n)
