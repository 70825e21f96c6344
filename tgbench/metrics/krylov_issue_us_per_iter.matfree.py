"""As ``krylov_issue_us_per_iter.solve``, for the matrix-free cells, whose solves move
``solve_ms.matfree``."""

from tgbench.readout import reader

read = reader("metrics", "krylov_issue_us_per_iter.solve")
