"""As ``krylov_syncs_per_iter.solve``, for the matrix-free cells, whose solves move
``solve_ms.matfree``."""

from tgbench.readout import reader

read = reader("metrics", "krylov_syncs_per_iter.solve")
