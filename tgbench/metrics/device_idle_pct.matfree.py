"""As ``device_idle_pct.solve``, for the matrix-free cells, whose solves move
``solve_ms.matfree``."""

from tgbench.readout import reader

read = reader("metrics", "device_idle_pct.solve")
