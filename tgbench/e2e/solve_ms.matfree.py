"""As ``solve_ms``, for the matrix-free cells: their solves keep the
device busy, so their times spread far less than the host-paced assembled
cells' and take a bound of their own."""

from tgbench.readout import reader

read = reader("e2e", "solve_ms")
