"""As ``krylov_syncs_per_iter.solve``, for the rollout cells, whose time steps move
``step_ms`` (each solve of the loop is a time step)."""

from tgbench.readout import reader

read = reader("metrics", "krylov_syncs_per_iter.solve")
