from .tensormesh import AdvectionDiffusionProblem, PoissonProblem  # noqa: F401
