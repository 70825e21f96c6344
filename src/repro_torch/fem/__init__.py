from .tensormesh import (  # noqa: F401
    AdvectionDiffusionProblem,
    ElasticityProblem,
    MixedBCPoisson,
    PoissonProblem,
)
