"""Physics-informed learning on PyTorch (TensorPILS and its baselines):
the SIREN and AGN backbones, the PINN / Deep Ritz / VPINN / Galerkin
residual losses, Adam and L-BFGS, and the time-dependent operator-learning
problems.  The torch port of ``repro.pils``."""

from .siren import siren_apply, siren_init  # noqa: F401
from .losses import (  # noqa: F401
    BatchedGalerkinResidualLoss,
    GalerkinResidualLoss,
    deep_ritz_loss,
    pinn_poisson_loss,
    vpinn_loss,
)
from .training import (  # noqa: F401
    adam_init,
    adam_update,
    fit_family,
    lbfgs_minimize,
    train_adam,
)
