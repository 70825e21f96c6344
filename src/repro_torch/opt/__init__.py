"""TensorOpt on PyTorch: SIMP compliance minimization with autograd
sensitivities (``simp``) and the Method of Moving Asymptotes (``mma``)."""

from .simp import CantileverProblem, oc_update, sensitivity_filter  # noqa: F401
from .mma import mma_update, MMAState  # noqa: F401
