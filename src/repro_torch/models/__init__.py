"""The LM architecture pool, all ten architectures of the registry (the
torch port of ``repro.models``): ``build_model(cfg)`` → :class:`~repro_torch.models.model_zoo.ModelAPI`."""

from .model_zoo import ModelAPI, build_model  # noqa: F401
