from .base import SHAPES, ArchConfig, ShapeSpec, smoke_variant  # noqa: F401
from .registry import ARCHS, get_config  # noqa: F401
