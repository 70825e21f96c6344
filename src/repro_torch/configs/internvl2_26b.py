"""Config module for --arch internvl2-26b (exact assigned dimensions)."""

from .registry import INTERNVL2_26B as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
