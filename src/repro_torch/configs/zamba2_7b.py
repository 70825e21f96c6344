"""Config module for --arch zamba2-7b (exact assigned dimensions)."""

from .registry import ZAMBA2_7B as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
