"""Config module for --arch deepseek-67b (exact assigned dimensions)."""

from .registry import DEEPSEEK_67B as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
