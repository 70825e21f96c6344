"""Config module for --arch qwen3-4b (exact assigned dimensions)."""

from .registry import QWEN3_4B as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
