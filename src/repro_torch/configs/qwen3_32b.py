"""Config module for --arch qwen3-32b (exact assigned dimensions)."""

from .registry import QWEN3_32B as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
