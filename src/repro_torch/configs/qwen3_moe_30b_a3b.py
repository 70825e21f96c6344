"""Config module for --arch qwen3-moe-30b-a3b (exact assigned dimensions)."""

from .registry import QWEN3_MOE_30B as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
