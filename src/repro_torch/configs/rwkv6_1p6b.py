"""Config module for --arch rwkv6-1.6b (exact assigned dimensions)."""

from .registry import RWKV6_1P6B as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
