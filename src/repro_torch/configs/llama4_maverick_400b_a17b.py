"""Config module for --arch llama4-maverick-400b-a17b (exact assigned dimensions)."""

from .registry import LLAMA4_MAVERICK as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
