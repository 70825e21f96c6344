"""Config module for --arch nemotron-4-340b (exact assigned dimensions)."""

from .registry import NEMOTRON_340B as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
