"""Config module for --arch whisper-tiny (exact assigned dimensions)."""

from .registry import WHISPER_TINY as CONFIG  # noqa: F401
from .base import smoke_variant

SMOKE = smoke_variant(CONFIG)
