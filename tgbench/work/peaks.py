"""The card's peaks that every roofline share is taken against.

NVIDIA's data sheet (dense rates, full power limit): device-memory
bandwidth in bytes/s and float64 operations/s outside the tensor cores,
by the name ``torch.cuda.get_device_name()`` gives.  A card not listed is
refused: its shares would be read against another card's peaks.
"""

from __future__ import annotations

__all__ = ["peaks"]

_TABLE = {  # name: (bytes/s, float64 flop/s)
    "NVIDIA H100 80GB HBM3": (3.35e12, 34e12),   # H100 SXM5
}


def peaks(device_name: str) -> tuple[float, float]:
    """``(bytes/s, float64 flop/s)`` of the card named ``device_name``."""
    if device_name not in _TABLE:
        raise LookupError(f"no peaks for the card {device_name!r}; known: {sorted(_TABLE)}")
    return _TABLE[device_name]
