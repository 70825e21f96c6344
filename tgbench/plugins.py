"""Files found by name.

Everything that belongs to one configuration, traffic mix, problem class,
operation, loop, input kind, mesh generator, Krylov method, Map kind or
metric is a file of its own, ``tgbench/<kind>/<name>.py``, that the harness
loads by the name a configuration, a mix or ``BENCHMARK.json`` gives.  A
later cell of a new kind is then new files, and no edit of an existing one.
Names may hold dots (``krylov_roofline.solve``), so a file is loaded from
its path, not imported as a package member; it imports what it needs by
absolute names (``tgbench.reference.fem``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

__all__ = ["HOME", "data", "load"]

HOME = Path(__file__).resolve().parent
_LOADED = {}


def load(kind: str, name: str):
    """The module ``tgbench/<kind>/<name>.py`` (``kind`` may be nested, as
    ``reference/problems``), loaded once."""
    path = HOME / kind / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            known = sorted(p.stem for p in (HOME / kind).glob("*.py") if p.stem != "__init__")
            raise LookupError(f"no {kind} named {name!r} (no {path}); known: {known}")
        module_name = "tgbench_" + f"{kind}/{name}".replace("/", "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def data(kind: str, name: str) -> dict:
    """The parameters ``tgbench/<kind>/<name>.json``."""
    return json.loads((HOME / kind / f"{name}.json").read_text())
