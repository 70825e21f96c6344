"""What the harness loads and opens: no ``jax``, ``jaxlib``, ``flax`` or
``repro`` (top-level names compared whole: ``repro_torch`` is allowed), a
reference that imports nothing of the port, and nothing opened under the
JAX package's ``benchmarks/``."""

import ast
import json
import subprocess
import sys

from tgbench.run import FORBIDDEN, ROOT

TGBENCH = ROOT / "tgbench"

PROBE = r"""
import json, sys, time
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
import torch
torch.set_num_threads(1)
from pathlib import Path
from tgbench import control, run as runmod
from tgbench.plugins import HOME, data, load
bench = json.loads((runmod.ROOT / "BENCHMARK.json").read_text())
for w in bench["workloads"]:
    data("traffic", w["traffic"])
for path in sorted(HOME.rglob("*.py")):
    kind = path.parent.relative_to(HOME).as_posix()
    if kind not in (".", "tests") and path.stem != "__init__":
        load(kind, path.stem)
cell = runmod.load_cell(runmod.ROOT, "poisson96.assembled")
res, _ = runmod.run_cell(runmod.ROOT, cell, 5, 0.1, False, device="cpu",
                         t0=time.perf_counter(), mesh_n=4)
print(json.dumps({"forbidden": runmod.loaded_forbidden(), "correct": res["correct"],
                  "benchmarks": [p for p in opened if "/benchmarks/" in p or
                                 p.endswith("/benchmarks")],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE_ONLY = r"""
import json, sys
from tgbench.plugins import HOME, load
for path in sorted((HOME / "reference").rglob("*.py")):
    load(path.parent.relative_to(HOME).as_posix(), path.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_nothing_forbidden_and_opens_nothing_of_benchmarks():
    got = json.loads(_python(PROBE))
    assert got["correct"]
    assert got["forbidden"] == []
    assert not set(got["top"]) & FORBIDDEN
    assert "repro_torch" in got["top"]
    assert got["benchmarks"] == []


def test_the_reference_loads_nothing_of_the_port():
    top = set(json.loads(_python(REFERENCE_ONLY)))
    assert "repro_torch" not in top and not top & FORBIDDEN


def test_no_source_imports_a_forbidden_or_the_port_from_the_reference():
    for path in TGBENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.add(node.module.split(".")[0])
        assert not names & FORBIDDEN, path
        if "reference" in path.parts:
            assert "repro_torch" not in names, path
        assert "benchmarks" not in names, path


def test_without_the_port_a_run_finds_nothing_to_run(tmp_path):
    import pytest

    from tgbench.program import import_port

    with pytest.raises(ImportError):
        import_port(tmp_path)
