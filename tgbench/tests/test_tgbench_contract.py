"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found where the harness looks for it."""

import json
import re

import pytest

from tgbench.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["tgbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(text_ok(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert text_ok(c["source"]) and text_ok(c["why"]) and c["file"].startswith("tgbench/")
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"]
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"]) and text_ok(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "tgbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "tgbench" / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("kind,key", [("end_to_end", "e2e"), ("per_layer", "metrics")])
def test_metrics(kind, key):
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[kind]:
        allowed = KEYS["e2e" if kind == "end_to_end" else "layer"] | {"workloads"}
        assert KEYS["e2e" if kind == "end_to_end" else "layer"] <= set(m) <= allowed
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "tgbench" / key / f"{m['name']}.py").is_file()
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            e2e = {e["name"]: e for e in BENCH["end_to_end"]}
            assert m["moves"] in e2e and text_ok(m["layer"])
            assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def _names(obj, key):
    """Every value of ``key`` anywhere in ``obj``."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == key and isinstance(v, str):
                yield v
            yield from _names(v, key)
    elif isinstance(obj, list):
        for v in obj:
            yield from _names(v, key)


def test_every_name_a_cell_gives_is_a_file_of_its_own():
    """A configuration's and a mix's names of problem class, mesh generator,
    Krylov method, Map kinds, operation, loop and input kind each resolve
    to a file the harness finds by name, on both sides of the comparison
    where there are two."""
    from tgbench.plugins import HOME, data

    confs = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        config, traffic = confs[w["config"]], data("traffic", w["traffic"])
        wanted = [("problems", config["problem"]["class"]),
                  ("reference/problems", config["problem"]["class"]),
                  ("reference/meshes", config["mesh"]["generator"]),
                  ("reference/krylov", config["solver"]["method"]),
                  ("work/krylov", config["solver"]["method"]),
                  ("operations", traffic["operation"]),
                  ("reference/operations", traffic["operation"]),
                  ("loops", traffic["loop"]),
                  ("inputs", traffic["input"]["kind"])]
        wanted += [("work/map", kind) for kind in config["work"]["map"]]
        for kind, name in wanted:
            assert (HOME / kind / f"{name}.py").is_file(), (w["name"], kind, name)
        assert list(_names(traffic, "kind")) == [traffic["input"]["kind"]]
