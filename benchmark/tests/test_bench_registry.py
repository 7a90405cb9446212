"""Discovery by name, and BENCHMARK.json against the rules of its format."""

from __future__ import annotations

import ast
import os
import re

import pytest

from benchmark import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_parts_by_name(w):
    cfg = registry.config(BENCH, w["config"])
    traffic = registry.traffic(w["traffic"])
    limits = registry.limits(w["name"])
    driver = registry.driver(traffic["driver"])
    assert cfg["name"] == w["config"] and hasattr(driver, "Cell") and limits
    e2e, layer = registry.cell_metrics(BENCH, w["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    assert all(m["moves"] in names for m in layer)


def test_every_per_layer_metric_has_its_reader():
    for m in BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))
    files = {os.path.join(registry.HERE, "metrics", f)
             for f in os.listdir(os.path.join(registry.HERE, "metrics")) if f.endswith(".py")}
    assert files == {registry.reader_path(m["name"]) for m in BENCH["per_layer"]}


def test_the_file_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and 1 <= len(c["source"]) <= 200
        cfg = registry.config(BENCH, c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


def imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def python_files(folder: str):
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_program():
    for path in python_files(registry.HERE):
        assert not imports(path) & {"jax", "jaxlib", "flax", "urh_tpu"}, path
    for sub in ("reference", "gen"):
        for path in python_files(os.path.join(registry.HERE, sub)):
            assert not imports(path) & {"urh_tpu_torch", "torch", "chip_smoke", "tests"}, path
