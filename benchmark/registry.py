"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
each configuration's file, ``traffic/<mix>.json``, ``limits/<workload>.json``,
the driver a traffic mix names (``drivers/<driver>.py``) and one reader a
per-layer metric (``metrics/<metric>.py``, else ``metrics/<name before its
first dot>.py``, which serves every suffix of one quantity).  Adding a cell
or a metric adds files and entries; no file here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(workload_name: str) -> dict:
    return _json(os.path.join(HERE, "limits", f"{workload_name}.json"))


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader_path(metric: str) -> str:
    """metrics/<metric>.py where there is one, else the reader of the
    quantity, metrics/<metric up to its first dot>.py."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if os.path.exists(path):
        return path
    return os.path.join(HERE, "metrics", f"{metric.split('.')[0]}.py")


def reader(metric: str):
    """The ``read(ctx)`` of the metric's reader file."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, workload_name: str) -> tuple:
    """-> (end-to-end metrics, per-layer metrics) the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload_name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload_name in m.get("workloads", [workload_name] if m["moves"] in names
                                       else [])]
    return e2e, layer
