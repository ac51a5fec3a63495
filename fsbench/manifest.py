"""``BENCHMARK.json`` and the files it names, found by name: a
configuration's file (its ``file`` entry), a traffic mix at
``fsbench/traffic/<traffic>.json``, the kind of load a mix names at
``fsbench/kinds/<kind>.py``, a failure a mix names at
``fsbench/kills/<kill>.py`` and a metric's reader at
``fsbench/metrics/<metric>.py``. Adding a cell, a configuration, a mix,
a kind, a failure or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, folder: str = HERE) -> dict:
    with open(os.path.join(folder, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _module(sub: str, name: str, folder: str):
    path = os.path.join(folder, sub, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"fsbench.{sub}." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, folder: str = HERE):
    """The ``read(window) -> float | None`` of ``metrics/<metric>.py``."""
    return _module("metrics", metric, folder).read


def kind(name: str, folder: str = HERE):
    """``kinds/<name>.py``: a kind of load, with ``async setup(cell)``
    (inputs, data set, warm-up), ``async drive(cell, t0)`` (the window)
    and ``async check(cell)`` (the comparison with the reference)."""
    return _module("kinds", name, folder)


def kill(name: str, folder: str = HERE):
    """``kills/<name>.py``: a failure set up before the window, with
    ``async apply(cell)`` and ``async check(cell)`` (it held to the end)."""
    return _module("kills", name, folder)


def _listed(metric: dict, cell: str) -> bool | None:
    ws = metric.get("workloads")
    return None if ws is None else cell in ws


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The cell's end-to-end metrics: those that list it, and those that
    list no cells."""
    return [m for m in bench["end_to_end"] if _listed(m, cell) is not False]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The cell's per-layer metrics: those that list it, and those that
    list no cells where the cell reports the metric they move."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        listed = _listed(m, cell)
        if listed or (listed is None and m["moves"] in moved):
            out.append(m)
    return out
