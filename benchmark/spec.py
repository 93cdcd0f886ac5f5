"""Find a cell's configuration, traffic and metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells; a cell names
its configuration (``configs/<config>.json``) and its traffic
(``workloads/<traffic>.json``).  A metric is reported in a cell when its
``workloads`` list names the cell or, without that key, when the cell
reports the end-to-end metric it ``moves``; it is read by
``metrics/<metric>.py``, whose ``read(run)`` returns a number or None.
Adding a cell, a configuration or a metric is adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]   # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether an end-to-end metric entry is reported in `cell`."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=load_json(HERE / "configs" / f"{entry['config']}.json"),
                traffic=load_json(HERE / "workloads" / f"{entry['traffic']}.json"),
                end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    """The ``read(run)`` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
