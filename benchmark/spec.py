"""Find a cell's configuration, traffic and metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells; a cell names
its configuration (``configs/<config>.json``) and its traffic
(``workloads/<traffic>.json``).  A metric is reported in a cell when its
``workloads`` list names the cell or, without that key, when the cell
reports the end-to-end metric it ``moves``; it is read by
``metrics/<metric>.py``, whose ``read(run)`` returns a number or None.
A configuration's regulator form (``config["regulator"]["form"]``) is
built by ``regulators/<form>.py`` and followed by the reference's law in
``reference/laws/<form>.py``.  Adding a cell, a configuration, a metric
or a regulator form is adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
REGULATORS = HERE / "regulators"
LAWS = HERE / "reference" / "laws"


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


def load(path: pathlib.Path, name: str):
    """The module in the file `path`, under the module name `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The ``read(run)`` function of metrics/<metric>.py."""
    return load(HERE / "metrics" / f"{metric}.py",
                "benchmark.metrics." + metric.replace(".", "_")).read


def form(directory: pathlib.Path, name: str):
    """The module <directory>/<name>.py of the regulator form `name`;
    raises a ValueError naming the form and the directory where there is
    none."""
    path = directory / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"regulator form {name!r}: no {path.name} in "
                         f"{directory}")
    return load(path, f"benchmark.{directory.name}.{name.replace('-', '_')}")


def regulator(name: str):
    """regulators/<name>.py: ``build(...)``, the port's regulator."""
    return form(REGULATORS, name)


def law(name: str):
    """reference/laws/<name>.py: ``law(system, config)`` and, optionally,
    ``checks(config, x, u)``."""
    return form(LAWS, name)


def settings(regulator: dict, *keys: str) -> list:
    """The values of `keys` in a configuration's ``regulator`` block,
    whose form takes ``form`` and exactly these; raises a ValueError
    naming the form on any other key or any missing one."""
    taken = {"form", *keys}
    if set(regulator) != taken:
        raise ValueError(
            f"regulator form {regulator.get('form')!r} takes the keys "
            f"{sorted(taken)}; the configuration gives {sorted(regulator)}")
    return [regulator[k] for k in keys]
