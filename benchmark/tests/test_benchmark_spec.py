"""BENCHMARK.json and the files the harness finds by name: every entry
loads, follows the contract's names and units, and every metric is
reported where it says it moves something."""

from __future__ import annotations

import json
import math
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert len(cmd) <= 32
    files = [w for w in cmd if (spec.ROOT / w).is_file()]
    assert files and all(any(f.startswith(p + "/") for p in BENCH["paths"])
                         for f in files)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_its_time_with_every_cell():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic", *entry.get("reduced", [])):
        if key in entry:
            assert NAME.match(entry[key])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/configs/")
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert config["guarantees"]["security_bits"] == 128
    assert {"u_rel_gap", "x_rel_gap"} <= set(config["correct_limits"])
    form = config["regulator"]["form"]
    assert callable(spec.regulator(form).build)
    law = spec.law(form)
    assert callable(law.law)
    if set(config["correct_limits"]) - {"u_rel_gap", "x_rel_gap"}:
        assert callable(law.checks)


@pytest.mark.parametrize("regulators,laws", [
    (spec.REGULATORS, spec.LAWS),
    (spec.HERE / "tests" / "forms" / "regulators",
     spec.HERE / "tests" / "forms" / "laws")], ids=["forms", "test-forms"])
def test_every_form_has_its_law_and_every_law_its_form(regulators, laws):
    forms = {p.stem for p in regulators.glob("*.py")}
    assert forms and forms == {p.stem for p in laws.glob("*.py")}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_and_reports_enough(name):
    cell = spec.cell(name)
    assert cell.chips in (1, 4)
    for key in ("plants", "episode_steps", "pool_episodes", "trace_episodes"):
        assert int(cell.traffic[key]) >= 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    allowed = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    assert set(metric) - {"workloads"} == allowed
    assert (spec.HERE / "metrics" / f"{metric['name']}.py").is_file()
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_names_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", CELLS):
        assert spec.reports(e2e[metric["moves"]], cell)


def test_layers_of_one_name_are_spelled_alike():
    by_lower = {}
    for m in BENCH["per_layer"]:
        by_lower.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_lower.values())


def test_files_under_paths_are_named_from_names():
    for path in spec.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert PATH.match(rel), rel


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and not math.isnan(setup["bound"])
