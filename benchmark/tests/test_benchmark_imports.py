"""What the harness may import, and that its run path refuses a machine
without a card."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "hectr_tpu"}
SOURCES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "tests" not in p.relative_to(spec.HERE).parts)
FORMS = spec.HERE / "tests" / "forms"   # forms the tests add as files


def imported(path) -> set[str]:
    """Every module name `path` imports (relative imports resolved to
    the benchmark package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = "benchmark" if node.level else (node.module or "")
            names.add(base if not node.module or node.level == 0
                      else f"{base}.{node.module}")
            names |= {f"{node.module}.{a.name}" for a in node.names
                      if node.module and node.level == 0}
    return names


@pytest.mark.parametrize("path", SOURCES + sorted(FORMS.rglob("*.py")),
                         ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_no_jax_and_no_port_bench(path):
    for name in imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, (path, name)
        assert not name.startswith("hectr_tpu_torch.bench"), (path, name)


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").rglob("*.py"))
                         + sorted((FORMS / "laws").glob("*.py")),
                         ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_reference_imports_nothing_of_the_port(path):
    for name in imported(path):
        assert name.split(".")[0] in {"numpy", "benchmark", "dataclasses",
                                      "functools", "math", "__future__"}, name


def test_only_program_imports_the_port():
    """Only program.py and the regulator forms' files, regulators/*.py."""
    users = {p.relative_to(spec.HERE).as_posix() for p in SOURCES
             if any(n.split(".")[0] == "hectr_tpu_torch" for n in imported(p))}
    forms = {f"regulators/{p.name}" for p in spec.REGULATORS.glob("*.py")}
    assert "program.py" in users and users <= {"program.py"} | forms, users


def test_run_refuses_a_machine_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          spec.benchmark()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_forbidden_modules_compares_top_level_names_whole():
    sys.path.insert(0, str(spec.HERE))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        sys.modules["hectr_tpu_torch_extra"] = sys
        assert "hectr_tpu_torch_extra" not in run.forbidden_modules()
        sys.modules["hectr_tpu.ckks"] = sys
        sys.modules["jaxlib"] = sys
        assert {"hectr_tpu.ckks", "jaxlib"} <= set(run.forbidden_modules())
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
