"""The port's CLI subcommands against the JAX CLI's output files from the
same run and against the reference's goldens; the section timer and the
plots."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hectr_tpu import cli as jcli
from hectr_tpu_torch import cli
from hectr_tpu_torch.utils import pmu, plotting, read_traj_bin, timed
from tests import test_qp as jqp
from tests import test_torch_qp_oracle as qp_oracle
from tests.conftest import GOLDEN_DIR

torch.set_num_threads(1)

TRACKING_CASES = (5, 6, 7, 8, 9, 11, 12)


def _both(tmp_path, *argv):
    """Run a subcommand through both CLIs -> (port dir, JAX dir)."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    cli.main([*argv, "--out-dir", str(port), "--device", "cpu"])
    jcli.main([*argv, "--out-dir", str(ref)])
    return port, ref


def _txt_close(a, b, atol):
    np.testing.assert_allclose(np.loadtxt(a), np.loadtxt(b), rtol=0, atol=atol)


def test_cstr_ode(tmp_path):
    port, ref = _both(tmp_path, "cstr-ode")
    _txt_close(port / "cstr-ode.txt", ref / "cstr-ode.txt", 1e-10)
    # printed to 6 decimals, as the golden (tests/test_cstr.py: 2e-6)
    _txt_close(port / "cstr-ode.txt", GOLDEN_DIR / "cstr-ode.txt", 2e-6)


def test_mpc_tracking(tmp_path):
    port, ref = _both(tmp_path, "mpc-tracking")
    for case in TRACKING_CASES:
        name = f"mpc-tracking-{case}.txt"
        _txt_close(port / name, ref / name, 1e-10)
        _txt_close(port / name, GOLDEN_DIR / name, 1e-6)


def test_inverted_pendulum(tmp_path):
    port, ref = _both(tmp_path, "inverted-pendulum-mpc-control")
    name = "inverted-pendulum-mpc-control.txt"
    _txt_close(port / name, ref / name, 1e-10)
    assert np.loadtxt(port / name).shape == (31, 6)


def test_cstr_lqr(tmp_path):
    port, ref = _both(tmp_path, "cstr-lqr")
    x, u = read_traj_bin(port / "cstr-lqr.bin")
    jx, ju = read_traj_bin(ref / "cstr-lqr.bin")
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-10)
    _txt_close(port / "cstr-lqr.txt", ref / "cstr-lqr.txt", 1e-10)
    gx, gu = read_traj_bin(GOLDEN_DIR / "cstr-lqr.bin")
    np.testing.assert_allclose(x, gx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(u, gu, rtol=0, atol=1e-6)


def test_cstr_cmp(tmp_path, capsys):
    """|cstr-mpc - cstr-hempc| from the reference's own binaries equals
    its committed cstr-cmp.bin, and the JAX CLI's file."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    for d in (port, ref):
        d.mkdir()
        for name in ("cstr-mpc.bin", "cstr-hempc.bin"):
            shutil.copy(GOLDEN_DIR / name, d / name)
    cli.main(["cstr-cmp", "--out-dir", str(port)])
    line = capsys.readouterr().out
    jcli.main(["cstr-cmp", "--out-dir", str(ref)])
    assert capsys.readouterr().out == line
    assert (port / "cstr-cmp.bin").read_bytes() == (ref / "cstr-cmp.bin").read_bytes()
    x, u = read_traj_bin(port / "cstr-cmp.bin")
    gx, gu = read_traj_bin(GOLDEN_DIR / "cstr-cmp.bin")
    np.testing.assert_allclose(x, gx, rtol=0, atol=1e-18)
    np.testing.assert_allclose(u, gu, rtol=0, atol=1e-18)


def test_security_lines_identical(tmp_path, capsys):
    cli.main(["security", "--out-dir", str(tmp_path)])
    got = capsys.readouterr().out
    jcli.main(["security", "--out-dir", str(tmp_path)])
    assert got == capsys.readouterr().out
    assert len(got.strip().splitlines()) == len(cli.PRESETS)


def test_quadprog_prints_passing_summary(tmp_path, capsys):
    cli.main(["quadprog", "--out-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip()
    assert "passed" in line and "failed" not in line and "error" not in line
    assert line.startswith(f"{len(qp_oracle.ALL_CASES)} passed"), line


def test_qp_oracle_cases_equal_the_jax_suites():
    """The oracle suite's own copy of the cases is tests/test_qp.py's."""
    assert sorted(qp_oracle.ALL_CASES) == sorted(jqp.ALL_CASES)
    for name, (H, c, kwargs, documented) in qp_oracle.ALL_CASES.items():
        jH, jc, jkwargs, jdocumented = jqp.ALL_CASES[name]
        assert sorted(kwargs) == sorted(jkwargs), name
        for a, b in [(H, jH), (c, jc), (documented, jdocumented)] + [
                (kwargs[k], jkwargs[k]) for k in kwargs]:
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a, float),
                                              np.asarray(b, float))


def test_qp_oracle_imports_no_jax():
    """The suite that `quadprog` runs loads without jax or the JAX
    package (the card's machine has neither)."""
    code = ("import sys, runpy\n"
            f"runpy.run_path({str(cli.QP_ORACLE)!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hectr_tpu', 'tests'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = cli.QP_ORACLE.parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_default_refused_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["cstr-lqr", "--out-dir", str(tmp_path)])


def test_timed_prints_its_line(capsys):
    with timed("unit-test-section"):
        pass
    assert "[pmu] unit-test-section: " in capsys.readouterr().err


def test_timer_accumulates_and_traces(tmp_path, capsys):
    t = pmu.Timer()
    for _ in range(2):
        with t.section("add"):
            torch.ones(4) + 1
    with t.section("traced", trace_dir=str(tmp_path)):
        torch.ones(4) * 2
    rep = t.report()
    assert set(rep) == {"add", "traced"} and all(v >= 0 for v in rep.values())
    assert capsys.readouterr().err.count("[pmu] ") == 3
    trace = json.loads((tmp_path / "traced.json").read_text())
    assert trace["traceEvents"]


def test_plot_writes_pdfs(tmp_path):
    cli.main(["cstr-lqr", "--out-dir", str(tmp_path), "--device", "cpu",
              "--steps", "12", "--plot"])
    x, u = read_traj_bin(tmp_path / "cstr-lqr.bin")
    rows = np.loadtxt(GOLDEN_DIR / "cstr-ode.txt")
    plotting.plot_differential(np.abs(np.hstack([x, u])), tmp_path / "d.pdf")
    plotting.plot_integrators(rows, tmp_path / "o.pdf")
    plotting.plot_tracking(u[:, 0], x[:, :2], tmp_path / "t.pdf", title="t")
    for name in ("cstr-lqr.pdf", "d.pdf", "o.pdf", "t.pdf"):
        head = (tmp_path / name).read_bytes()[:5]
        assert head == b"%PDF-", name

