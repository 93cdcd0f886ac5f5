"""The comparison that decides ``correct``: it passes a sound run of the
port, and fails its control (the reference in float32 in the port's
place) and a run with the port's regulator broken underneath.  A
regulator form added as files alone (``tests/forms/``: the fused
regulator) runs and is judged the same way, and a law's own checks
decide with the rest.

The runs drive everything of a run but the look for a card: the harness
on the CPU, at logN = 8 (the HE standard's table has no such ring, so
the security check is left out there), 2 plants, 4-step episodes."""

from __future__ import annotations

import pathlib
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import correct, harness, program, spec
from benchmark import traffic as T

SEED = 2**31 + 4242
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
FORMS = pathlib.Path(__file__).resolve().parent / "forms"


def small_cell(name, plants=2, steps=4):
    cell = spec.cell(name)
    cell.config["ckks"]["logn"] = 8
    cell.traffic.update(plants=min(plants, cell.traffic["plants"]),
                        episode_steps=steps, pool_episodes=3, trace_episodes=1)
    return cell


@pytest.fixture
def cpu_run(monkeypatch):
    monkeypatch.setattr(program, "check_security", lambda ctx, config: None)

    def run(name, form=None, limits=None, **kw):
        cell = small_cell(name, **kw)
        if form is not None:
            cell.config["regulator"]["form"] = form
        cell.config["correct_limits"].update(limits or {})
        return harness.run_cell(cell, SEED, 0.0, False, torch.device("cpu"),
                                time.perf_counter())
    return run


@pytest.fixture
def forms(tmp_path, monkeypatch):
    """The harness's form lookups pointed at copies of regulators/ and
    reference/laws/ with the files of tests/forms/ added: a form that
    comes in as files alone.  Returns the two directories."""
    def add(attr, extra):
        directory = tmp_path / getattr(spec, attr).name
        shutil.copytree(getattr(spec, attr), directory,
                        ignore=shutil.ignore_patterns("__pycache__"))
        for path in extra.glob("*.py"):
            shutil.copy(path, directory)
        monkeypatch.setattr(spec, attr, directory)
        return directory
    return add("REGULATORS", FORMS / "regulators"), add("LAWS", FORMS / "laws")


def broken(monkeypatch, fault, module=None, name="make_hempc_regulator"):
    """Replace the port's regulator factory `module.name` (by default
    hempc.make_hempc_regulator) by one whose regulator is broken by
    `fault(regulator, state, xhat, uhat, xr, ur, calls)`."""
    from hectr_tpu_torch import hempc

    module = hempc if module is None else module
    make = getattr(module, name)

    def make_broken(*args, **kwargs):
        reg = make(*args, **kwargs)
        calls = [0]

        def regulator(state, xhat, uhat, xr, ur):
            calls[0] += 1
            return fault(reg, state, xhat, uhat, xr, ur, calls[0])
        return regulator
    monkeypatch.setattr(module, name, make_broken)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(cpu_run, name):
    out = cpu_run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] == min(2, spec.cell(name).traffic["plants"]) * 4
    assert list(out)[-1] == "checks"
    assert out["checks"]["u_rel_gap"]["value"] < 1e-10


@pytest.mark.parametrize("regulator", [{"form": "fused", "horizon": 4},
                                       {"form": "reference-shaped",
                                        "horizon": 4, "du_box": None}])
def test_a_regulator_the_harness_cannot_build_is_refused(cpu_run, regulator):
    cell = small_cell(CELLS[0])
    cell.config["regulator"] = regulator
    with pytest.raises(ValueError, match=f"regulator form {regulator['form']!r}"):
        harness.run_cell(cell, SEED, 0.0, False, torch.device("cpu"),
                         time.perf_counter())


@pytest.mark.parametrize("side", ["port", "reference"])
def test_an_unknown_form_names_itself_and_its_directory(cpu_run, side):
    from benchmark.reference.loop import reference_episodes

    cell = small_cell(CELLS[0])
    cell.config["regulator"]["form"] = "no-such-form"
    with pytest.raises(ValueError) as refused:
        if side == "port":
            harness.run_cell(cell, SEED, 0.0, False, torch.device("cpu"),
                             time.perf_counter())
        else:
            reference_episodes(cell.config, np.zeros((1, 1, 4, 1)), [0])
    directory = spec.REGULATORS if side == "port" else spec.LAWS
    assert "'no-such-form'" in str(refused.value)
    assert str(directory) in str(refused.value)


def unchanged(reg, state, xhat, uhat, xr, ur, calls):
    """The step returns its state unchanged: no move is made."""
    return uhat.clone(), state


def half_batch(reg, state, xhat, uhat, xr, ur, calls):
    """Half of the batch left out, the mean of the other half in its place."""
    sampler, canary = state
    h = xhat.shape[0] // 2
    u, (sampler, c) = reg((sampler, canary[:h]), xhat[:h], uhat[:h], xr[:h],
                          ur[:h])
    rest = u.mean(dim=0, keepdim=True).expand(xhat.shape[0] - h, -1)
    return torch.cat([u, rest]), (sampler, torch.cat([c, canary[h:]]))


def altered(reg, state, xhat, uhat, xr, ur, calls):
    """One answer altered where it is produced: one move of one plant off
    by 1e-7 of its steady-state input."""
    u, state = reg(state, xhat, uhat, xr, ur)
    if calls == 6:
        u = u.clone()
        u[..., 0] += 1e-7 * 300.0
    return u, state


def faults():
    """(cell, fault) for every fault each cell can have: one chip, so no
    exchange between chips; half of a batch only where a batch is served."""
    for name in CELLS:
        served = spec.cell(name).traffic["plants"] > 1
        for fault in (unchanged, altered, half_batch):
            if fault is not half_batch or served:
                yield pytest.param(name, fault, id=f"{name}-{fault.__name__}")


@pytest.mark.parametrize("name", CELLS)
def test_a_form_added_as_files_alone_is_correct(cpu_run, forms, name):
    out = cpu_run(name, form="fused")
    assert out["correct"], out["checks"]
    assert out["attempted"] == min(2, spec.cell(name).traffic["plants"]) * 4
    assert list(out["checks"]) == list(correct.BASE)
    assert out["checks"]["u_rel_gap"]["value"] < 1e-10


@pytest.mark.parametrize("name,fault", list(faults()))
def test_a_broken_form_added_as_files_is_not_correct(cpu_run, forms,
                                                     monkeypatch, name, fault):
    from hectr_tpu_torch.hempc import fused

    broken(monkeypatch, fault, fused, "make_fused_regulator")
    out = cpu_run(name, form="fused")
    assert not out["correct"]
    assert out["failed"] > 0


MOVE_CHECK = '''

import numpy as np


def checks(config, x, u):
    """move_rel: each move's widest step from the move before it (from
    the steady state at the first step), over |us|."""
    us = np.asarray(config["plant"]["us"])
    first = np.broadcast_to(us, u[..., :1, :].shape)
    du = np.abs(np.diff(u, axis=-2, prepend=first)) / np.abs(us)
    return {"move_rel": (du.max(axis=-1),
                         config["correct_limits"]["move_rel"])}
'''


@pytest.mark.parametrize("limit,passes", [(1e-12, False), (1.0, True)])
def test_a_laws_checks_decide_with_the_rest(cpu_run, forms, limit, passes):
    law = forms[1] / "reference-shaped.py"
    law.write_text(law.read_text() + MOVE_CHECK)
    out = cpu_run(CELLS[0], limits={"move_rel": limit})
    assert list(out["checks"]) == [*correct.BASE, "move_rel"]
    check = out["checks"]["move_rel"]
    assert check["limit"] == limit and 1e-6 < check["value"] < 1.0
    assert out["correct"] is passes
    assert (out["failed"] > 0) is not passes


def test_a_limit_no_check_reads_is_refused():
    cfg = spec.cell(CELLS[0]).config
    cfg["correct_limits"]["move_rel"] = 1e-3
    x = np.ones((1, 1, 5, 3)) * cfg["plant"]["xs"]
    u = np.ones((1, 1, 4, 2)) * cfg["plant"]["us"]
    with pytest.raises(ValueError, match="move_rel"):
        correct.compare(cfg, x, u, np.zeros((1, 1)), x, u)


def test_a_form_draws_its_own_stream(monkeypatch, forms):
    """``sampler(name)`` hands a form the stream ``traffic.stream`` derives
    from the run's seed and the name."""
    from hectr_tpu_torch.ckks.scheme import TorchSampler

    (forms[0] / "probe.py").write_text('''
def build(config, ctx, keys, rot_keys, model, plant, sampler, device):
    def regulator(state, xhat, uhat, xr, ur):
        raise NotImplementedError
    regulator.drawn = sampler("probe").gauss(64)
    return regulator
''')
    monkeypatch.setattr(program, "check_security", lambda ctx, config: None)
    cell = small_cell(CELLS[0])
    cell.config["regulator"]["form"] = "probe"
    cpu = torch.device("cpu")
    deployment = program.Deployment(cell.config, SEED, np.zeros((1, 1, 4, 1)),
                                    cpu)
    want = TorchSampler(T.stream(SEED, "probe"), cpu).gauss(64)
    assert torch.equal(deployment.regulator.drawn, want)
    for seed in T.seeds(SEED).values():
        assert not torch.equal(want, TorchSampler(seed, cpu).gauss(64))


@pytest.mark.parametrize("name,fault", list(faults()))
def test_a_broken_regulator_is_not_correct(cpu_run, monkeypatch, name, fault):
    broken(monkeypatch, fault)
    out = cpu_run(name)
    assert not out["correct"]
    assert out["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_float32_control_is_not_correct(name):
    import control

    rec = control.control(spec.cell(name), SEED, episodes=3)
    assert not rec["correct"]
    lim = correct.limits(spec.cell(name).config)
    assert rec["checks"]["u_rel_gap"]["value"] > 3 * lim["u_rel_gap"]
    assert rec["checks"]["x_rel_gap"]["value"] > 3 * lim["x_rel_gap"]


def test_compare_counts_each_bad_loop_step():
    cfg = spec.cell(CELLS[-1]).config
    x = np.ones((2, 3, 5, 3)) * cfg["plant"]["xs"]
    u = np.ones((2, 3, 4, 2)) * cfg["plant"]["us"]
    canary = np.zeros((2, 3))
    checks, failed, attempted = correct.compare(cfg, x, u, canary, x, u)
    assert (failed, attempted) == (0, 24) and correct.passed(checks, failed)
    u2 = u.copy()
    u2[1, 2, 3, 1] = np.nan
    x2 = x.copy()
    x2[0, 0, 2, 1] *= 1 + 1e-6
    canary[1, 0] = 1e-3
    checks, failed, _ = correct.compare(cfg, x2, u2, canary, x, u)
    assert failed == 1 + 1 + 4
    assert checks["u_rel_gap"]["value"] == np.inf
    assert not correct.passed(checks, failed)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          CELLS[0], "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
