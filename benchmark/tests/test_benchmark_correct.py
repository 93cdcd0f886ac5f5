"""The comparison that decides ``correct``: it passes a sound run of the
port, and fails its control (the reference in float32 in the port's
place) and a run with the port's regulator broken underneath.

The runs drive everything of a run but the look for a card: the harness
on the CPU, at logN = 8 (the HE standard's table has no such ring, so
the security check is left out there), 2 plants, 4-step episodes."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import correct, harness, program, spec

SEED = 2**31 + 4242
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small_cell(name, plants=2, steps=4):
    cell = spec.cell(name)
    cell.config["ckks"]["logn"] = 8
    cell.traffic.update(plants=min(plants, cell.traffic["plants"]),
                        episode_steps=steps, pool_episodes=3, trace_episodes=1)
    return cell


@pytest.fixture
def cpu_run(monkeypatch):
    monkeypatch.setattr(program, "check_security", lambda ctx, config: None)

    def run(name, **kw):
        return harness.run_cell(small_cell(name, **kw), SEED, 0.0, False,
                                torch.device("cpu"), time.perf_counter())
    return run


def broken(monkeypatch, fault):
    """Replace the port's make_hempc_regulator by one whose regulator is
    broken by `fault(regulator, state, xhat, uhat, xr, ur, calls)`."""
    from hectr_tpu_torch import hempc

    make = hempc.make_hempc_regulator

    def make_broken(*args, **kwargs):
        reg = make(*args, **kwargs)
        calls = [0]

        def regulator(state, xhat, uhat, xr, ur):
            calls[0] += 1
            return fault(reg, state, xhat, uhat, xr, ur, calls[0])
        return regulator
    monkeypatch.setattr(hempc, "make_hempc_regulator", make_broken)


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
    with pytest.raises(ValueError, match="reference-shaped"):
        harness.run_cell(cell, SEED, 0.0, False, torch.device("cpu"),
                         time.perf_counter())


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
