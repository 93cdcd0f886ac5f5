"""The port's plaintext control stack held against the JAX package and
the reference's goldens: CSTR plant, integrators, linearisation, and
the 40-step closed loop (<= 1e-12 per channel against JAX; the goldens
at the bars of tests/test_cstr.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu.control import ode as jode
from hectr_tpu.control.plants import cstr as jcstr
from hectr_tpu.control.simulate import simulate as jsimulate
from hectr_tpu_torch import cli
from hectr_tpu_torch.control import ode as tode
from hectr_tpu_torch.control.plants import cstr as tcstr
from hectr_tpu_torch.control.simulate import LinearModel, Plant, simulate
from hectr_tpu_torch.utils import read_traj_bin, write_traj_bin
from tests.conftest import load_golden_traj_bin, load_golden_txt
from tests.test_cstr import make_cstr_setup

torch.set_num_threads(1)

CPU = torch.device("cpu")


def port_setup():
    """tests/test_cstr.py's make_cstr_setup with the port's plant."""
    jmodel, jplant, p_seq, dt, N = make_cstr_setup()
    ss = tcstr.CSTR_STEADY_STATE
    A, B, _ = tcstr.cstr_linearize(ss["xs"], ss["us"], ss["ps"], dt)
    model = LinearModel(A=A, B=B, C=jmodel.C, Bd=jmodel.Bd, Cd=jmodel.Cd,
                        Hr=jmodel.Hr)
    plant = Plant(ode=tcstr.cstr_ode, jacobian=tcstr.cstr_jacobian,
                  xs=ss["xs"], us=ss["us"], ps=ss["ps"])
    return model, plant, p_seq, dt, N, jmodel, jplant


def test_linearisation_matches_reference():
    ss = tcstr.CSTR_STEADY_STATE
    got = tcstr.cstr_linearize(ss["xs"], ss["us"], ss["ps"], 1.0)
    want = jcstr.cstr_linearize(ss["xs"], ss["us"], ss["ps"], 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-15)


@pytest.mark.parametrize("step", ["rk4", "stiff"])
def test_plant_steps_match_reference(step):
    xs = tcstr.CSTR_STEADY_STATE["xs"]
    u, p = np.array([290.0, 0.1]), np.array([0.1])
    x = torch.from_numpy(xs.copy())
    jx = jnp.asarray(xs)
    for _ in range(5):
        if step == "rk4":
            x = tode.rk4_step(tcstr.cstr_ode, x, torch.from_numpy(u),
                              torch.from_numpy(p), 1.0)
            jx = jode.rk4_step(jcstr.cstr_ode, jx, jnp.asarray(u),
                               jnp.asarray(p), 1.0)
        else:
            x = tode.stiff_step(tcstr.cstr_ode, tcstr.cstr_jacobian, x,
                                torch.from_numpy(u), torch.from_numpy(p), 1.0)
            jx = jode.stiff_step(jcstr.cstr_ode, jcstr.cstr_jacobian, jx,
                                 jnp.asarray(u), jnp.asarray(p), 1.0)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-14, atol=0)


def test_cstr_ode_golden():
    xs = tcstr.CSTR_STEADY_STATE["xs"]
    u = torch.tensor([290.0, 0.1], dtype=torch.float64)
    p = torch.tensor([0.1], dtype=torch.float64)
    x45 = torch.from_numpy(xs.copy())
    x15 = torch.from_numpy(xs.copy())
    rows = [[0.0, *x45[:2].tolist(), *x15[:2].tolist()]]
    for i in range(1, 6):
        x45 = tode.rk4_step(tcstr.cstr_ode, x45, u, p, 1.0)
        x15 = tode.stiff_step(tcstr.cstr_ode, tcstr.cstr_jacobian, x15, u, p, 1.0)
        rows.append([float(i), *x45[:2].tolist(), *x15[:2].tolist()])
    np.testing.assert_allclose(np.array(rows), load_golden_txt("cstr-ode.txt"),
                               atol=2e-6)


@pytest.fixture(scope="module")
def loops():
    model, plant, p_seq, dt, N, jmodel, jplant = port_setup()
    x, u = simulate(model, plant, p_seq, dt, N, CPU)
    jx, ju = jsimulate(jmodel, jplant, p_seq, dt, N)
    return x, u, jx, ju


def test_closed_loop_matches_reference(loops):
    x, u, jx, ju = loops
    assert x.shape == jx.shape and u.shape == ju.shape
    assert np.all(np.max(np.abs(x - jx), axis=0) <= 1e-12)
    assert np.all(np.max(np.abs(u - ju), axis=0) <= 1e-12)


def test_cstr_mpc_closed_loop_golden(loops):
    x, u, _, _ = loops
    golden = load_golden_traj_bin("cstr-mpc.bin")
    ours = np.hstack([x, np.vstack([u, u[-1:]])])
    err = np.max(np.abs(ours - golden), axis=0)
    scale = np.max(np.abs(golden), axis=0)
    assert np.all(err / scale < 1e-6), (err, err / scale)


def test_cli_plaintext_loop_and_trajectory_files(tmp_path):
    cli.main(["cstr-mpc", "--device", "cpu", "--out-dir", str(tmp_path)])
    x, u = read_traj_bin(tmp_path / "cstr-mpc.bin")
    golden = load_golden_traj_bin("cstr-mpc.bin")
    ours = np.hstack([x, u])
    assert np.all(np.max(np.abs(ours - golden), axis=0)
                  / np.max(np.abs(golden), axis=0) < 1e-6)
    rows = np.loadtxt(tmp_path / "cstr-mpc.txt")
    assert rows.shape == (41, 6)
    write_traj_bin(tmp_path / "again.bin", x, u[:-1])
    assert (tmp_path / "again.bin").read_bytes() == (
        tmp_path / "cstr-mpc.bin").read_bytes()


def test_cli_refuses_missing_cuda(monkeypatch, tmp_path):
    """--device cuda with no CUDA fails; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["cstr-mpc", "--out-dir", str(tmp_path)])
    assert not (tmp_path / "cstr-mpc.bin").exists()
