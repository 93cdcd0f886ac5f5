"""The whole slice: the port's encrypted CSTR closed loop held against
the JAX package's, with the reference's own random draws replayed.

At logN=10, slots=16, 8 steps: port vs JAX <= 1e-10 per channel, port
vs its own plaintext twin <= 5e-10 (tests/test_hempc.py's bar), noise
canary < 1e-5.  The port alone also runs the REFERENCE_HEMPC 40-step
loop through its CLI against the golden cstr-hempc.bin.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.control.mpc import MPCBounds as JBounds
from hectr_tpu.control.simulate import simulate as jsimulate
from hectr_tpu.hempc import hempc_init_state as jinit
from hectr_tpu.hempc import make_hempc_regulator as jregulator
from hectr_tpu_torch import cli
from hectr_tpu_torch.ckks import keyswitch as TK
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.control.mpc import MPCBounds
from hectr_tpu_torch.control.simulate import simulate
from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
from hectr_tpu_torch.utils import read_traj_bin
from tests.conftest import load_golden_traj_bin
from tests.test_torch_control import port_setup
from tests.test_torch_scheme import (
    CPU,
    JaxReplay,
    contexts,
    regulator_enc_keys,
    rotation_switch_keys,
)

torch.set_num_threads(1)

SLICE = dict(name="test-slice", logn=10, slots=16, scale_bits=50,
             limb_bits=25, mult_depth=1)
STEPS, HORIZON = 8, 4


@pytest.fixture(scope="module")
def loops():
    ctx, jctx = contexts(SLICE)
    model, plant, _, dt, _, jmodel, jplant = port_setup()
    p_seq = np.zeros((STEPS, 1))
    p_seq[3:, 0] = 0.1 * plant.ps[0]

    jkeys = JS.keygen(jctx, jax.random.PRNGKey(2024))
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(2025))
    jreg = jregulator(jctx, jkeys, jrk, jmodel, jplant, HORIZON)
    jx, ju, (_, jcanary) = jsimulate(
        jmodel, jplant, p_seq, dt, STEPS, regulator=jreg,
        regulator_state=jinit(jax.random.PRNGKey(7)), horizon=HORIZON,
        return_state=True)

    keys = TS.keygen(ctx, JaxReplay(jax.random.PRNGKey(2024)), CPU)
    rotations = list(range(1, ctx.slots))
    rk = TK.gen_rotation_keys(ctx, keys, JaxReplay(switch_keys=rotation_switch_keys(
        jax.random.PRNGKey(2025), rotations)), rotations)
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, HORIZON)
    sampler = JaxReplay(enc_keys=regulator_enc_keys(jax.random.PRNGKey(7)))
    x, u, (_, canary) = simulate(
        model, plant, p_seq, dt, STEPS, CPU, regulator=reg,
        regulator_state=hempc_init_state(sampler, CPU), horizon=HORIZON,
        return_state=True)
    x_pt, u_pt = simulate(model, plant, p_seq, dt, STEPS, CPU, horizon=HORIZON)
    return dict(x=x, u=u, canary=float(canary), jx=jx, ju=ju,
                jcanary=float(jcanary), x_pt=x_pt, u_pt=u_pt, keys=keys, rk=rk)


def test_encrypted_loop_matches_reference(loops):
    r = loops
    assert np.all(np.max(np.abs(r["x"] - r["jx"]), axis=0) <= 1e-10)
    assert np.all(np.max(np.abs(r["u"] - r["ju"]), axis=0) <= 1e-10)
    assert abs(r["canary"] - r["jcanary"]) <= 1e-10


def test_encrypted_loop_matches_plaintext_twin(loops):
    r = loops
    assert np.all(np.max(np.abs(r["x"] - r["x_pt"]), axis=0) < 5e-10)
    assert np.all(np.max(np.abs(r["u"] - r["u_pt"]), axis=0) < 5e-10)
    assert 0 < r["canary"] < 1e-5


def test_constrained_regulator_not_ported():
    """The encrypted QP is ported now; what stays refused, as
    hectr_tpu/hempc/regulator.py:96-100 refuses it, is du bounds without
    a relinearisation key (the JAX package asserts, the port raises
    ValueError)."""
    ctx, jctx = contexts(SLICE)
    model, plant, _, _, _, jmodel, jplant = port_setup()
    keys = TS.keygen(ctx, TS.TorchSampler(0, CPU), CPU)
    box = dict(dumin=np.array([-0.25, -0.004]), dumax=np.array([0.25, 0.004]))
    with pytest.raises(ValueError, match="relinearisation key"):
        make_hempc_regulator(ctx, keys, {}, model, plant, HORIZON,
                             bounds=MPCBounds(**box))
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(0))
    with pytest.raises(AssertionError, match="relin key"):
        jregulator(jctx, jkeys, {}, jmodel, jplant, HORIZON,
                   bounds=JBounds(**box))


def test_bounds_without_du_run_the_unconstrained_law(loops):
    """Bounds that carry only umin/umax (no dumin) run the unconstrained
    regulator, as hectr_tpu/hempc/regulator.py:96 does: the same 8-step
    trajectory as bounds=None, to the last bit, from the same keys and
    draws."""
    ctx, _ = contexts(SLICE)
    model, plant, _, dt, _, _, _ = port_setup()
    p_seq = np.zeros((STEPS, 1))
    p_seq[3:, 0] = 0.1 * plant.ps[0]
    bounds = MPCBounds(umin=np.array([290.0, 0.05]),
                       umax=np.array([310.0, 0.15]))
    reg = make_hempc_regulator(ctx, loops["keys"], loops["rk"], model, plant,
                               HORIZON, bounds=bounds)
    sampler = JaxReplay(enc_keys=regulator_enc_keys(jax.random.PRNGKey(7)))
    x, u, (_, canary) = simulate(
        model, plant, p_seq, dt, STEPS, CPU, regulator=reg,
        regulator_state=hempc_init_state(sampler, CPU), horizon=HORIZON,
        return_state=True)
    assert np.array_equal(x, loops["x"]) and np.array_equal(u, loops["u"])
    assert float(canary) == loops["canary"]


def test_package_imports_no_jax():
    """Every module of the port imports without pulling in jax (the
    machine with the card has none)."""
    code = (
        "import pkgutil, sys\n"
        "import hectr_tpu_torch, hectr_tpu_torch.cli\n"
        "for m in pkgutil.walk_packages(hectr_tpu_torch.__path__, "
        "'hectr_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'hectr_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'hectr_tpu_torch.parallel.limb_ops' in sys.modules\n"
        "assert 'hectr_tpu_torch.bench.suite' in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_reference_hempc_cli_golden(tmp_path):
    """REFERENCE_HEMPC, 40 steps, through the port's CLI on the CPU:
    the golden cstr-hempc.bin to 1e-6 relative, and the plaintext twin
    to 5e-10 per channel."""
    cli.main(["cstr-hempc", "--device", "cpu", "--seed", "11",
              "--out-dir", str(tmp_path)])
    x, u = read_traj_bin(tmp_path / "cstr-hempc.bin")
    golden = load_golden_traj_bin("cstr-hempc.bin")
    ours = np.hstack([x, u])
    err = np.max(np.abs(ours - golden), axis=0)
    assert np.all(err / np.max(np.abs(golden), axis=0) < 1e-6), err
    x_pt, u_pt = cli.run_cstr_mpc(40, CPU)
    assert np.all(np.max(np.abs(x - x_pt), axis=0) < 5e-10)
    assert np.all(np.max(np.abs(u[:-1] - u_pt), axis=0) < 5e-10)
