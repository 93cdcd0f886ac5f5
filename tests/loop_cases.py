"""What the closed loop's stage tests share: disturbances, episodes
through ``control.simulate``, the plant setups, the loop's counts, and
the card's fixtures (the card, the benchmark configuration's keys).
Imports neither jax nor the JAX package."""

import numpy as np
import pytest
import torch

from hectr_tpu_torch import cli
from hectr_tpu_torch import config as cfg
from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.gemv import bsgs_rotations
from hectr_tpu_torch.control import simulate as sim
from hectr_tpu_torch.control.plants import cstr
from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
from hectr_tpu_torch.utils import pmu

CPU = torch.device("cpu")
HORIZON = 4


def disturbances(episodes_: int, steps: int, batch=()):
    """Inlet-flow steps of 0.5-1.5x the reference's, one per episode and
    plant: [episodes, *batch, steps, 1]."""
    rng = np.random.default_rng(21)
    scale = rng.uniform(0.5, 1.5, (episodes_, *batch, 1, 1))
    return cli.disturbance(steps)[None] * scale


def episodes(p, device, reg=None, sampler=None, setup=cli.cstr_setup):
    """Closed-loop episodes back to back (p [E, N, 1] for one plant,
    [E, B, N, 1] for B plants) through `reg` (the plaintext MPC regulator
    where None), with one encryption sampler where given: x, u and (with
    a sampler) the canary of each, on the host."""
    out = []
    for pe in p:
        batch = pe.shape[:-2]
        model, plant = setup()
        kw = dict(regulator=reg, horizon=HORIZON)
        if sampler is not None:
            kw["regulator_state"] = hempc_init_state(sampler, device, batch)
        if batch:
            x, u, state = sim.simulate_batch(model, plant, pe, 1.0,
                                             pe.shape[-2], device, **kw)
        else:
            x, u, state = sim.simulate(model, plant, pe, 1.0, pe.shape[-2],
                                       device, return_state=True, **kw)
        out.append((x, u, None if sampler is None else state[1].cpu()))
    return out


def assert_bit_equal(a, b):
    assert len(a) == len(b)
    for (x, u, c), (x1, u1, c1) in zip(a, b):
        assert np.array_equal(x, x1) and np.array_equal(u, u1)
        assert (c is None and c1 is None) or torch.equal(c, c1)


def loop_counts() -> dict:
    return {k: v for k, v in pmu.COUNTS.items() if k.startswith("loop.")}


def shifted_setup():
    """The CSTR setup with the steady-state inlet flow 5% higher: other
    plant values, so other constants."""
    model, plant = cli.cstr_setup()
    return model, sim.Plant(ode=plant.ode, jacobian=plant.jacobian,
                            xs=plant.xs, us=plant.us, ps=plant.ps * 1.05)


def wrapped_ode(x, u, p):
    """The CSTR's right-hand side behind another function: a plant that
    K13 does not take, whose stages the card runs as a CUDA graph."""
    return cstr.cstr_ode(x, u, p)


def graph_setup():
    """The CSTR setup with its right-hand side wrapped (``wrapped_ode``):
    on the card its stages take ``StageGraph``."""
    model, plant = cli.cstr_setup()
    return model, sim.Plant(ode=wrapped_ode, jacobian=plant.jacobian,
                            xs=plant.xs, us=plant.us, ps=plant.ps)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def secure(card):
    """The benchmark configuration's ring (reference-hempc-secure) on the
    card, BSGS rotation keys."""
    return cli.hempc_keys(cfg.REFERENCE_HEMPC_SECURE, 0, card,
                          bsgs_rotations(16))


def regulator_and_sampler(kind, request, card):
    """(regulator, a maker of its samplers): the plaintext MPC regulator
    (no sampler), or the encrypted one at reference-hempc-secure."""
    if kind == "plaintext":
        return None, lambda: None
    ctx, keys, rk = request.getfixturevalue("secure")
    reg = make_hempc_regulator(ctx, keys, rk, *cli.cstr_setup(), HORIZON)
    return reg, lambda: S.TorchSampler(3, card)
