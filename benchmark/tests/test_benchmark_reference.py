"""The reference against the port's plaintext paths at CPU size: the
closed loop and law against hectr_tpu_torch's plaintext loop, and the
frozen NTT bound against the port's bench arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import program, spec, yardstick
from benchmark import traffic as T
from benchmark.reference import control as K
from benchmark.reference.loop import System, reference_episodes

CELL = spec.benchmark()["workloads"][0]["name"]


def config(name):
    return spec.cell(name).config


def pool(name, episodes=3, plants=2, seed=2**31 + 5):
    traffic = dict(spec.cell(name).traffic, pool_episodes=episodes,
                   plants=plants)
    return T.pool(traffic, T.seeds(seed)["traffic"])


def test_matrices_equal_the_ports():
    from hectr_tpu_torch.control.mpc import mpc_gains, mpc_hessian
    from hectr_tpu_torch.control.stages import (estimator_gains,
                                                selector_matrix,
                                                weighting_matrices)

    cfg = config(CELL)
    model, plant = program.plant_and_model(cfg)
    sys = System.from_config(cfg)
    assert np.array_equal(sys.A, model.A) and np.array_equal(sys.B, model.B)
    Lx, Ld = estimator_gains(model.A, model.B, model.C, model.Bd, model.Cd,
                             plant.xs)
    np.testing.assert_allclose(sys.Lx, Lx, rtol=0, atol=1e-14)
    np.testing.assert_allclose(sys.Ld, Ld, rtol=0, atol=1e-14)
    np.testing.assert_allclose(sys.Ginv, selector_matrix(
        model.A, model.B, model.C, model.Hr), rtol=1e-14)
    Q, R = weighting_matrices(plant.xs, plant.us)
    K_A, K_B = mpc_gains(3, 3, 2, 4, model.A, model.B, model.C, Q, R)
    np.testing.assert_allclose(sys.K_A, K_A, rtol=1e-12)
    np.testing.assert_allclose(sys.K_B, K_B, rtol=1e-12)
    _, _, H = K.mpc_gains(sys.A, sys.B, sys.C, Q, R, 4)
    np.testing.assert_allclose(H, mpc_hessian(3, 3, 2, 4, model.A, model.B,
                                              model.C, Q, R), rtol=1e-14)
    np.testing.assert_array_equal(K.weighting(plant.xs, plant.us)[0], Q)


def test_closed_loop_and_law_against_the_ports_plaintext_loop():
    from hectr_tpu_torch.control.simulate import (make_mpc_regulator,
                                                  simulate_batch)

    cfg = config(CELL)
    model, plant = program.plant_and_model(cfg)
    p = pool(CELL)
    x, u = reference_episodes(cfg, p, [0, 2, 1, 2])
    flat = p.reshape(-1, *p.shape[2:])
    law = make_mpc_regulator(model, plant, 4, "cpu")
    xp, up, _ = simulate_batch(model, plant, flat, 1.0, flat.shape[1], "cpu",
                               regulator=law, horizon=4)
    xp = xp.reshape(*p.shape[:2], *xp.shape[1:])[[0, 2, 1, 2]]
    up = up.reshape(*p.shape[:2], *up.shape[1:])[[0, 2, 1, 2]]
    assert np.max(np.abs(x - xp) / cfg["plant"]["xs"]) < 1e-14
    assert np.max(np.abs(u - up) / cfg["plant"]["us"]) < 1e-14
    # the law alone, on the same inputs
    sys = System.from_config(cfg)
    rng = np.random.default_rng(0)
    xhat, uhat, xr, ur = (rng.normal(0, 0.1, (5, n)) for n in (3, 2, 3, 2))
    want, _ = law(None, *(torch.from_numpy(v) for v in (xhat, uhat, xr, ur)))
    mpc = spec.law(cfg["regulator"]["form"]).law(sys, cfg)
    np.testing.assert_allclose(mpc(xhat, uhat, xr, ur), want.numpy(),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("shape", [(4, 1 << 13), (5, 1 << 13),
                                   (2, 4, 1 << 13), (256, 4, 5, 1 << 13),
                                   (256, 2, 2, 1 << 13), (11, 24, 1 << 15)])
def test_frozen_ntt_bound_equals_the_ports(shape):
    from hectr_tpu_torch.bench import ntt_bound

    rows = int(np.prod(shape[:-1]))
    ms, _ = ntt_bound(rows, shape[-2], shape[-1].bit_length() - 1,
                      yardstick.LAZY_MULT_PER_S)
    assert yardstick.ntt_least_s(shape) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_frozen_peak_is_the_data_sheets():
    assert yardstick.LAZY_MULT_PER_S == pytest.approx(132 * 64 * 1.98e9 / 3)
