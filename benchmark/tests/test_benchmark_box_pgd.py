"""The box-pgd form at CPU size: the reference's law against the port's
plaintext pieces (clip fits, step, mirror regulator), the port's
encrypted regulator against the law, the form's refusals, the box check,
and the law in float32."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import correct, program, spec
from benchmark.reference.loop import System

CELL = "flagship-qp-loop"
SEED = 2**31 + 4343
CPU = torch.device("cpu")


def config():
    return spec.cell(CELL).config


@pytest.fixture(scope="module")
def law():
    return spec.law("box-pgd")


def states(n=16, seed=0):
    """n random (xhat, uhat, xr, ur) about the steady state, in deviation
    units, wide enough that the box binds on some."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, s, (n, len(s))) for s in
                 (np.array([0.02, 2.0, 0.02]), np.array([1.0, 0.005]),
                  np.array([0.01, 1.0, 0.01]), np.array([0.5, 0.002])))


def test_clip_fit_equals_the_ports(law):
    """On every quantized domain of B0 = 12 (the first clip's and the
    iterations'), the law's own Lawson fit equals the port's
    ``qp_enc.clip_poly_coeffs`` to 1e-12 in units of the domain (the
    coefficient of w^e times domain^e)."""
    from hectr_tpu_torch.hempc import qp_enc

    cfg = config()
    mid, hw = law.box(cfg)
    eta, first, then = law.pgd_setup(law.hessian(System.from_config(cfg),
                                                 cfg), hw, 12.0)
    domains = sorted(set(law.quantized(np.concatenate([first, then]))))
    assert domains[0] == 1.5 and domains[-1] == 12.0 and len(domains) >= 3
    for d in domains:
        ours = np.array(law.clip_fit(float(d), 7))
        port = np.array(qp_enc.clip_poly_coeffs(float(d), 7))
        scale = float(d) ** np.arange(1, 8, 2)
        assert np.max(np.abs(ours - port) * scale) <= 1e-12, d


def test_step_and_domains_equal_the_ports(law):
    from hectr_tpu_torch.hempc import qp_enc

    cfg = config()
    mid, hw = law.box(cfg)
    H = law.hessian(System.from_config(cfg), cfg)
    eta, first, then = law.pgd_setup(H, hw, 12.0)
    assert eta == qp_enc.pgd_eta(H, mid - hw, mid + hw, 12.0)
    B0, B_it = qp_enc.pgd_domains(H, mid - hw, mid + hw, eta, 12.0)
    np.testing.assert_array_equal(first, B0)
    np.testing.assert_array_equal(then, B_it)


def test_law_equals_the_ports_mirror(law):
    """The law against ``qp_enc.make_pgd_mirror_regulator`` (the port's
    float64 mirror, in du units where the law works in half widths) on
    seeded random states, many of them on the box: equal to rounding."""
    from hectr_tpu_torch.control.mpc import MPCBounds
    from hectr_tpu_torch.hempc.qp_enc import make_pgd_mirror_regulator

    cfg = config()
    rc = cfg["regulator"]
    model, plant = program.plant_and_model(cfg)
    mirror = make_pgd_mirror_regulator(
        model, plant, rc["horizon"], MPCBounds(
            dumin=np.array(rc["dumin"]), dumax=np.array(rc["dumax"])),
        CPU, iters=rc["iterations"], degree=rc["clip_degree"],
        input_bound=rc["input_bound"])
    move = law.law(System.from_config(cfg), cfg)
    xhat, uhat, xr, ur = states()
    want, _ = mirror(None, *(torch.from_numpy(v) for v in (xhat, uhat, xr,
                                                             ur)))
    got = move(xhat, uhat, xr, ur)
    us = np.asarray(cfg["plant"]["us"])
    assert np.max(np.abs(got - want.numpy()) / us) < 1e-13
    hw = np.asarray(rc["dumax"])
    active = np.abs(got - uhat) > 0.8 * hw
    assert active.any() and not active.all()


def test_encrypted_regulator_against_the_law(law, monkeypatch):
    """The port's box-pgd regulator, built by the form's file as the
    harness builds it, at logN = 8 (the configuration's chain of 32 + 2
    primes, keys and QP), on the same random states: every move within
    1e-10 of |us| of the law's.  The bar is CKKS noise: at Delta = 2^50
    the loops' gap reads ~4e-12 at this ring."""
    from hectr_tpu_torch.hempc import hempc_init_state
    from hectr_tpu_torch.ckks.scheme import TorchSampler

    monkeypatch.setattr(program, "check_security", lambda ctx, config: None)
    cfg = config()
    cfg["ckks"]["logn"] = 8
    deployment = program.Deployment(cfg, SEED, np.zeros((1, 1, 4, 1)), CPU)
    xhat, uhat, xr, ur = states(4, seed=1)
    u, (_, canary) = deployment.regulator(
        hempc_init_state(TorchSampler(3, CPU), CPU, (4,)),
        *(torch.from_numpy(v) for v in (xhat, uhat, xr, ur)))
    want = law.law(System.from_config(cfg), cfg)(xhat, uhat, xr, ur)
    us = np.asarray(cfg["plant"]["us"])
    assert np.max(np.abs(u.numpy() - want) / us) < 1e-10
    assert float(canary.max()) < 1e-8


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_build_refuses_a_missing_or_an_extra_key(change):
    cfg = config()
    if change == "missing":
        del cfg["regulator"]["input_bound"]
    else:
        cfg["regulator"]["du_weight"] = 1.0
    form = spec.regulator("box-pgd")
    with pytest.raises(ValueError, match="regulator form 'box-pgd'"):
        form.build(cfg, None, None, None, None, None, None, CPU)


def test_a_move_outside_the_box_fails(law):
    """The reference's own loops pass the box check; the same loops with
    one move of F pushed 1% of a half width past dumax (the later moves
    kept) fail at that loop-step alone, by du_box_excess."""
    from benchmark import traffic as T
    from benchmark.reference.loop import reference_episodes

    cfg = config()
    traffic = dict(spec.cell(CELL).traffic, pool_episodes=2)
    pool = T.pool(traffic, T.seeds(SEED)["traffic"])
    x, u = reference_episodes(cfg, pool, [0, 1])
    canary = np.zeros(x.shape[:2])
    checks, failed, _ = correct.compare(cfg, x, u, canary, x, u)
    assert failed == 0 and checks["du_box_excess"]["value"] == 0.0
    bad, k = u.copy(), 5
    bad[1, 0, k:, 1] += 1.01 * cfg["regulator"]["dumax"][1] - (
        u[1, 0, k, 1] - u[1, 0, k - 1, 1])
    checks, failed, _ = correct.compare(cfg, x, bad, canary, x, bad)
    assert checks["du_box_excess"]["value"] == pytest.approx(0.01, rel=1e-6)
    assert failed == 1 and not correct.passed(checks, failed)


def test_the_float32_control_runs_the_pgd_in_float32(law):
    """The law given a float32 system computes in float32: its moves off
    the float64 law's by far more than float64 rounding.  The control
    (``control.py``: the reference in float32 in the port's place) at a
    small size, three 8-step episodes, is not correct, its gaps beyond 3x
    their limits."""
    import control

    cfg = config()
    system = System.from_config(cfg)
    xs = states()
    u64 = law.law(system, cfg)(*xs)
    u32 = law.law(system.astype(np.float32), cfg)(
        *(v.astype(np.float32) for v in xs))
    assert u32.dtype == np.float32
    us = np.asarray(cfg["plant"]["us"])
    assert np.max(np.abs(u32.astype(np.float64) - u64) / us) > 1e-9
    cell = spec.cell(CELL)
    cell.traffic["episode_steps"] = 8
    rec = control.control(cell, SEED, episodes=3)
    assert not rec["correct"] and rec["failed"] > 0
    lim = correct.limits(cfg)
    for name in ("u_rel_gap", "x_rel_gap"):
        assert rec["checks"][name]["value"] > 3 * lim[name], rec["checks"]
