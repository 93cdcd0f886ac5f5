"""The system under test: hectr_tpu_torch's encrypted closed loop, built
from a configuration file through the port's own entry points.

Set-up as ``cli.run_cstr_hempc`` builds it: the linearised CSTR model and
the nonlinear plant, the CKKS context of the configuration's ring, the
secret and public keys and the BSGS rotation keys generated on the card
from the run's seeds, and the regulator of the configuration's form,
which ``regulators/<form>.py`` builds.  An episode is one call of
``control.simulate.simulate`` (one plant) or ``simulate_batch`` (B plants).

This module and the form files ``regulators/*.py`` are the benchmark's
only modules that import the port.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import spec, yardstick
from benchmark import traffic as T


def plant_and_model(config: dict):
    """(LinearModel, Plant) of the configuration, through the port's CSTR;
    raises where the port's plant constants are not the configuration's."""
    from hectr_tpu_torch.control.plants import cstr
    from hectr_tpu_torch.control.simulate import LinearModel, Plant

    pc, mc = config["plant"], config["model"]
    for key, want in pc["constants"].items():
        if getattr(cstr, key) != want:
            raise ValueError(f"the port's CSTR has {key} = {getattr(cstr, key)}"
                             f", the configuration states {want}")
    xs, us, ps = (np.asarray(pc[k], dtype=np.float64) for k in ("xs", "us", "ps"))
    A, B, _ = cstr.cstr_linearize(xs, us, ps, float(pc["dt"]))
    model = LinearModel(A=A, B=B, **{k: np.asarray(mc[k], dtype=np.float64)
                                     for k in ("C", "Bd", "Cd", "Hr")})
    plant = Plant(ode=cstr.cstr_ode, jacobian=cstr.cstr_jacobian,
                  xs=xs, us=us, ps=ps)
    return model, plant


def check_security(ctx, config: dict) -> None:
    """The ring's log2(QP) within the HE standard's ceiling for the
    configuration's security level."""
    bits = config["guarantees"]["security_bits"]
    qp = 1
    for p in ctx.data_primes + ctx.special_primes:
        qp *= p
    ceiling = yardstick.HE_STANDARD_MAX_LOGQP[bits][ctx.n.bit_length() - 1]
    if qp.bit_length() > ceiling:
        raise ValueError(f"log2(QP) = {qp.bit_length()} > {ceiling}: the ring "
                         f"is below {bits}-bit security")


class Deployment:
    """The port's encrypted regulator and closed loop for one
    configuration, on `device`, from the run's seed.

    What every regulator form shares is built here; the form's file
    builds the regulator: ``build(config, ctx, keys, rot_keys, model,
    plant, sampler, device)`` returns the port's regulator closure, whose
    state is ``hempc.hempc_init_state``'s.  ``sampler(name)`` is a
    ``TorchSampler`` on `device` for a random stream the form names
    (``traffic.stream``)."""

    def __init__(self, config: dict, seed: int, pool: np.ndarray, device):
        from hectr_tpu_torch.ckks import scheme as S
        from hectr_tpu_torch.ckks.context import make_context
        from hectr_tpu_torch.ckks.gemv import bsgs_rotations
        from hectr_tpu_torch.ckks.keyswitch import gen_rotation_keys
        from hectr_tpu_torch.config import CKKSPreset

        self.config, self.device = config, device
        self.plants, self.steps = pool.shape[1], pool.shape[2]
        self.dt = float(config["plant"]["dt"])
        self.timings = {}
        clock = [time.perf_counter()]

        def lap(name):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            self.timings[name] = now - clock[0]
            clock[0] = now

        form = spec.regulator(config["regulator"]["form"])
        seeds = T.seeds(seed)
        self.model, self.plant = plant_and_model(config)
        ctx = make_context(CKKSPreset(name=config["name"], **config["ckks"]))
        check_security(ctx, config)
        lap("context")
        keys = S.keygen(ctx, S.TorchSampler(seeds["keygen"], device), device)
        rot_keys = gen_rotation_keys(ctx, keys, S.TorchSampler(
            seeds["rotations"], device), bsgs_rotations(ctx.slots))
        lap("keys")
        self.regulator = form.build(
            config, ctx, keys, rot_keys, self.model, self.plant,
            lambda name: S.TorchSampler(T.stream(seed, name), device), device)
        self.sampler = S.TorchSampler(seeds["encryption"], device)
        lap("regulator")

    def episode(self, p: np.ndarray, regulator):
        """One episode of every plant through `regulator` (the port's, as
        the harness wraps it), disturbances p [plants, N, 1]: (x [plants,
        N+1, nx], u [plants, N, nu]) in absolute units on the host, and
        the imaginary-residue canary of each plant on the device."""
        from hectr_tpu_torch import hempc
        from hectr_tpu_torch.control.simulate import simulate, simulate_batch

        if self.plants == 1:
            state = hempc.hempc_init_state(self.sampler, self.device)
            x, u, (_, canary) = simulate(
                self.model, self.plant, p[0], self.dt, self.steps, self.device,
                regulator=regulator, regulator_state=state, return_state=True)
            return x[None], u[None], canary.reshape(1)
        state = hempc.hempc_init_state(self.sampler, self.device, (self.plants,))
        x, u, (_, canary) = simulate_batch(
            self.model, self.plant, p, self.dt, self.steps, self.device,
            regulator=regulator, regulator_state=state)
        return x, u, canary


def reset_ntt_launches() -> None:
    """Zero the port's K1/K2 launch counters."""
    from hectr_tpu_torch.ops import ntt_cuda

    ntt_cuda.reset_launches()


def ntt_launch_shapes() -> dict:
    """The port's K1/K2 launches since the last reset, by (name, shape)."""
    from hectr_tpu_torch.ops import ntt_cuda

    return dict(ntt_cuda.LAUNCH_SHAPES)
