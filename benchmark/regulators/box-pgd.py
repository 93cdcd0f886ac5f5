"""The box-pgd regulator form: the upstream's MPC with its box on the
moves, the box QP solved over ciphertext by a fixed number of
projected-gradient iterations (``hempc.qp_enc``), as the port's
``hempc.make_hempc_regulator`` builds it with bounds and a
relinearisation key: the gemv pair, then per iteration an eta H gemv and
a polynomial clip of ct x ct multiplies, each relinearised.

    "regulator": {"form": "box-pgd", "horizon": H, "dumin": [...],
                  "dumax": [...], "iterations": T, "clip_degree": 3 | 7,
                  "input_bound": B0}

The relinearisation key is made on the device from the form's own random
stream ("relin"), in the layout of the harness's rotation keys (with
their Shoup companions).
"""

from __future__ import annotations

import numpy as np

from benchmark import spec


def build(config, ctx, keys, rot_keys, model, plant, sampler, device):
    from hectr_tpu_torch import hempc
    from hectr_tpu_torch.ckks.keyswitch import gen_relin_key
    from hectr_tpu_torch.control.mpc import MPCBounds

    horizon, dumin, dumax, iters, degree, bound = spec.settings(
        config["regulator"], "horizon", "dumin", "dumax", "iterations",
        "clip_degree", "input_bound")
    bounds = MPCBounds(dumin=np.asarray(dumin, dtype=np.float64),
                       dumax=np.asarray(dumax, dtype=np.float64))
    relin = gen_relin_key(ctx, keys, sampler("relin"))
    return hempc.make_hempc_regulator(
        ctx, keys, rot_keys, model, plant, horizon, bounds=bounds,
        relin_key=relin, qp_iters=iters, qp_degree=degree,
        qp_input_bound=float(bound))
