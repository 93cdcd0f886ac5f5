"""The reference-shaped regulator form: the upstream's unconstrained
encrypted MPC (src/hempc.c:216-266) as the port's
``hempc.make_hempc_regulator`` builds it without bounds: four ciphertexts
in, two hoisted BSGS gemvs, a rescale pair and a mod-down.

    "regulator": {"form": "reference-shaped", "horizon": H}
"""

from __future__ import annotations

from benchmark import spec


def build(config, ctx, keys, rot_keys, model, plant, sampler, device):
    from hectr_tpu_torch import hempc

    (horizon,) = spec.settings(config["regulator"], "horizon")
    return hempc.make_hempc_regulator(ctx, keys, rot_keys, model, plant,
                                      horizon)
