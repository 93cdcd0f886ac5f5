"""The fused regulator form (``hempc.fused``): the four inputs packed
into one ciphertext a step, one hoisted BSGS gemv of the packed matrix,
one decrypt; the reference-shaped form's depth, scales and canary.

    "regulator": {"form": "fused", "horizon": H}

A form added as files alone: the tests point the harness's lookups at a
copy of the form directories with this file and its law added.
"""

from __future__ import annotations

from benchmark import spec


def build(config, ctx, keys, rot_keys, model, plant, sampler, device):
    from hectr_tpu_torch.hempc import fused

    (horizon,) = spec.settings(config["regulator"], "horizon")
    mats = fused.make_fused_materials(ctx, rot_keys, model, plant, horizon,
                                      device)
    return fused.make_fused_regulator(ctx, keys, model, plant, horizon, mats)
